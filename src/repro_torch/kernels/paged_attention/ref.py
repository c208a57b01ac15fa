"""Plain PyTorch versions of paged decode attention (the counterpart of
``repro.kernels.paged_attention.ref``) and of its shared-prefix cascade
pass: linearize the page table and take the exact masked softmax of one
query position against it, in f32.

The CPU tests hold them to the JAX package; ``chip_smoke.py`` holds the
CUDA kernels to them on the card. They match the kernels' conventions: a
lane with no valid key slot (all ``kv_pos < 0`` or ``> q_pos``) returns
exact zeros, and a lane whose whole shared run is masked leaves the
cascade's stats at ``m = -1e30, l = 0, acc = 0`` (never ``-inf``).
``merge_stats`` is the merge by which the split walks of K2 and K5 combine
their blocks' partial states."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

NEG_INF = -1e30

Stats = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _logits(qq: torch.Tensor, k: torch.Tensor, softcap: float) -> torch.Tensor:
    """(B, KV, G, Dh) f32 queries vs (B or 1, T, KV, Dh) keys -> (B, KV, G, T)."""
    logits = torch.einsum("bkgd,btkd->bkgt", qq, k.float()) / (qq.shape[-1] ** 0.5)
    if softcap > 0.0:
        logits = softcap * torch.tanh(logits / softcap)
    return logits


def _stats(logits: torch.Tensor, mask: torch.Tensor, v: torch.Tensor) -> Stats:
    """Unnormalised softmax stats of masked logits (B, KV, G, T) against
    values (B or 1, T, KV, Dh): ``acc`` (B, KV, G, Dh), ``m`` and ``l``
    (B, KV, G, 1), all f32. Masked slots contribute p = 0; a fully masked
    row keeps m = NEG_INF."""
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m) * mask.float()
    acc = torch.einsum("bkgt,btkd->bkgd", p, v.float())
    return acc, m, p.sum(dim=-1, keepdim=True)


def merge_stats(parts: Sequence[Stats]) -> Stats:
    """The merge a split walk's thread-block cluster performs
    (``csrc/split_decode.cuh``), parts summed in the order given:
    ``m = max m_i``, ``l = sum l_i e^(m_i - m)``, ``acc = sum acc_i
    e^(m_i - m)``. An empty part (``m = -1e30, l = 0, acc = 0``) adds
    nothing, and parts that are all empty merge to the empty state."""
    m = parts[0][1]
    for _, mi, _ in parts[1:]:
        m = torch.maximum(m, mi)
    acc, l = torch.zeros_like(parts[0][0]), torch.zeros_like(parts[0][2])
    for ai, mi, li in parts:
        scale = torch.exp(mi - m)
        acc = acc + ai * scale
        l = l + li * scale
    return acc, m, l


def shared_prefix_ref(
    q: torch.Tensor,             # (B, KV, G, Dh) — rope'd queries, per KV head
    pool_k: torch.Tensor,        # (P, page_size, KV, Dh) — shared pool, one layer
    pool_v: torch.Tensor,
    shared_pages: torch.Tensor,  # (S,) physical page ids holding positions [0, S*ps)
    q_pos: torch.Tensor,         # (B,) absolute position of each lane's query
    *,
    window: int = 0,
    softcap: float = 0.0,
    span: Optional[Tuple[int, int]] = None,
) -> Stats:
    """What ``shared_prefix_pallas`` computes: every lane against the run
    of pages that every lane's table starts with. The run is full and
    resident by contract, so slot == position and the only mask is causal
    (``kp <= q_pos``) plus the window. Returns the unnormalised partial
    softmax state ``(acc, m, l)`` for the suffix pass to continue from.
    With ``span = (lo, hi)`` only run tokens in ``[lo, hi)`` are attended:
    the state of one split of the kernel's walk."""
    kvh, dh = pool_k.shape[2], pool_k.shape[3]
    pages = shared_pages.long()
    k = pool_k[pages].reshape(1, -1, kvh, dh)        # (1, S*ps, KV, Dh)
    v = pool_v[pages].reshape(1, -1, kvh, dh)
    logits = _logits(q.float(), k, softcap)
    kp = torch.arange(k.shape[1], device=q.device)[None, :]
    qp = q_pos.reshape(-1, 1).long()
    mask = kp <= qp
    if window > 0:
        mask = mask & (qp - kp < window)
    if span is not None:
        mask = mask & (kp >= span[0]) & (kp < span[1])
    return _stats(logits, mask[:, None, None, :], v)


def paged_attention_ref(
    q: torch.Tensor,           # (B, 1, H, Dh) — rope'd query
    pool_k: torch.Tensor,      # (P, page_size, KV, Dh) — shared pool, one layer
    pool_v: torch.Tensor,
    page_table: torch.Tensor,  # (B, MP) physical page ids per lane
    q_pos: torch.Tensor,       # (B, 1) absolute position of the query
    kv_pos: torch.Tensor,      # (B, MP*page_size), -1 = empty slot
    *,
    window: int = 0,
    softcap: float = 0.0,
    start: int = 0,
    init: Optional[Stats] = None,
) -> torch.Tensor:
    """Attention of each lane's query through its page table -> (B, 1, H, Dh)
    in q's dtype. With ``start``/``init`` this is the suffix pass of the
    cascade: only slots from page ``start`` on are attended, and their
    stats are merged into ``init`` — the shared pass's ``(acc, m, l)`` —
    exactly as the online softmax would continue them."""
    b, _, h, dh = q.shape
    kvh = pool_k.shape[2]
    ps = pool_k.shape[1]
    tbl = page_table.long()
    k = pool_k[tbl].reshape(b, -1, kvh, dh)   # (B, MP*ps, KV, Dh)
    v = pool_v[tbl].reshape(b, -1, kvh, dh)
    qq = q.reshape(b, kvh, h // kvh, dh).float()
    logits = _logits(qq, k, softcap)
    qp = q_pos.reshape(b, 1)
    mask = (kv_pos >= 0) & (kv_pos <= qp)
    if window > 0:
        mask = mask & (qp - kv_pos < window)
    if start > 0:
        slot = torch.arange(kv_pos.shape[1], device=q.device)[None, :]
        mask = mask & (slot >= start * ps)
    acc, m, l = _stats(logits, mask[:, None, None, :], v)
    if init is not None:
        acc0, m0, l0 = (t.float() for t in init)
        m_new = torch.maximum(m0, m)
        a0, a1 = torch.exp(m0 - m_new), torch.exp(m - m_new)
        acc = acc0 * a0 + acc * a1
        l = l0 * a0 + l * a1
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    return (acc / l).reshape(b, 1, h, dh).to(q.dtype)
