"""Wrappers for paged decode attention: reshape GQA heads, derive the
per-lane page bounds from the query position, and run the shared-prefix
cascade (the counterpart of ``repro.kernels.paged_attention.ops``).

Dispatch is by the tensor's device alone: a CPU tensor runs the plain
PyTorch versions (``ref.py``), a CUDA tensor launches the CUDA kernels or
raises. ``paged_attention.launches`` (K1) and ``shared_prefix.launches``
(K2) count kernel launches (never plain runs), so a run can show that its
decode went through the kernels."""

from __future__ import annotations

from typing import Optional

import torch

from ..guard import refuse_grad
from .kernel import paged_attention_cuda, shared_prefix_cuda
from .ref import Stats, paged_attention_ref, shared_prefix_ref


def shared_prefix(
    q: torch.Tensor,             # (B, KV, G, Dh) — rope'd queries, per KV head
    pool_k: torch.Tensor,        # (P, page_size, KV, Dh)
    pool_v: torch.Tensor,
    shared_pages: torch.Tensor,  # (S,) page ids every lane's table starts with
    q_pos: torch.Tensor,         # (B,) int32
    *,
    window: int = 0,
    softcap: float = 0.0,
) -> Stats:
    """The cascade's shared pass (K2): every lane's partial softmax state
    ``(acc, m, l)`` over the run, f32."""
    if q.device.type == "cpu":
        return shared_prefix_ref(
            q, pool_k, pool_v, shared_pages, q_pos, window=window, softcap=softcap,
        )
    if q.device.type != "cuda":
        raise ValueError(f"shared_prefix: unsupported device {q.device}")
    refuse_grad("shared_prefix", q, pool_k, pool_v)
    out = shared_prefix_cuda(
        q.contiguous(), pool_k, pool_v, shared_pages.to(torch.int32).contiguous(),
        q_pos.to(torch.int32).contiguous(), window=window, softcap=softcap,
    )
    shared_prefix.launches += 1
    return out


shared_prefix.launches = 0


def paged_attention(
    q: torch.Tensor,           # (B, 1, H, Dh) — rope'd query token
    pool_k: torch.Tensor,      # (P, page_size, KV, Dh) — shared pool, one layer
    pool_v: torch.Tensor,
    page_table: torch.Tensor,  # (B, MP) physical page ids per lane
    q_pos: torch.Tensor,       # (B, 1) absolute position of the query token
    kv_pos: torch.Tensor,      # (B, MP*page_size) absolute positions per slot
    shared_pages: Optional[torch.Tensor] = None,  # (S,) common leading pages
    *,
    window: int = 0,
    softcap: float = 0.0,
) -> torch.Tensor:
    """q vs a paged KV pool -> (B, 1, H, Dh), attending through the table.

    The per-lane page bound ``ceil((q_pos + 1) / page_size)`` relies on the
    layout invariant of the paged pool (slot index == absolute position for
    valid slots), under which no key beyond the query's own page can pass
    the causal mask.

    ``shared_pages`` enables the cross-session cascade: the caller asserts
    that pages ``[0, S)`` of EVERY lane's table are exactly
    ``shared_pages`` (full, resident pages holding positions
    ``[0, S*page_size)``). K2 attends the first ``start = min(S, MP - 1)``
    of them once per KV head for the whole batch, and K1 walks each lane's
    pages ``[start, bound)`` seeded with K2's stats — the exact
    continuation of the single-pass softmax (the suffix pass keeps at
    least one page per lane: a lane's own tail page is never shared)."""
    b, _, h, dh = q.shape
    ps, kvh = pool_k.shape[1], pool_k.shape[2]
    mp = page_table.shape[1]
    qr = q.reshape(b, kvh, h // kvh, dh)
    qp = q_pos.reshape(b).to(torch.int32)
    start, init = 0, None
    if shared_pages is not None and shared_pages.shape[0] > 0:
        start = min(int(shared_pages.shape[0]), mp - 1)
        if start > 0:
            init = shared_prefix(
                qr, pool_k, pool_v, shared_pages[:start], qp,
                window=window, softcap=softcap,
            )
    if q.device.type == "cpu":
        return paged_attention_ref(
            q, pool_k, pool_v, page_table, q_pos, kv_pos,
            window=window, softcap=softcap, start=start, init=init,
        )
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    refuse_grad("paged_attention", q, pool_k, pool_v)
    bound = torch.clamp((qp + ps) // ps, 1, mp).to(torch.int32)  # ceil((qp+1)/ps)
    out = paged_attention_cuda(
        qr.contiguous(), pool_k, pool_v,
        page_table.to(torch.int32).contiguous(), bound, qp.contiguous(),
        kv_pos.to(torch.int32).contiguous(),
        window=window, softcap=softcap, start=start, init=init,
    )
    paged_attention.launches += 1
    return out.reshape(b, 1, h, dh)


paged_attention.launches = 0
