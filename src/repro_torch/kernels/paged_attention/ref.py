"""Plain PyTorch version of paged decode attention (the counterpart of
``repro.kernels.paged_attention.ref``): linearize the page table and take
the exact masked softmax of one query position against it, in f32.

The CPU tests hold it to the JAX package; ``chip_smoke.py`` holds the CUDA
kernel to it on the card. Matches the kernel's empty-lane convention: a lane
with no valid key slot (all ``kv_pos < 0`` or ``> q_pos``) returns exact
zeros."""

from __future__ import annotations

import torch

NEG_INF = -1e30


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
) -> torch.Tensor:
    b, _, h, dh = q.shape
    kvh = pool_k.shape[2]
    g = h // kvh
    tbl = page_table.long()
    k = pool_k[tbl].reshape(b, -1, kvh, dh).float()   # (B, MP*ps, KV, Dh)
    v = pool_v[tbl].reshape(b, -1, kvh, dh).float()
    qq = q.reshape(b, kvh, g, dh).float()
    scale = 1.0 / (dh ** 0.5)
    logits = torch.einsum("bkgd,btkd->bkgt", qq, k) * scale
    if softcap > 0.0:
        logits = softcap * torch.tanh(logits / softcap)
    qp = q_pos.reshape(b, 1)
    mask = (kv_pos >= 0) & (kv_pos <= qp)
    if window > 0:
        mask = mask & (qp - kv_pos < window)
    mask = mask[:, None, None, :]
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m) * mask.float()
    l = p.sum(dim=-1, keepdim=True)
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    out = torch.einsum("bkgt,btkd->bkgd", p / l, v)
    return out.reshape(b, 1, h, dh).to(q.dtype)
