"""Plain PyTorch version of chunked paged prefill attention (the
counterpart of ``repro.kernels.chunked_prefill.ref``): linearize the page
table and take the exact masked softmax of S chunk rows against it, in f32.

Validity comes from the layout invariant rather than a kv_pos input (slot
index == absolute position, written contiguously): slot ``t`` holds real
K/V exactly when ``t < p0 + true_len``. Padded chunk rows
(``r >= true_len``) return exact zeros here — the CUDA kernel leaves
garbage in them instead; both are fine because those rows are never read.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def chunked_prefill_ref(
    q: torch.Tensor,           # (B, S, H, Dh) — rope'd chunk queries
    pool_k: torch.Tensor,      # (P, page_size, KV, Dh) — post-scatter pool
    pool_v: torch.Tensor,
    page_table: torch.Tensor,  # (B, MP) physical page ids per lane
    p0: torch.Tensor,          # (B,) absolute position of chunk row 0
    true_len: torch.Tensor,    # (B,) real chunk lengths (bucketed input)
    *,
    window: int = 0,
    softcap: float = 0.0,
) -> torch.Tensor:
    b, s, h, dh = q.shape
    kvh = pool_k.shape[2]
    g = h // kvh
    tbl = page_table.long()
    k = pool_k[tbl].reshape(b, -1, kvh, dh).float()   # (B, MP*ps, KV, Dh)
    v = pool_v[tbl].reshape(b, -1, kvh, dh).float()
    t = k.shape[1]
    qq = q.reshape(b, s, kvh, g, dh).float()
    scale = 1.0 / (dh ** 0.5)
    logits = torch.einsum("bskgd,btkd->bkgst", qq, k) * scale
    if softcap > 0.0:
        logits = softcap * torch.tanh(logits / softcap)
    dev = q.device
    q_pos = p0.reshape(b, 1) + torch.arange(s, dtype=torch.int32, device=dev)[None, :]
    kv_slot = torch.arange(t, dtype=torch.int32, device=dev)[None, :]      # (1, T)
    valid = kv_slot < (p0 + true_len).reshape(b, 1)                       # (B, T)
    mask = valid[:, None, :] & (kv_slot[:, None, :] <= q_pos[:, :, None])
    if window > 0:
        mask = mask & (q_pos[:, :, None] - kv_slot[:, None, :] < window)
    mask = mask[:, None, None, :, :]                                      # (B,1,1,S,T)
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m) * mask.float()
    l = p.sum(dim=-1, keepdim=True)
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    out = torch.einsum("bkgst,btkd->bskgd", p / l, v)
    return out.reshape(b, s, h, dh).to(q.dtype)
