"""Plain PyTorch version of position-masked flash attention (the
counterpart of ``repro.kernels.flash_attention.ref``): the exact masked
softmax of S query rows against T keys, in f32, with no blocking.

A row with no unmasked key gives the mean of V here, as in the JAX oracle
(every logit is ``NEG_INF``, so every weight is exp(0)); the CUDA kernel
writes zeros there. No caller reads such a row."""

from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_attention_ref(
    q: torch.Tensor,         # (B, S, H, Dh)
    k: torch.Tensor,         # (B, T, KV, Dh)
    v: torch.Tensor,
    q_pos: torch.Tensor,     # (B, S)
    kv_pos: torch.Tensor,    # (B, T)
    kv_valid: torch.Tensor,  # (B, T) bool or int
    *,
    window: int = 0,
    softcap: float = 0.0,
) -> torch.Tensor:
    b, s, h, dh = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qq = q.reshape(b, s, kvh, g, dh).float()
    scale = 1.0 / (dh ** 0.5)
    logits = torch.einsum("bskgd,btkd->bkgst", qq, k.float()) * scale
    if softcap > 0.0:
        logits = softcap * torch.tanh(logits / softcap)
    mask = (kv_pos[:, None, :] <= q_pos[:, :, None]) & (kv_valid[:, None, :] != 0)
    if window > 0:
        mask = mask & (q_pos[:, :, None] - kv_pos[:, None, :] < window)
    logits = torch.where(mask[:, None, None], logits, torch.full_like(logits, NEG_INF))
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True)
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    out = torch.einsum("bkgst,btkd->bskgd", p / l, v.float())
    return out.reshape(b, s, h, dh).to(q.dtype)
