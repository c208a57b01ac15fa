"""Plain PyTorch version of flash decode (the counterpart of
``repro.kernels.decode_attention.ref``): the exact masked softmax of one
query position against the whole cache — flash attention with S = 1."""

from __future__ import annotations

import torch

from ..flash_attention.ref import flash_attention_ref


def decode_attention_ref(
    q: torch.Tensor,         # (B, 1, H, Dh)
    k: torch.Tensor,         # (B, T, KV, Dh)
    v: torch.Tensor,
    q_pos: torch.Tensor,     # (B, 1)
    kv_pos: torch.Tensor,    # (B, T)
    kv_valid: torch.Tensor,  # (B, T)
    *,
    window: int = 0,
    softcap: float = 0.0,
) -> torch.Tensor:
    return flash_attention_ref(
        q, k, v, q_pos, kv_pos, kv_valid, window=window, softcap=softcap
    )
