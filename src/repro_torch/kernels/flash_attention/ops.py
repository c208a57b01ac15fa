"""Wrapper for position-masked flash attention (the counterpart of
``repro.kernels.flash_attention.ops``): full-sequence prefill and chunk
appends into a full-width cache.

Dispatch is by the tensor's device alone: a CPU tensor runs the plain
PyTorch version (``ref.py``), a CUDA tensor launches the CUDA kernel (K4)
or raises. On the card the dtype picks the kernel: bf16 the tensor-core
one, f32 the f32 FMA one (``kernel.py``). ``flash_attention.launches`` counts kernel launches (never plain
runs). No block padding is needed: the kernel masks ragged edges itself."""

from __future__ import annotations

import torch

from ..guard import refuse_grad
from .kernel import flash_attention_cuda
from .ref import flash_attention_ref


def flash_attention(
    q: torch.Tensor,         # (B, S, H, Dh) — rope'd queries
    k: torch.Tensor,         # (B, T, KV, Dh)
    v: torch.Tensor,
    q_pos: torch.Tensor,     # (B, S) absolute query positions
    kv_pos: torch.Tensor,    # (B, T) absolute key positions
    kv_valid: torch.Tensor,  # (B, T) bool or int
    *,
    window: int = 0,
    softcap: float = 0.0,
) -> torch.Tensor:
    """(B,S,H,Dh) x (B,T,KV,Dh) -> (B,S,H,Dh), causal on positions, window
    masked. Rows with no unmasked key differ between the two versions (mean
    of V vs zeros) and are never read."""
    if q.device.type == "cpu":
        return flash_attention_ref(
            q, k, v, q_pos, kv_pos, kv_valid, window=window, softcap=softcap,
        )
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    refuse_grad("flash_attention", q, k, v)
    i32 = lambda x: x.to(torch.int32).contiguous()  # noqa: E731
    out = flash_attention_cuda(
        q.contiguous(), k.contiguous(), v.contiguous(), i32(q_pos), i32(kv_pos),
        i32(kv_valid), window=window, softcap=softcap,
    )
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
