"""Wrapper for flash decode: one query token per lane against a linear KV
cache, with the GQA reshape (the counterpart of
``repro.kernels.decode_attention.ops``).

Dispatch is by the tensor's device alone: a CPU tensor runs the plain
PyTorch version (``ref.py``), a CUDA tensor launches the CUDA kernel (K5)
or raises. ``decode_attention.launches`` counts kernel launches (never
plain runs). No padding of the cache length is needed: the kernel masks the
ragged last tile itself."""

from __future__ import annotations

import torch

from ..guard import refuse_grad
from .kernel import decode_attention_cuda
from .ref import decode_attention_ref


def decode_attention(
    q: torch.Tensor,         # (B, 1, H, Dh) — rope'd query token
    k: torch.Tensor,         # (B, T, KV, Dh)
    v: torch.Tensor,
    q_pos: torch.Tensor,     # (B, 1)
    kv_pos: torch.Tensor,    # (B, T)
    kv_valid: torch.Tensor,  # (B, T)
    *,
    window: int = 0,
    softcap: float = 0.0,
) -> torch.Tensor:
    """q (B,1,H,Dh) vs cache (B,T,KV,Dh) -> (B,1,H,Dh)."""
    if q.device.type == "cpu":
        return decode_attention_ref(
            q, k, v, q_pos, kv_pos, kv_valid, window=window, softcap=softcap,
        )
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    refuse_grad("decode_attention", q, k, v)
    b, _, h, dh = q.shape
    kvh = k.shape[2]
    # the G query heads of one KV head share each K/V row as one block
    qr = q.reshape(b, kvh, h // kvh, dh).contiguous()
    i32 = lambda x: x.to(torch.int32).contiguous()  # noqa: E731
    out = decode_attention_cuda(
        qr, k.contiguous(), v.contiguous(), i32(q_pos.reshape(b)), i32(kv_pos),
        i32(kv_valid), window=window, softcap=softcap,
    )
    decode_attention.launches += 1
    return out.reshape(b, 1, h, dh)


decode_attention.launches = 0
