"""Wrapper for chunked paged prefill attention: reshapes GQA heads and
derives per-lane page bounds from the chunk's end position (the
counterpart of ``repro.kernels.chunked_prefill.ops``).

Dispatch is by the tensor's device alone: a CPU tensor runs the plain
PyTorch version (``ref.py``), a CUDA tensor launches the CUDA kernel or
raises. ``chunked_prefill_attention.launches`` counts kernel launches."""

from __future__ import annotations

import torch

from .kernel import chunked_prefill_cuda
from .ref import chunked_prefill_ref


def chunked_prefill_attention(
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
    """S chunk queries vs a paged KV pool -> (B, S, H, Dh), attending
    through the page table. The caller has already scattered the chunk's
    K/V into the pool (``paged_write_chunk``), so the pool holds the lane's
    full causal prefix [0, p0 + true_len). The per-lane page bound
    ``ceil((p0 + true_len) / page_size)`` relies on the layout invariant
    (slot index == absolute position for valid slots). Rows at or past
    ``true_len`` are garbage on the kernel path (zeros on the plain path)
    and are never read."""
    if q.device.type == "cpu":
        return chunked_prefill_ref(
            q, pool_k, pool_v, page_table, p0, true_len,
            window=window, softcap=softcap,
        )
    if q.device.type != "cuda":
        raise ValueError(f"chunked_prefill_attention: unsupported device {q.device}")
    b, s, h, dh = q.shape
    ps, kvh = pool_k.shape[1], pool_k.shape[2]
    g = h // kvh
    mp = page_table.shape[1]
    p0 = p0.reshape(b).to(torch.int32)
    end = p0 + torch.clamp(true_len.reshape(b).to(torch.int32), min=1)
    bound = torch.clamp((end + ps - 1) // ps, 1, mp).to(torch.int32)
    # (B, S, KV, G, Dh) -> (B, KV, S*G, Dh): chunk rows and query heads of
    # one KV head share each key tile as one query block
    qr = q.reshape(b, s, kvh, g, dh).permute(0, 2, 1, 3, 4).reshape(b, kvh, s * g, dh)
    out = chunked_prefill_cuda(
        qr.contiguous(), pool_k, pool_v, page_table.to(torch.int32).contiguous(),
        bound, p0.contiguous(), g=g, window=window, softcap=softcap,
    )
    chunked_prefill_attention.launches += 1
    return out.reshape(b, kvh, s, g, dh).permute(0, 2, 1, 3, 4).reshape(b, s, h, dh)


chunked_prefill_attention.launches = 0
