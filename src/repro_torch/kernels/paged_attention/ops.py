"""Wrapper for paged decode attention: reshapes GQA heads and derives the
per-lane page bounds from the query position (the counterpart of
``repro.kernels.paged_attention.ops.paged_attention``).

Dispatch is by the tensor's device alone: a CPU tensor runs the plain
PyTorch version (``ref.py``), a CUDA tensor launches the CUDA kernel or
raises. ``paged_attention.launches`` counts kernel launches (never plain
runs), so a run can show that its decode went through the kernel."""

from __future__ import annotations

import torch

from .kernel import paged_attention_cuda
from .ref import paged_attention_ref


def paged_attention(
    q: torch.Tensor,           # (B, 1, H, Dh) — rope'd query token
    pool_k: torch.Tensor,      # (P, page_size, KV, Dh) — shared pool, one layer
    pool_v: torch.Tensor,
    page_table: torch.Tensor,  # (B, MP) physical page ids per lane
    q_pos: torch.Tensor,       # (B, 1) absolute position of the query token
    kv_pos: torch.Tensor,      # (B, MP*page_size) absolute positions per slot
    *,
    window: int = 0,
    softcap: float = 0.0,
) -> torch.Tensor:
    """q vs a paged KV pool -> (B, 1, H, Dh), attending through the table.

    The per-lane page bound ``ceil((q_pos + 1) / page_size)`` relies on the
    layout invariant of the paged pool (slot index == absolute position for
    valid slots), under which no key beyond the query's own page can pass
    the causal mask. The JAX wrapper's ``shared_pages`` cascade and
    ``max_pages`` trim belong to the batched server (next slice)."""
    if q.device.type == "cpu":
        return paged_attention_ref(
            q, pool_k, pool_v, page_table, q_pos, kv_pos,
            window=window, softcap=softcap,
        )
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    b, _, h, dh = q.shape
    ps, kvh = pool_k.shape[1], pool_k.shape[2]
    mp = page_table.shape[1]
    qp = q_pos.reshape(b).to(torch.int32)
    bound = torch.clamp((qp + ps) // ps, 1, mp).to(torch.int32)  # ceil((qp+1)/ps)
    out = paged_attention_cuda(
        q.reshape(b, kvh, h // kvh, dh).contiguous(), pool_k, pool_v,
        page_table.to(torch.int32).contiguous(), bound, qp.contiguous(),
        kv_pos.to(torch.int32).contiguous(),
        window=window, softcap=softcap,
    )
    paged_attention.launches += 1
    return out.reshape(b, 1, h, dh)


paged_attention.launches = 0
