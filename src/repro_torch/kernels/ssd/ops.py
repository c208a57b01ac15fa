"""Wrapper for the full SSD (the counterpart of ``repro.kernels.ssd.ops``):
the intra-chunk kernel, then the inter-chunk state chain and the y_inter
term in PyTorch, as the JAX wrapper runs them in jnp after its kernel.

Dispatch is by the tensor's device alone: a CPU tensor runs the chunk
function's plain version (``ref.ssd_chunk_ref``), a CUDA tensor launches
the CUDA kernel (K6) or raises. ``ssd.launches`` counts kernel launches
(never plain runs). A sequence that is no multiple of the chunk raises, as
in JAX; it is never padded."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..guard import refuse_grad
from .kernel import ssd_chunk_cuda
from .ref import ssd_chunk_ref


def ssd(
    x: torch.Tensor,    # (B,L,H,P)
    dt: torch.Tensor,   # (B,L,H)
    A: torch.Tensor,    # (H,)
    Bv: torch.Tensor,   # (B,L,G,N)
    Cv: torch.Tensor,   # (B,L,G,N)
    chunk: int,
    h0: Optional[torch.Tensor] = None,   # (B,H,P,N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full SSD over B/C group 0: returns (y (B,L,H,P), final_state
    (B,H,P,N)), both in x's dtype."""
    b, l, h, p = x.shape
    n = Bv.shape[-1]
    if l % chunk:
        raise AssertionError((l, chunk))
    nc = l // chunk
    f32 = torch.float32
    args = (x.to(f32), dt.to(f32), A.to(f32), Bv[:, :, 0].to(f32), Cv[:, :, 0].to(f32))
    if x.device.type == "cpu":
        y_intra, states, dA_cs = ssd_chunk_ref(*args, chunk)
    elif x.device.type == "cuda":
        refuse_grad("ssd", x, dt, A, Bv, Cv, h0)
        y_intra, states, dA_cs = ssd_chunk_cuda(*(a.contiguous() for a in args), chunk)
        ssd.launches += 1
    else:
        raise ValueError(f"ssd: unsupported device {x.device}")

    # states: (B,NC,H,N,P), each chunk's own contribution; chain them
    dA_c = dA_cs.reshape(b, nc, chunk, h)
    chunk_decay = torch.exp(dA_c[:, :, -1, :])                      # (B,NC,H)
    carry = (
        h0.to(f32).transpose(-1, -2) if h0 is not None
        else torch.zeros((b, h, n, p), dtype=f32, device=x.device)
    )
    prev = []
    for c in range(nc):                                             # the state *before* chunk c
        prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                          # (B,NC,H,N,P)

    # inter-chunk contribution: C_i · h_prev · exp(dA_cs_i)
    Cc = args[4].reshape(b, nc, chunk, n)
    y_inter = torch.einsum("bcqn,bchnp,bcqh->bcqhp", Cc, prev_states, torch.exp(dA_c))
    y = y_intra.reshape(b, nc, chunk, h, p) + y_inter
    return y.reshape(b, l, h, p).to(x.dtype), carry.transpose(-1, -2).to(x.dtype)


ssd.launches = 0
