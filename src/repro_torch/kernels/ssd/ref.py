"""Plain PyTorch versions for the SSD kernel (the counterparts of
``repro.kernels.ssd.ref`` and of the TPU kernel's body):

- ``ssd_chunk_ref``  — what K6 computes, batched over every (lane, chunk,
  head): the same (y_intra, states, dA_cs) triple, in f32 but for the
  cumsum of dt·A, which K6 and this version take in f64 (the TPU kernel's
  f32 cumsum reaches |dA_cs| ~ 1e3 in a chunk at fast decays, and its
  rounding then dominates exp(dA_cs[i] - dA_cs[j])); each segment sum is
  rounded to f32 once;
- ``ssd_sequential`` — the O(L·N·P) token-by-token recurrence, the ground
  truth for the chunked versions;
- ``ssd_chunk_tf32`` — ``ssd_chunk_ref`` with K6's products emulated as
  the kernel takes them on the tensor cores: CB = C Bᵀ in f64 (the FP64
  tensor cores), rounded to f32 once; W x and the states with their
  operands rounded to TF32 (``tf32``: 10 mantissa bits, round to nearest),
  in split TF32 or in one pass. Only the tests use it, to show which
  scheme meets K6's bound.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def ssd_chunk_ref(
    x: torch.Tensor,    # (B, L, H, P) f32
    dt: torch.Tensor,   # (B, L, H)
    A: torch.Tensor,    # (H,)
    Bv: torch.Tensor,   # (B, L, N) (group 0)
    Cv: torch.Tensor,   # (B, L, N)
    chunk: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (y_intra (B,L,H,P), states (B,NC,H,N,P), dA_cs (B,L,H))."""
    b, l, h, p = x.shape
    n = Bv.shape[-1]
    if l % chunk:
        raise AssertionError((l, chunk))
    nc, q = l // chunk, chunk
    xc = x.reshape(b, nc, q, h, p)
    dtc = dt.reshape(b, nc, q, h)
    Bc = Bv.reshape(b, nc, q, n)
    Cc = Cv.reshape(b, nc, q, n)

    cs = torch.cumsum(dtc.double() * A.double(), dim=2)             # (b,nc,q,h) inclusive, f64
    seg = (cs[:, :, :, None, :] - cs[:, :, None, :, :]).float()     # (b,nc,i,j,h)
    causal = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    causal = causal[None, None, :, :, None]
    seg = torch.where(causal, seg, torch.zeros_like(seg))           # clamp before exp
    L = torch.where(causal, torch.exp(seg), torch.zeros_like(seg))

    cb = torch.einsum("bcin,bcjn->bcij", Cc, Bc)                    # (b,nc,q,q)
    w = cb[..., None] * L * dtc[:, :, None, :, :]                   # (b,nc,i,j,h)
    y = torch.einsum("bcijh,bcjhp->bcihp", w, xc)

    decay_end = torch.exp((cs[:, :, -1:, :] - cs).float())          # (b,nc,q,h)
    bw = Bc[:, :, :, None, :] * (decay_end * dtc)[..., None]        # (b,nc,q,h,n)
    states = torch.einsum("bcqhn,bcqhp->bchnp", bw, xc)
    return y.reshape(b, l, h, p), states, cs.float().reshape(b, l, h)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value (10 mantissa bits; ties away from zero,
    as ``cvt.rna.tf32.f32``), by integer masking of the f32 bits."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _product(eq: str, a: torch.Tensor, b: torch.Tensor, split: bool) -> torch.Tensor:
    """einsum ``eq`` of f32 operands rounded as K6 rounds them: in split TF32
    ``a_hi b_hi + a_hi b_lo + a_lo b_hi`` (``x_hi = tf32(x)``, ``x_lo =
    tf32(x - x_hi)``), else one TF32 product. Each product of two TF32
    values is exact in f32; the sums are f32."""
    ah, bh = tf32(a), tf32(b)
    if not split:
        return torch.einsum(eq, ah, bh)
    al, bl = tf32(a - ah), tf32(b - bh)
    return torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl) + torch.einsum(eq, ah, bh)


def ssd_chunk_tf32(
    x: torch.Tensor,    # (B, L, H, P) f32
    dt: torch.Tensor,   # (B, L, H)
    A: torch.Tensor,    # (H,)
    Bv: torch.Tensor,   # (B, L, N) (group 0)
    Cv: torch.Tensor,   # (B, L, N)
    chunk: int,
    split: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``ssd_chunk_ref`` in K6's formulation and rounding: CB = C Bᵀ summed
    in f64 from the f32 operands and rounded to f32 once (K6 takes it on
    the FP64 tensor cores); y_intra = W x with W = CB ⊙ exp(segsum) ⊙ dt,
    and state = (s ⊙ B)ᵀ x with s = exp(dA_cs[-1] - dA_cs) dt, each in
    split TF32 (``split``) or in one TF32 pass; the f64 cumsum as in
    ``ssd_chunk_ref``."""
    b, l, h, p = x.shape
    n = Bv.shape[-1]
    if l % chunk:
        raise AssertionError((l, chunk))
    nc, q = l // chunk, chunk
    xc = x.reshape(b, nc, q, h, p)
    dtc = dt.reshape(b, nc, q, h)
    Bc = Bv.reshape(b, nc, q, n)
    Cc = Cv.reshape(b, nc, q, n)

    cs = torch.cumsum(dtc.double() * A.double(), dim=2)
    seg = (cs[:, :, :, None, :] - cs[:, :, None, :, :]).float()
    causal = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    causal = causal[None, None, :, :, None]
    seg = torch.where(causal, seg, torch.zeros_like(seg))
    L = torch.where(causal, torch.exp(seg), torch.zeros_like(seg))

    cb = torch.einsum("bcin,bcjn->bcij", Cc.double(), Bc.double()).float()
    w = cb[..., None] * L * dtc[:, :, None, :, :]                   # (b,nc,i,j,h)
    y = _product("bcijh,bcjhp->bcihp", w, xc, split)

    s = torch.exp((cs[:, :, -1:, :] - cs).float()) * dtc            # (b,nc,q,h)
    bw = Bc[:, :, :, None, :] * s[..., None]                        # (b,nc,q,h,n)
    states = _product("bcqhn,bcqhp->bchnp", bw, xc, split)
    return y.reshape(b, l, h, p), states, cs.float().reshape(b, l, h)


def ssd_sequential(
    x: torch.Tensor,    # (B,L,H,P)
    dt: torch.Tensor,   # (B,L,H)
    A: torch.Tensor,    # (H,)
    Bv: torch.Tensor,   # (B,L,G,N)
    Cv: torch.Tensor,   # (B,L,G,N)
    h0: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token-by-token exact recurrence h_t = h_{t-1}·exp(dt·A) + dt·B⊗x,
    y_t = h_t·C (group 0). Returns (y (B,L,H,P), final (B,H,P,N)) in x's
    dtype."""
    b, l, h, p = x.shape
    n = Bv.shape[-1]
    f32 = torch.float32
    state = h0.to(f32) if h0 is not None else torch.zeros((b, h, p, n), dtype=f32, device=x.device)
    ys = []
    for t in range(l):
        xt, dtt = x[:, t].to(f32), dt[:, t].to(f32)
        bt, ct = Bv[:, t, 0].to(f32), Cv[:, t, 0].to(f32)
        decay = torch.exp(dtt * A)
        state = (state * decay[:, :, None, None]
                 + dtt[:, :, None, None] * xt[:, :, :, None] * bt[:, None, None, :])
        ys.append(torch.einsum("bhpn,bn->bhp", state, ct))
    return torch.stack(ys, dim=1).to(x.dtype), state.to(x.dtype)
