"""Binding of the SSD chunk CUDA kernel (``csrc/ssd.cu``, the Hopper
counterpart of ``repro.kernels.ssd.kernel.ssd_chunk_pallas``).

Takes the layouts the JAX kernel takes (f32, B/C group squeezed), checks
device, dtype, shape and contiguity, allocates the three outputs with
``torch.empty`` and launches on the current stream. The kernel itself
allocates nothing and does not synchronise."""

from __future__ import annotations

from typing import Tuple

import torch

from ..build import check, device_sms, load_library, require, stream_ptr

WHERE = "ssd_chunk_cuda"
STATE_DIMS = (16, 32, 64, 128)   # N: the kernel's instantiations
HEAD_DIMS = (32, 64)             # P
MAX_CHUNK = 128                  # Q: chunk rows per block, at most


def ssd_plan(b: int, nc: int, h: int, sms: int) -> Tuple[int, Tuple[int, int, int]]:
    """K6's launch: ``(heads per block, grid)``. A block takes one (lane,
    chunk) and a group of heads; the group is as small as keeps the grid
    ``(head groups, NC, B)`` within one wave of the card's ``sms`` SMs (one
    block per SM), so a larger group means fewer, longer blocks only where
    the heads outnumber the SMs. The kernel launches the head groups of a
    chunk as clusters of up to 4 blocks that share CB (``csrc/ssd.cu``),
    padding the grid's first axis to a multiple of the cluster."""
    hg = max(1, -(-(b * nc * h) // sms))
    return hg, (-(-h // hg), nc, b)


def ssd_chunk_cuda(
    x: torch.Tensor,    # (B, L, H, P) f32
    dt: torch.Tensor,   # (B, L, H) f32, post-softplus
    A: torch.Tensor,    # (H,) f32
    Bv: torch.Tensor,   # (B, L, N) f32 (group 0)
    Cv: torch.Tensor,   # (B, L, N) f32
    chunk: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch K6 -> (y_intra (B,L,H,P), states (B,NC,H,N,P), dA_cs (B,L,H)),
    all f32: one launch, planned by ``ssd_plan``."""
    b, l, h, p = x.shape
    n = Bv.shape[-1]
    require(WHERE, x.is_cuda, "x must be a CUDA tensor")
    require(WHERE, b > 0 and l > 0 and h > 0, f"empty input {tuple(x.shape)}")
    require(WHERE, 0 < chunk <= MAX_CHUNK and l % chunk == 0,
            f"sequence {l} is no multiple of chunk {chunk} (1..{MAX_CHUNK})")
    require(WHERE, p in HEAD_DIMS, f"head dim {p} not in {HEAD_DIMS}")
    require(WHERE, n in STATE_DIMS, f"state dim {n} not in {STATE_DIMS}")
    for name, t, shape in (("x", x, (b, l, h, p)), ("dt", dt, (b, l, h)), ("A", A, (h,)),
                           ("Bv", Bv, (b, l, n)), ("Cv", Cv, (b, l, n))):
        require(WHERE, t.device == x.device and t.dtype == torch.float32,
                f"{name} must be f32 on x's device")
        require(WHERE, tuple(t.shape) == shape, f"{name} shape {tuple(t.shape)} != {shape}")
        require(WHERE, t.is_contiguous(), f"{name} must be contiguous")
    hg, _ = ssd_plan(b, l // chunk, h, device_sms(x.device))
    y = torch.empty_like(x)
    states = torch.empty((b, l // chunk, h, n, p), dtype=torch.float32, device=x.device)
    dA_cs = torch.empty_like(dt)
    err = load_library().repro_ssd_chunk(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bv.data_ptr(), Cv.data_ptr(),
        y.data_ptr(), states.data_ptr(), dA_cs.data_ptr(), b, l, h, p, n, chunk, hg,
        stream_ptr(x),
    )
    check(err, "repro_ssd_chunk")
    return y, states, dA_cs
