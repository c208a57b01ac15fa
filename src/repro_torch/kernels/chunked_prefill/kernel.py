"""Binding of the chunked paged prefill attention CUDA kernel
(``csrc/chunked_prefill.cu``, the Hopper counterpart of
``repro.kernels.chunked_prefill.kernel.chunked_prefill_pallas``).

Takes the layouts the JAX kernel takes after its wrapper's reshapes, checks
device, dtype, shape and contiguity, allocates the output with
``torch.empty`` and launches on the current stream. The kernel itself
allocates nothing and does not synchronise."""

from __future__ import annotations

import torch

from ..build import DTYPE_CODES, check, load_library, require, stream_ptr

WHERE = "chunked_prefill_cuda"


def chunked_prefill_cuda(
    q: torch.Tensor,           # (B, KV, S*G, Dh) — reshaped + rope'd by ops.py
    pool_k: torch.Tensor,      # (P, page_size, KV, Dh) — post-scatter pool
    pool_v: torch.Tensor,
    page_table: torch.Tensor,  # (B, MP) int32 physical page ids per lane
    page_bound: torch.Tensor,  # (B,) int32 — ceil((p0+true_len)/ps), in [1, MP]
    p0: torch.Tensor,          # (B,) int32 absolute position of chunk row 0
    *,
    g: int,
    window: int = 0,
    softcap: float = 0.0,
) -> torch.Tensor:
    b, kvh, sg, dh = q.shape
    p, ps = pool_k.shape[0], pool_k.shape[1]
    mp = page_table.shape[1]
    require(WHERE, q.is_cuda, "q must be a CUDA tensor")
    require(WHERE, q.dtype in DTYPE_CODES, f"unsupported dtype {q.dtype}")
    require(WHERE, sg > 0 and sg % g == 0, f"S*G = {sg} is not a positive multiple of G = {g}")
    for name, t in (("pool_k", pool_k), ("pool_v", pool_v)):
        require(WHERE, t.device == q.device and t.dtype == q.dtype,
                 f"{name} must match q's device and dtype")
        require(WHERE, tuple(t.shape) == (p, ps, kvh, dh), f"{name} shape {tuple(t.shape)}")
    for name, t, shape in (
        ("page_table", page_table, (b, mp)),
        ("page_bound", page_bound, (b,)),
        ("p0", p0, (b,)),
    ):
        require(WHERE, t.device == q.device and t.dtype == torch.int32,
                 f"{name} must be int32 on q's device")
        require(WHERE, tuple(t.shape) == shape, f"{name} shape {tuple(t.shape)} != {shape}")
    for name, t in (("q", q), ("pool_k", pool_k), ("pool_v", pool_v),
                    ("page_table", page_table), ("page_bound", page_bound),
                    ("p0", p0)):
        require(WHERE, t.is_contiguous(), f"{name} must be contiguous")
    require(WHERE, dh in (16, 32, 64, 128), f"head dim {dh} not in (16, 32, 64, 128)")
    for name, t in (("q", q), ("pool_k", pool_k), ("pool_v", pool_v)):
        require(WHERE, t.data_ptr() % 16 == 0, f"{name} must be 16-byte aligned")
    out = torch.empty_like(q)
    err = load_library().repro_chunked_prefill(
        q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(), page_table.data_ptr(),
        page_bound.data_ptr(), p0.data_ptr(), out.data_ptr(),
        b, kvh, sg, g, dh, p, ps, mp, int(window), float(softcap), 1.0 / (dh ** 0.5),
        DTYPE_CODES[q.dtype], stream_ptr(q),
    )
    check(err, "repro_chunked_prefill")
    return out
