"""Bindings of the paged decode attention CUDA kernels: the per-lane walk
(``csrc/paged_attention.cu``, the Hopper counterpart of
``repro.kernels.paged_attention.kernel.paged_attention_pallas``) and the
shared-prefix cascade pass (``csrc/shared_prefix.cu``, the counterpart of
``shared_prefix_pallas``).

Takes the layouts the JAX kernel takes after its wrapper's reshapes, checks
device, dtype, shape and contiguity, allocates the output with
``torch.empty`` and launches on the current stream. The kernel itself
allocates nothing and does not synchronise."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..build import DTYPE_CODES, check, load_library, require, stream_ptr

WHERE = "paged_attention_cuda"
WHERE_SHARED = "shared_prefix_cuda"
HEAD_DIMS = (16, 32, 64, 128)


def _check_q_and_pools(where: str, q, pool_k, pool_v) -> None:
    _, kvh, _, dh = q.shape
    p, ps = pool_k.shape[0], pool_k.shape[1]
    require(where, q.is_cuda, "q must be a CUDA tensor")
    require(where, q.dtype in DTYPE_CODES, f"unsupported dtype {q.dtype}")
    for name, t in (("pool_k", pool_k), ("pool_v", pool_v)):
        require(where, t.device == q.device and t.dtype == q.dtype,
                f"{name} must match q's device and dtype")
        require(where, tuple(t.shape) == (p, ps, kvh, dh), f"{name} shape {tuple(t.shape)}")
    require(where, dh in HEAD_DIMS, f"head dim {dh} not in {HEAD_DIMS}")
    for name, t in (("q", q), ("pool_k", pool_k), ("pool_v", pool_v)):
        require(where, t.is_contiguous(), f"{name} must be contiguous")
        require(where, t.data_ptr() % 16 == 0, f"{name} must be 16-byte aligned")


def _check_ints(where: str, q, named) -> None:
    for name, t, shape in named:
        require(where, t.device == q.device and t.dtype == torch.int32,
                f"{name} must be int32 on q's device")
        require(where, tuple(t.shape) == shape, f"{name} shape {tuple(t.shape)} != {shape}")
        require(where, t.is_contiguous(), f"{name} must be contiguous")


def paged_attention_cuda(
    q: torch.Tensor,           # (B, KV, G, Dh) — reshaped + rope'd by ops.py
    pool_k: torch.Tensor,      # (P, page_size, KV, Dh) — shared pool, one layer
    pool_v: torch.Tensor,
    page_table: torch.Tensor,  # (B, MP) int32 physical page ids per lane
    page_bound: torch.Tensor,  # (B,) int32 — ceil((q_pos+1)/ps), in [1, MP]
    q_pos: torch.Tensor,       # (B,) int32 absolute position of the query
    kv_pos: torch.Tensor,      # (B, MP*page_size) int32, -1 = empty slot
    *,
    window: int = 0,
    softcap: float = 0.0,
    start: int = 0,            # first page walked (the cascade's suffix pass)
    init: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """Launch K1 -> (B, KV, G, Dh) in q's dtype. With ``start``/``init`` it
    continues the shared-prefix pass's f32 ``(acc, m, l)`` over pages
    ``[start, bound)``."""
    b, kvh, g, dh = q.shape
    p, ps = pool_k.shape[0], pool_k.shape[1]
    mp = page_table.shape[1]
    _check_q_and_pools(WHERE, q, pool_k, pool_v)
    _check_ints(WHERE, q, (
        ("page_table", page_table, (b, mp)),
        ("page_bound", page_bound, (b,)),
        ("q_pos", q_pos, (b,)),
        ("kv_pos", kv_pos, (b, mp * ps)),
    ))
    require(WHERE, g * dh <= 1024, f"G * Dh = {g * dh} exceeds 1024")
    require(WHERE, 0 <= start < mp, f"start {start} not in [0, {mp})")
    seeds = (None, None, None)
    if init is not None:
        seeds = init
        for name, t, shape in zip(("acc0", "m0", "l0"), init,
                                  ((b, kvh, g, dh), (b, kvh, g, 1), (b, kvh, g, 1))):
            require(WHERE, t.device == q.device and t.dtype == torch.float32,
                    f"{name} must be float32 on q's device")
            require(WHERE, tuple(t.shape) == shape, f"{name} shape {tuple(t.shape)} != {shape}")
            require(WHERE, t.is_contiguous(), f"{name} must be contiguous")
    out = torch.empty_like(q)
    err = load_library().repro_paged_attention(
        q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(), page_table.data_ptr(),
        page_bound.data_ptr(), q_pos.data_ptr(), kv_pos.data_ptr(),
        *(None if t is None else t.data_ptr() for t in seeds), out.data_ptr(),
        b, kvh, g, dh, p, ps, mp, int(window), int(start), float(softcap),
        1.0 / (dh ** 0.5), DTYPE_CODES[q.dtype], stream_ptr(q),
    )
    check(err, "repro_paged_attention")
    return out


def shared_prefix_cuda(
    q: torch.Tensor,             # (B, KV, G, Dh) — reshaped + rope'd by ops.py
    pool_k: torch.Tensor,        # (P, page_size, KV, Dh) — shared pool, one layer
    pool_v: torch.Tensor,
    shared_pages: torch.Tensor,  # (S,) int32 physical pages, positions [0, S*ps)
    q_pos: torch.Tensor,         # (B,) int32 absolute position of the query
    *,
    window: int = 0,
    softcap: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch K2: f32 ``(acc, m, l)`` of shapes (B, KV, G, Dh), (B, KV, G, 1)
    and (B, KV, G, 1) — every lane's partial softmax state over the run."""
    b, kvh, g, dh = q.shape
    p, ps = pool_k.shape[0], pool_k.shape[1]
    s = shared_pages.shape[0]
    _check_q_and_pools(WHERE_SHARED, q, pool_k, pool_v)
    _check_ints(WHERE_SHARED, q, (("shared_pages", shared_pages, (s,)), ("q_pos", q_pos, (b,))))
    require(WHERE_SHARED, s > 0 and b > 0, f"empty run ({s} pages) or batch ({b})")
    require(WHERE_SHARED, g * dh <= 2048, f"G * Dh = {g * dh} exceeds 2048")
    acc = torch.empty((b, kvh, g, dh), dtype=torch.float32, device=q.device)
    m = torch.empty((b, kvh, g, 1), dtype=torch.float32, device=q.device)
    l = torch.empty((b, kvh, g, 1), dtype=torch.float32, device=q.device)
    err = load_library().repro_shared_prefix(
        q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(), shared_pages.data_ptr(),
        q_pos.data_ptr(), acc.data_ptr(), m.data_ptr(), l.data_ptr(),
        b, kvh, g, dh, p, ps, s, int(window), float(softcap), 1.0 / (dh ** 0.5),
        DTYPE_CODES[q.dtype], stream_ptr(q),
    )
    check(err, "repro_shared_prefix")
    return acc, m, l
