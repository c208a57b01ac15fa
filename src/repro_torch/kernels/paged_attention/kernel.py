"""Bindings of the paged decode attention CUDA kernels: the per-lane walk
(``csrc/paged_attention.cu``, the Hopper counterpart of
``repro.kernels.paged_attention.kernel.paged_attention_pallas``) and the
shared-prefix cascade pass (``csrc/shared_prefix.cu``, the counterpart of
``shared_prefix_pallas``), and the host's planner of the split decode walk
that K1, K2 and K5 share (``csrc/split_decode.cuh``).

Takes the layouts the JAX kernel takes after its wrapper's reshapes, checks
device, dtype, shape and contiguity, allocates the output with
``torch.empty`` and launches on the current stream. The kernel itself
allocates nothing and does not synchronise."""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from ..build import DTYPE_CODES, check, load_library, require, stream_ptr

WHERE = "paged_attention_cuda"
WHERE_SHARED = "shared_prefix_cuda"
HEAD_DIMS = (16, 32, 64, 128, 192)

SPLIT_TILE = 128      # tokens per unit of a split plan (split_decode.cuh kTile)
MAX_SPLITS = 8        # the portable thread-block cluster size
TARGET_BLOCKS = 128   # a wave of the H100's 132 SMs, as power-of-two grids reach it
K2_MAX_LANES = 64     # lanes per K2 block (shared_prefix.cu kMaxLanes)
K2_MAX_ROWS_DH = 2048  # lanes * rows * Dh per K2 block (kMaxRowsDh)
BLOCK_ROWS_DH = 1024  # query rows * Dh per K1 / K5 block (their kMaxRowsDh)
MAX_G_DH = 3072       # G * Dh that K1, K2 and K5 take: at most four row groups
                      # (nemotron's 12 x 192 = 2304: three in K1 / K5, two in K2)


def row_groups(g: int, dh: int, limit: int = BLOCK_ROWS_DH) -> Tuple[int, int]:
    """The cut of a KV head's G query rows into ``(groups, rows per
    group)``: the fewest groups of at most ``limit / dh`` rows each (K1's
    and K5's ``BLOCK_ROWS_DH``; K2's ``K2_MAX_ROWS_DH``). Each group is its
    own cluster of the launch and reads the KV head's K/V rows itself."""
    n = 1
    while -(-g // n) * dh > limit:
        n += 1
    return n, -(-g // n)


def plan_splits(blocks: int, n_tokens: int) -> int:
    """Blocks per cluster for a split decode walk of ``n_tokens`` keys by
    ``blocks`` clusters: the smallest power of two that brings the grid to
    ``TARGET_BLOCKS``, at most ``MAX_SPLITS``, with at least one
    ``SPLIT_TILE``-token tile per split."""
    tiles = -(-n_tokens // SPLIT_TILE)
    splits = 1
    while splits < MAX_SPLITS and blocks * splits < TARGET_BLOCKS and 2 * splits <= tiles:
        splits *= 2
    return splits


def split_ranges(n_tokens: int, splits: int) -> List[Tuple[int, int]]:
    """Token range ``[lo, hi)`` of each split, whole tiles, balanced: the
    arithmetic of ``split_range`` in ``csrc/split_decode.cuh``."""
    tiles = -(-n_tokens // SPLIT_TILE)
    edge = lambda k: min(n_tokens, tiles * k // splits * SPLIT_TILE)  # noqa: E731
    return [(edge(k), edge(k + 1)) for k in range(splits)]


def shared_prefix_plan(b: int, kvh: int, g: int, dh: int,
                       n_tokens: int) -> Tuple[int, int, Tuple[int, int, int]]:
    """K2's launch: ``(lanes per block, splits, grid)``. A KV head's G rows
    are cut into ``row_groups(G, Dh, K2_MAX_ROWS_DH)`` (one group while
    ``G * Dh <= 2048``), and a block holds as many lanes as keep ``lanes *
    rows * Dh <= K2_MAX_ROWS_DH``; the grid is ``(splits, KV x groups, lane
    tiles)`` with clusters of ``(splits, 1, 1)``."""
    n_groups, rows = row_groups(g, dh, K2_MAX_ROWS_DH)
    lanes = min(b, K2_MAX_LANES, max(1, K2_MAX_ROWS_DH // (rows * dh)))
    tiles = -(-b // lanes)
    splits = plan_splits(kvh * n_groups * tiles, n_tokens)
    return lanes, splits, (splits, kvh * n_groups, tiles)


def paged_plan(b: int, kvh: int, mp: int, ps: int, start: int = 0,
               n_groups: int = 1) -> Tuple[int, Tuple[int, int, int]]:
    """K1's launch: ``(splits, grid)``, the grid ``(splits, KV x n_groups,
    B)`` with clusters of ``(splits, 1, 1)`` (``n_groups`` row groups per KV
    head, ``row_groups``). The host sees only the widest walk a lane can
    have, ``(MP - start) * ps`` tokens; each block cuts its own lane's range
    on the device (``paged_split_ranges``)."""
    splits = plan_splits(b * kvh * n_groups, (mp - start) * ps)
    return splits, (splits, kvh * n_groups, b)


def paged_lane_range(q_pos: int, bound: int, ps: int, start: int = 0,
                     window: int = 0) -> Tuple[int, int]:
    """The tokens ``[lo, hi)`` K1 walks for one lane: from the first page
    walked or the window's first position, to the lane's page bound."""
    lo = max(start * ps, q_pos - window + 1 if window > 0 else 0)
    return lo, max(lo, bound * ps)


def paged_split_ranges(q_pos: int, bound: int, ps: int, splits: int, start: int = 0,
                       window: int = 0) -> List[Tuple[int, int]]:
    """Each split's tokens of one lane: ``split_ranges`` of the lane's
    range, offset by its start — the arithmetic of ``paged_attention_split``
    in ``csrc/paged_attention.cu``."""
    lo, hi = paged_lane_range(q_pos, bound, ps, start, window)
    return [(lo + a, lo + b) for a, b in split_ranges(hi - lo, splits)]


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
    """Launch K1 -> (B, KV, G, Dh) in q's dtype: one cluster launch, planned
    by ``paged_plan`` over ``row_groups(G, Dh)``. With ``start``/``init`` it
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
    require(WHERE, b > 0, "empty batch")
    require(WHERE, g * dh <= MAX_G_DH, f"G * Dh = {g * dh} exceeds {MAX_G_DH}")
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
    n_groups, rows = row_groups(g, dh)
    splits, _ = paged_plan(b, kvh, mp, ps, start, n_groups)
    out = torch.empty_like(q)
    err = load_library().repro_paged_attention(
        q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(), page_table.data_ptr(),
        page_bound.data_ptr(), q_pos.data_ptr(), kv_pos.data_ptr(),
        *(None if t is None else t.data_ptr() for t in seeds), out.data_ptr(),
        b, kvh, g, rows, dh, p, ps, mp, splits, int(window), int(start), float(softcap),
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
    and (B, KV, G, 1) — every lane's partial softmax state over the run. One
    cluster launch, planned by ``shared_prefix_plan`` over ``row_groups(G,
    Dh, K2_MAX_ROWS_DH)``."""
    b, kvh, g, dh = q.shape
    p, ps = pool_k.shape[0], pool_k.shape[1]
    s = shared_pages.shape[0]
    _check_q_and_pools(WHERE_SHARED, q, pool_k, pool_v)
    _check_ints(WHERE_SHARED, q, (("shared_pages", shared_pages, (s,)), ("q_pos", q_pos, (b,))))
    require(WHERE_SHARED, s > 0 and b > 0, f"empty run ({s} pages) or batch ({b})")
    require(WHERE_SHARED, g * dh <= MAX_G_DH, f"G * Dh = {g * dh} exceeds {MAX_G_DH}")
    rows = row_groups(g, dh, K2_MAX_ROWS_DH)[1]
    lanes, splits, _ = shared_prefix_plan(b, kvh, g, dh, s * ps)
    acc = torch.empty((b, kvh, g, dh), dtype=torch.float32, device=q.device)
    m = torch.empty((b, kvh, g, 1), dtype=torch.float32, device=q.device)
    l = torch.empty((b, kvh, g, 1), dtype=torch.float32, device=q.device)
    err = load_library().repro_shared_prefix(
        q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(), shared_pages.data_ptr(),
        q_pos.data_ptr(), acc.data_ptr(), m.data_ptr(), l.data_ptr(),
        b, kvh, g, rows, dh, p, ps, s, lanes, splits, int(window), float(softcap),
        1.0 / (dh ** 0.5), DTYPE_CODES[q.dtype], stream_ptr(q),
    )
    check(err, "repro_shared_prefix")
    return acc, m, l
