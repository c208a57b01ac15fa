"""Paged KV cache structures for serving — the PyTorch counterpart of the
paged half of ``repro.models.cache``.

A paged pool replaces the per-sequence full-width (B, T, KV, Dh) cache with
one shared physical pool of fixed-size pages, ``(L, P, page_size, KV, Dh)``
per layer group. A sequence is a *page table* whose concatenation
reproduces the linear ``slot == absolute position`` layout, so attention
stays position-masked. Page 0 is the scratch page: table padding points at
it, and anything written there is garbage by design.

Unlike the JAX package, whose pure functions return new pools, the writers
here update the pool tensors **in place** (``paged_write_step``,
``paged_write_chunk``) — the pools are the allocator's long-lived device
buffers and copying them per token would cost a pool's worth of bytes.

JAX drops an out-of-range scatter (``mode="drop"``); on CUDA an
out-of-range index is a device assert, and masking by boolean selection
would synchronise with the host once per layer. So a write that JAX drops
is redirected here to cell (0, 0) of the scratch page carrying that cell's
current value: every such write stores the same bytes, the pool is left
exactly as JAX leaves it, and nothing waits on the device.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from .config import ModelConfig
from .layers import dtype_of

Cache = Dict[str, torch.Tensor]


def init_paged_pool(
    cfg: ModelConfig, n_layers: int, n_pages: int, page_size: int,
    device: Optional[torch.device] = None,
) -> Cache:
    """Physical KV page pool for one layer group: k/v of shape
    (L, n_pages, page_size, KV, Dh) in the compute dtype, zero-filled."""
    dt = dtype_of(cfg.compute_dtype)
    shape = (n_layers, n_pages, page_size, cfg.n_kv_heads, cfg.d_head)
    return {
        "k": torch.zeros(shape, dtype=dt, device=device),
        "v": torch.zeros(shape, dtype=dt, device=device),
    }


def gather_pages(pool: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """Linearize one layer's pool (P, ps, KV, Dh) through a page table
    (B, MP): returns a fresh (B, MP*ps, KV, Dh) view copy whose slot t
    holds page_table[t // ps], offset t % ps."""
    b, mp = page_table.shape
    ps = pool.shape[1]
    out = pool[page_table.long()]                    # (B, MP, ps, KV, Dh)
    return out.reshape(b, mp * ps, pool.shape[2], pool.shape[3])


def gather_pages_stacked(
    pool_k: torch.Tensor,      # (L, P, ps, KV, Dh) — a layer group's K pool
    pool_v: torch.Tensor,
    page_table: torch.Tensor,  # (B, MP)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The hoisted form of :func:`gather_pages` for the reference paths:
    one indexed load per pool per step for the whole layer stack. Returns
    ``(k, v)`` copies of shape (L, B, MP*ps, KV, Dh)."""
    l, _, ps, kv, dh = pool_k.shape
    b, mp = page_table.shape
    flat = (l, b, mp * ps, kv, dh)
    tbl = page_table.long()
    return pool_k[:, tbl].reshape(flat), pool_v[:, tbl].reshape(flat)


def _write_cells(
    pool: torch.Tensor, phys: torch.Tensor, slot: torch.Tensor,
    keep: torch.Tensor, vals: torch.Tensor,
) -> None:
    """pool[phys, slot] = vals where keep, in place; the other writes are
    redirected to scratch cell (0, 0) with its current value (see module
    docstring)."""
    sink = pool[0, 0].clone()
    k = keep[..., None, None]
    pool.index_put_(
        (torch.where(keep, phys, 0).long(), torch.where(keep, slot, 0).long()),
        torch.where(k, vals.to(pool.dtype), sink),
    )


def paged_write_step(
    pool_k: torch.Tensor,      # (P, ps, KV, Dh) one layer
    pool_v: torch.Tensor,
    k_new: torch.Tensor,       # (B, 1, KV, Dh)
    v_new: torch.Tensor,
    pos: torch.Tensor,         # (B,) absolute position of the new token
    page_table: torch.Tensor,  # (B, MP)
    page_size: int,
) -> None:
    """Write one decode token's K/V into its (page, offset) cell, in place.
    A lane whose position has run past the table (``pos >= MP * ps``) has
    its write dropped, never clamped into the last page (which would
    overwrite the resident KV of the token living in that cell)."""
    mp = page_table.shape[1]
    page_idx = pos // page_size
    keep = (page_idx < mp) & (pos >= 0)
    phys = torch.gather(page_table, 1, page_idx.clamp(0, mp - 1).long()[:, None])[:, 0]
    slot = pos % page_size
    _write_cells(pool_k, phys, slot, keep, k_new[:, 0])
    _write_cells(pool_v, phys, slot, keep, v_new[:, 0])


def paged_write_chunk(
    pool_k: torch.Tensor,      # (P, ps, KV, Dh) one layer
    pool_v: torch.Tensor,
    k_new: torch.Tensor,       # (B, S, KV, Dh) — a prefill chunk's rotated K
    v_new: torch.Tensor,
    q_pos: torch.Tensor,       # (B, S) absolute position of each chunk token
    valid: torch.Tensor,       # (B, S) bool — False for bucket padding
    page_table: torch.Tensor,  # (B, MP)
    page_size: int,
    n_skip: int = 0,
) -> None:
    """Write a prefill chunk's K/V into their (page, offset) cells, in
    place. Dropped, as in JAX: bucket padding (``valid`` False), positions
    past the table, and writes into the first ``n_skip`` pages (shared
    prefix pages another session owns are read-only)."""
    mp = page_table.shape[1]
    page_idx = q_pos // page_size
    keep = valid & (page_idx < mp) & (page_idx >= n_skip) & (q_pos >= 0)
    phys = torch.gather(page_table, 1, page_idx.clamp(0, mp - 1).long())
    slot = q_pos % page_size
    _write_cells(pool_k, phys, slot, keep, k_new)
    _write_cells(pool_v, phys, slot, keep, v_new)


def update_kv_pos_paged(kv_pos: torch.Tensor, pos: torch.Tensor) -> None:
    """kv_pos[b, pos[b]] = pos[b], in place, dropped when ``pos`` is past
    the width: a lane at table capacity keeps its last slot's label."""
    w = kv_pos.shape[1]
    keep = (pos < w) & (pos >= 0)
    idx = torch.where(keep, pos, 0).long()[:, None]
    cur = torch.gather(kv_pos, 1, idx)
    kv_pos.scatter_(1, idx, torch.where(keep[:, None], pos.to(kv_pos.dtype)[:, None], cur))
