"""KV cache structures for serving — the PyTorch counterpart of
``repro.models.cache`` for full-cache attention groups and SSM layers.

Three kinds:

- the full cache ``{"k", "v": (L, B, T, KV, Dh), "kv_pos": (B, T)}`` of the
  dense route, one per layer group, stacked over the group's layers, with
  slot index == absolute position (``kv_pos`` -1 = empty); a ring cache
  (gemma2's local layers, the sliding-window variant) has the same layout
  with ``T`` = the window's slots and slot = position % T, holding the
  last T positions (attention masks by ``kv_pos``, so both share one
  rule);
- the paged pool of the paged route;
- the SSM state ``{"h": (L, B, H, P, N), "conv": (L, B, K, conv_dim)}`` of
  the mamba layers (the zamba group keeps one beside its shared block's
  full cache).

A paged pool replaces the per-sequence full-width (B, T, KV, Dh) cache with
one shared physical pool of fixed-size pages, ``(L, P, page_size, KV, Dh)``
per layer group. A sequence is a *page table* whose concatenation
reproduces the linear ``slot == absolute position`` layout, so attention
stays position-masked. Page 0 is the scratch page: table padding points at
it, and anything written there is garbage by design.

Unlike the JAX package, whose pure functions return new arrays, the
writers here update caches and pools **in place** (``write_step``,
``update_kv_pos``, ``append_kv_pos``, ``write_chunk``,
``paged_write_step``, ``paged_write_chunk``) — copying a cache per token
would cost a cache's worth of bytes. A caller that must keep a cache (a
session pool entry) hands these a copy (``clone_caches``).

JAX drops an out-of-range scatter (``mode="drop"``); on CUDA an
out-of-range index is a device assert, and masking by boolean selection
would synchronise with the host once per layer. A full cache's chunk
starts at a position the host knows (every caller appends from a host
offset), so its kept span is a slice and the dropped tail is never
written. In a paged pool a write that JAX drops is redirected to cell
(0, 0) of the scratch page carrying that cell's current value: the pool
is left exactly as JAX leaves it, and nothing waits on the device. The
dense writers that JAX clamps (``write_step``, ``update_kv_pos``) clamp
here too.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from .config import ModelConfig
from .layers import dtype_of
from .ssm import conv_dim

Cache = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# Full caches (the dense route)
# ---------------------------------------------------------------------------

def init_attn_cache(
    cfg: ModelConfig, n_layers: int, batch: int, slots: int,
    device: Optional[torch.device] = None,
) -> Cache:
    """Empty full cache of one layer group: k/v zeros (L, B, T, KV, Dh) in
    the compute dtype, kv_pos -1."""
    dt = dtype_of(cfg.compute_dtype)
    shape = (n_layers, batch, slots, cfg.n_kv_heads, cfg.d_head)
    return {
        "k": torch.zeros(shape, dtype=dt, device=device),
        "v": torch.zeros(shape, dtype=dt, device=device),
        "kv_pos": torch.full((batch, slots), -1, dtype=torch.int32, device=device),
    }


def init_ssm_cache(
    cfg: ModelConfig, n_layers: int, batch: int, device: Optional[torch.device] = None,
) -> Cache:
    """Empty SSM state of one layer group, in the compute dtype: ``h``
    (L, B, H, P, N) and the conv window ``conv`` (L, B, K, conv_dim)."""
    dt = dtype_of(cfg.compute_dtype)
    nh, n = cfg.n_ssm_heads, cfg.ssm_state
    return {
        "h": torch.zeros((n_layers, batch, nh, cfg.d_inner // nh, n), dtype=dt, device=device),
        "conv": torch.zeros((n_layers, batch, cfg.ssm_conv, conv_dim(cfg)), dtype=dt,
                            device=device),
    }


def clone_caches(caches: List[Cache]) -> List[Cache]:
    """Fresh copies of a cache list, for compute that writes in place on a
    cache someone else keeps (a session pool entry)."""
    return [{name: t.clone() for name, t in c.items()} for c in caches]


def _step_slot(pos: torch.Tensor, t: int, ring: bool) -> torch.Tensor:
    """A decode token's slot: ``pos % T`` in a ring, else ``min(pos, T - 1)``
    (JAX clamps a full cache, it does not drop)."""
    return (torch.remainder(pos, t) if ring else torch.clamp(pos, max=t - 1)).long()


def write_step(
    cache_k: torch.Tensor,   # (B, T, KV, Dh) one layer
    cache_v: torch.Tensor,
    k_new: torch.Tensor,     # (B, 1, KV, Dh)
    v_new: torch.Tensor,
    pos: torch.Tensor,       # (B,) absolute position of the new token
    ring: bool = False,
) -> None:
    """Write one decode token's K/V at its slot (``_step_slot``), in place."""
    slot = _step_slot(pos, cache_k.shape[1], ring)
    bidx = torch.arange(cache_k.shape[0], device=cache_k.device)
    cache_k[bidx, slot] = k_new[:, 0].to(cache_k.dtype)
    cache_v[bidx, slot] = v_new[:, 0].to(cache_v.dtype)


def update_kv_pos(kv_pos: torch.Tensor, pos: torch.Tensor, ring: bool = False) -> None:
    """kv_pos[b, slot of pos[b]] = pos[b], in place (``_step_slot``)."""
    b, t = kv_pos.shape
    kv_pos[torch.arange(b, device=kv_pos.device), _step_slot(pos, t, ring)] = pos.to(kv_pos.dtype)


def _kept(p0: int, s: int, t: int) -> int:
    """How many of a chunk's ``s`` slots from ``p0`` lie inside a
    ``t``-slot cache; JAX drops the rest (``mode="drop"``)."""
    return max(0, min(s, t - p0))


def write_chunk(
    cache: torch.Tensor,   # (B, T, KV, Dh) one layer of a full cache
    new: torch.Tensor,     # (B, S, KV, Dh) a chunk's rotated K (or V)
    p0: int,               # every lane's chunk starts at slot p0
) -> None:
    """``cache.at[b, p0 + arange(S)].set(new, mode="drop")``, in place:
    slots past the cache are dropped."""
    n = _kept(p0, new.shape[1], cache.shape[1])
    cache[:, p0 : p0 + n] = new[:, :n].to(cache.dtype)


def append_kv_pos(
    kv_pos: torch.Tensor,  # (B, T) slot positions of a full cache
    p0: int,               # every lane's chunk starts at position p0
    valid: torch.Tensor,   # (B, S) bool — False for bucket padding
) -> None:
    """kv_pos after appending a chunk at ``p0`` into a full cache, in
    place: padded chunk positions write -1 (kept invalid), slots past the
    cache are dropped."""
    n = _kept(p0, valid.shape[1], kv_pos.shape[1])
    pos = torch.arange(p0, p0 + n, dtype=kv_pos.dtype, device=kv_pos.device)
    kv_pos[:, p0 : p0 + n] = torch.where(valid[:, :n], pos, torch.full_like(pos, -1))


def trim_kv_pos(kv_pos: torch.Tensor, n_valid) -> torch.Tensor:
    """A new kv_pos with every slot at index >= n_valid invalid (full
    cache: slot == position). ``n_valid`` is an int or a (B,) tensor."""
    t = kv_pos.shape[1]
    j = torch.arange(t, dtype=torch.int32, device=kv_pos.device)
    n = torch.as_tensor(n_valid, dtype=torch.int32, device=kv_pos.device)
    keep = j[None, :] < (n[:, None] if n.dim() == 1 else n)
    return torch.where(keep, kv_pos, torch.full_like(kv_pos, -1))


def trim_cache_prefix(caches: List[Cache], n_valid: int) -> List[Cache]:
    """B = 1 full caches with kv_pos masked beyond ``n_valid`` — the one
    trim every pool-storage path uses (serve write-back, prime, resend
    reuse): slots past the kept prefix hold K/V of discarded or
    not-yet-requested tokens. New dicts sharing the k/v tensors."""
    return [
        {"k": c["k"], "v": c["v"], "kv_pos": trim_kv_pos(c["kv_pos"], [n_valid])}
        for c in caches
    ]


def prefill_kv_pos(
    batch: int, slots: int, seq_len: int, device: Optional[torch.device] = None,
    ring: bool = False,
) -> torch.Tensor:
    """kv_pos after prefilling ``seq_len`` tokens into a cache of ``slots``
    slots: slot == position, or, for a ring shorter than the sequence, the
    last ``slots`` positions at slot = position % slots."""
    j = torch.arange(slots, dtype=torch.int32, device=device)
    if not ring or seq_len <= slots:
        pos = torch.where(j < seq_len, j, torch.full_like(j, -1))
    else:
        base = seq_len - slots
        pos = base + torch.remainder(j - base, slots)
    return pos[None, :].expand(batch, slots).clone()


def ring_from_prefill(k: torch.Tensor, window: int) -> torch.Tensor:
    """A prefill's keys (or values) (B, S, KV, Dh) packed into a ring of
    ``window`` slots (slot = position % window): the last ``window``
    positions, or, for S <= window, the S positions and zero slots after
    them."""
    s = k.shape[1]
    j = torch.arange(window, device=k.device)
    if s <= window:
        out = k[:, torch.clamp(j, max=s - 1)]
        return torch.where((j < s)[None, :, None, None], out, torch.zeros_like(out))
    base = s - window
    return k[:, base + torch.remainder(j - base, window)]


# ---------------------------------------------------------------------------
# Paged pools (the paged route)
# ---------------------------------------------------------------------------

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
