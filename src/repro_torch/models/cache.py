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

On a device mesh a full cache is a DTensor in ``launch.sharding.
cache_specs``' placements: batch over ``data`` (``pod, data`` on two
pods), KV heads over ``model`` where they divide it, else slots over
``model``, or, for a single long sequence, slots over ``data``. DTensor
refuses an in-place write that would change those placements, so the
dense writers write on each rank's shard (GSPMD's dynamic-update-slice on
a sharded dim): the update is redistributed to the cache's placements on
its batch and head dims, each slot is translated into the rank's own
range (``pjit_rules.shard_span``), and a rank whose shard does not hold
the slot keeps its values. The cache keeps its placements.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from .config import ModelConfig
from .layers import dtype_of
from .pjit_rules import is_dtensor, local_shard, shard_span
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


def _like_cache(cache: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """This rank's shard of ``x`` (B, S, ...) placed as the DTensor
    ``cache`` (B, T, ...) on every dim but the slots (replicated there: an
    update spans the slots it writes, and each rank picks its own)."""
    from torch.distributed.tensor import Replicate, Shard

    pl = [Replicate() if isinstance(p, Shard) and p.dim % cache.ndim == 1 else p
          for p in cache.placements]
    return local_shard(x, cache.device_mesh, pl)


def _lanes(cache: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """This rank's lanes of ``x`` (B, ...): sharded as the DTensor
    ``cache``'s batch dim 0, replicated elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    pl = [Shard(0) if isinstance(p, Shard) and p.dim % cache.ndim == 0 else Replicate()
          for p in cache.placements]
    return local_shard(x, cache.device_mesh, pl)


def _write_slots(cache: torch.Tensor, slot: torch.Tensor, vals: torch.Tensor) -> None:
    """cache[b, slot[b]] = vals[b] on this rank's shard of the DTensor
    ``cache`` (B, T, ...), whose slot dim may be sharded; ``slot`` and
    ``vals`` are this rank's lanes, the slots global. A lane whose slot
    lies outside the rank's range rewrites its current value."""
    off, n = shard_span(cache, 1)
    with torch.no_grad():
        loc = cache.to_local()
        s = slot - off
        keep = (s >= 0) & (s < n)
        idx = torch.clamp(s, 0, n - 1)
        bidx = torch.arange(loc.shape[0], device=loc.device)
        cur = loc[bidx, idx]
        keep = keep.reshape(keep.shape + (1,) * (cur.ndim - 1))
        loc[bidx, idx] = torch.where(keep, vals.to(loc.dtype), cur)


def write_step(
    cache_k: torch.Tensor,   # (B, T, KV, Dh) one layer
    cache_v: torch.Tensor,
    k_new: torch.Tensor,     # (B, 1, KV, Dh)
    v_new: torch.Tensor,
    pos: torch.Tensor,       # (B,) absolute position of the new token
    ring: bool = False,
) -> None:
    """Write one decode token's K/V at its slot (``_step_slot``), in place;
    a DTensor cache on each rank's shard (module docstring)."""
    if is_dtensor(cache_k):
        slot = _step_slot(_lanes(cache_k, pos), cache_k.shape[1], ring)
        for cache, new in ((cache_k, k_new), (cache_v, v_new)):
            _write_slots(cache, slot, _like_cache(cache, new)[:, 0])
        return
    slot = _step_slot(pos, cache_k.shape[1], ring)
    bidx = torch.arange(cache_k.shape[0], device=cache_k.device)
    cache_k[bidx, slot] = k_new[:, 0].to(cache_k.dtype)
    cache_v[bidx, slot] = v_new[:, 0].to(cache_v.dtype)


def update_kv_pos(kv_pos: torch.Tensor, pos: torch.Tensor, ring: bool = False) -> None:
    """kv_pos[b, slot of pos[b]] = pos[b], in place (``_step_slot``); a
    DTensor kv_pos on each rank's shard."""
    b, t = kv_pos.shape
    if is_dtensor(kv_pos):
        lp = _lanes(kv_pos, pos)
        _write_slots(kv_pos, _step_slot(lp, t, ring), lp)
        return
    kv_pos[torch.arange(b, device=kv_pos.device), _step_slot(pos, t, ring)] = pos.to(kv_pos.dtype)


def write_layer(stack: torch.Tensor, i: int, value: torch.Tensor) -> None:
    """stack[i] = value, in place: layer ``i`` of a stacked cache leaf (an
    SSM state's ``h`` or ``conv``). A DTensor stack (its layer dim whole)
    takes the value redistributed to its placements, on each rank's
    shard."""
    if not is_dtensor(stack):
        stack[i] = value
        return
    from torch.distributed.tensor import Shard

    pl = []
    for p in stack.placements:
        if isinstance(p, Shard):
            assert p.dim % stack.ndim > 0, stack.placements
            p = Shard(p.dim % stack.ndim - 1)
        pl.append(p)
    with torch.no_grad():
        stack.to_local()[i] = local_shard(value, stack.device_mesh, pl).to(stack.dtype)


def _kept(p0: int, s: int, t: int) -> int:
    """How many of a chunk's ``s`` slots from ``p0`` lie inside a
    ``t``-slot cache; JAX drops the rest (``mode="drop"``)."""
    return max(0, min(s, t - p0))


def _write_span(cache: torch.Tensor, p0: int, new: torch.Tensor) -> None:
    """cache[:, p0 : p0 + S] = new (slots past the cache dropped) on this
    rank's shard of the DTensor ``cache``, whose slot dim may be sharded:
    each rank writes the part of the span its range holds."""
    off, n = shard_span(cache, 1)
    lo, hi = max(p0, off), min(p0 + new.shape[1], off + n)
    if hi > lo:
        with torch.no_grad():
            cache.to_local()[:, lo - off : hi - off] = new[:, lo - p0 : hi - p0].to(cache.dtype)


def write_chunk(
    cache: torch.Tensor,   # (B, T, KV, Dh) one layer of a full cache
    new: torch.Tensor,     # (B, S, KV, Dh) a chunk's rotated K (or V)
    p0: int,               # every lane's chunk starts at slot p0
) -> None:
    """``cache.at[b, p0 + arange(S)].set(new, mode="drop")``, in place:
    slots past the cache are dropped. A DTensor cache on each rank's
    shard."""
    if is_dtensor(cache):
        _write_span(cache, p0, _like_cache(cache, new))
        return
    n = _kept(p0, new.shape[1], cache.shape[1])
    cache[:, p0 : p0 + n] = new[:, :n].to(cache.dtype)


def append_kv_pos(
    kv_pos: torch.Tensor,  # (B, T) slot positions of a full cache
    p0: int,               # every lane's chunk starts at position p0
    valid: torch.Tensor,   # (B, S) bool — False for bucket padding
) -> None:
    """kv_pos after appending a chunk at ``p0`` into a full cache, in
    place: padded chunk positions write -1 (kept invalid), slots past the
    cache are dropped. A DTensor kv_pos on each rank's shard."""
    if is_dtensor(kv_pos):
        lv = _like_cache(kv_pos, valid)
        pos = torch.arange(p0, p0 + lv.shape[1], dtype=kv_pos.dtype, device=lv.device)
        _write_span(kv_pos, p0, torch.where(lv, pos, torch.full_like(pos, -1)))
        return
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


def _slot_positions(j: torch.Tensor, slots: int, seq_len: int, ring: bool) -> torch.Tensor:
    """The position slot ``j`` of a ``slots``-slot cache holds after a
    prefill of ``seq_len`` tokens (-1 = empty): slot == position, or, for
    a ring shorter than the sequence, the last ``slots`` positions at
    slot = position % slots."""
    if not ring or seq_len <= slots:
        return torch.where(j < seq_len, j, torch.full_like(j, -1))
    base = seq_len - slots
    return base + torch.remainder(j - base, slots)


def prefill_kv_pos(
    batch: int, slots: int, seq_len: int, device: Optional[torch.device] = None,
    ring: bool = False, span: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """kv_pos after prefilling ``seq_len`` tokens into a cache of ``slots``
    slots (``_slot_positions``); with ``span`` = (offset, length), only
    those slots (a rank's shard)."""
    off, n = span or (0, slots)
    j = torch.arange(off, off + n, dtype=torch.int32, device=device)
    return _slot_positions(j, slots, seq_len, ring)[None, :].expand(batch, n).clone()


def ring_from_prefill(
    k: torch.Tensor, window: int, span: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """A prefill's keys (or values) (B, S, KV, Dh) packed into a ring of
    ``window`` slots (slot = position % window): the last ``window``
    positions, or, for S <= window, the S positions and zero slots after
    them. With ``span`` = (offset, length), only those slots (a rank's
    shard)."""
    s = k.shape[1]
    off, n = span or (0, window)
    j = torch.arange(off, off + n, device=k.device)
    if s <= window:
        out = k[:, torch.clamp(j, max=s - 1)]
        return torch.where((j < s)[None, :, None, None], out, torch.zeros_like(out))
    return k[:, _slot_positions(j, window, s, True)]


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
