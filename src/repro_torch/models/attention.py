"""Attention — the PyTorch counterpart of ``repro.models.attention``: the
dense route (full-sequence prefill, chunk append and decode against a
full-width cache) and the paged route (decode and prefill chunks through a
page table).

Two execution paths, chosen by ``cfg.attn_impl``:

- ``"reference"`` — plain PyTorch: the position-masked SDPA in f32 (the
  paged route gathers the lane's pages into the linear slot == position
  view first).
- anything else — the hand-written Hopper kernels:
  ``repro_torch.kernels.flash_attention`` (K4) for prefill and appends,
  ``decode_attention`` (K5) for dense decode, ``paged_attention`` (K1, K2)
  for paged decode and ``chunked_prefill`` (K3) for paged prefill chunks.
  On a CPU tensor those wrappers run their plain versions, so the CPU
  tests reach this branch too.

Caches and pools are written in place (JAX returns new arrays).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .config import ModelConfig
from .layers import Params, apply_rope, dtype_of, init_normal, pos1d, softcap
from .pjit_rules import (
    all_reduce,
    constrain,
    flatten,
    from_shards,
    is_dtensor,
    local_shard,
    unflatten,
)

NEG_INF = -1e30


def init_attention(cfg: ModelConfig, gen: torch.Generator, device: torch.device) -> Params:
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    dt = dtype_of(cfg.param_dtype)
    s = 1.0 / np.sqrt(d)
    so = 1.0 / np.sqrt(h * dh)
    p: Params = {
        "wq": init_normal((d, h * dh), s, dt, gen, device),
        "wk": init_normal((d, kv * dh), s, dt, gen, device),
        "wv": init_normal((d, kv * dh), s, dt, gen, device),
        "wo": init_normal((h * dh, d), so, dt, gen, device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((h * dh,), dtype=dt, device=device)
        p["bk"] = torch.zeros((kv * dh,), dtype=dt, device=device)
        p["bv"] = torch.zeros((kv * dh,), dtype=dt, device=device)
    return p


def qkv_project(
    p: Params, x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B,S,D) -> q (B,S,H,Dh), k/v (B,S,KV,Dh), RoPE applied."""
    b, s, _ = x.shape   # unpacked as JAX does: a (B,S,K,D) input raises its ValueError
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = unflatten(q, 2, (cfg.n_heads, cfg.d_head))
    k = unflatten(k, 2, (cfg.n_kv_heads, cfg.d_head))
    v = unflatten(v, 2, (cfg.n_kv_heads, cfg.d_head))
    return apply_rope(cfg, q, positions), apply_rope(cfg, k, positions), v


def _sdpa_on_shards(q, k, v, q_pos, kv_pos, kv_valid, cfg: ModelConfig, window: int):
    """``_sdpa_reference`` of DTensors, run on each rank's shards.

    Attention is local once its inputs are placed so: per mesh dim, the
    batch sharded alike everywhere; q's sequence sharded (context
    parallel) with the keys whole; or q's heads sharded, with K/V's heads
    sharded alike where they divide, else whole and each rank taking the
    KV heads of its query heads. Any other placement of q is gathered.
    Where K/V are whole but q is cut, each rank's share of their gradient
    is summed. Run as DTensor operators, the einsums' internal flattening
    of two sharded dims is refused by some DTensor versions.

    A cache's K/V may have their slots sharded (a decode cache whose KV
    heads do not divide the model axis, or a long sequence's slots over
    data): there q is whole, each rank scores its own slots and the
    softmax is split (``_sdpa_split``) rather than the cache gathered."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = q.device_mesh
    h, kvh = q.shape[2], k.shape[2]
    g = h // kvh
    split = [i for i, p in enumerate(k.placements)
             if isinstance(p, Shard) and p.dim % k.ndim == 1] if is_dtensor(k) else []
    pq, pkv, ppos_q, ppos_kv, gkv = [], [], [], [], []
    kv_lo, kv_n = 0, kvh   # the local KV heads to take (all of a sharded K/V's)
    for i, p in enumerate(q.placements):
        size = mesh.size(i)
        if i in split:
            pq.append(Replicate())
            pkv.append(Shard(1))
            gkv.append(Shard(1))
            ppos_q.append(Replicate())
            ppos_kv.append(Shard(1))
            continue
        if isinstance(p, Shard) and p.dim in (0, 1, 2) and q.shape[p.dim] % size == 0:
            pq.append(p)
        else:
            pq.append(Replicate())
        d = pq[-1].dim if isinstance(pq[-1], Shard) else None
        kv_shard = d == 0 or (d == 2 and kvh % size == 0)
        if d == 2 and kv_shard:
            kv_n = kvh // size
        pkv.append(Shard(d) if kv_shard else Replicate())
        gkv.append(pkv[-1] if kv_shard or d is None else Partial())
        ppos_q.append(Shard(d) if d in (0, 1) else Replicate())
        ppos_kv.append(Shard(0) if d == 0 else Replicate())
        if d == 2 and not kv_shard:   # this rank's query heads -> their KV heads
            h_loc = h // size
            r = mesh.get_local_rank(i)
            assert h_loc % g == 0 or g % h_loc == 0, (h, kvh, size)
            kv_lo, kv_n = (r * h_loc) // g, max(1, h_loc // g)

    k_l, v_l = (local_shard(t, mesh, pkv, gkv)[:, :, kv_lo:kv_lo + kv_n] for t in (k, v))
    args = (local_shard(q, mesh, pq), k_l, v_l, local_shard(q_pos, mesh, ppos_q),
            local_shard(kv_pos, mesh, ppos_kv), local_shard(kv_valid, mesh, ppos_kv), cfg, window)
    out = _sdpa_split(*args, mesh=mesh, dims=split) if split else _sdpa_reference(*args)
    return from_shards(out, mesh, pq)


def _masked_logits(q, k, q_pos, kv_pos, kv_valid, cfg: ModelConfig, window: int):
    """Scaled, softcapped GQA logits (B,KV,G,S,T) in f32 with causality and
    the window on positions; masked logits take NEG_INF (-1e30), never
    -inf."""
    h, dh = q.shape[2:]
    kvh = k.shape[2]
    q5 = q.reshape(q.shape[:2] + (kvh, h // kvh, dh))
    scale = 1.0 / np.sqrt(dh)
    logits = torch.einsum("bskgd,btkd->bkgst", q5.float(), k.float()) * scale
    logits = softcap(logits, cfg.attn_softcap)
    causal = kv_pos[:, None, :] <= q_pos[:, :, None]            # (B,S,T)
    mask = causal & kv_valid[:, None, :]
    if window > 0:
        mask = mask & (q_pos[:, :, None] - kv_pos[:, None, :] < window)
    return torch.where(mask[:, None, None], logits, torch.full_like(logits, NEG_INF))


def _sdpa_split(q, k, v, q_pos, kv_pos, kv_valid, cfg: ModelConfig, window: int, *,
                mesh, dims):
    """``_sdpa_reference`` over keys whose slots are cut over the mesh dims
    ``dims`` (each rank holds its slots of K/V/kv_pos and the whole q):
    each rank's logits take the all-reduced MAX as the softmax's shift,
    and its (acc, l) = (p @ v, sum p) are all-reduced by SUM, in f32.
    Exact up to rounding, as GSPMD's partitioned softmax. A rank with no
    valid slot has every logit at -1e30, so its p is exp(-1e30 - max) = 0
    wherever any rank has a valid slot; where none has, every p is 1 and
    the output is the mean of V, as the unsplit softmax gives."""
    logits = _masked_logits(q, k, q_pos, kv_pos, kv_valid, cfg, window)
    m = all_reduce(logits.amax(dim=-1, keepdim=True), "max", mesh, dims)
    p = torch.exp(logits - m)
    acc = torch.einsum("bkgst,btkd->bkgsd", p, v.float())
    stats = all_reduce(torch.cat([acc, p.sum(dim=-1, keepdim=True)], dim=-1), "sum", mesh,
                       dims)
    out = stats[..., :-1] / stats[..., -1:]                     # (B,KV,G,S,Dh)
    return out.permute(0, 3, 1, 2, 4).reshape(q.shape).to(q.dtype)


def _sdpa_reference(
    q: torch.Tensor,         # (B,S,H,Dh)
    k: torch.Tensor,         # (B,T,KV,Dh)
    v: torch.Tensor,         # (B,T,KV,Dh)
    q_pos: torch.Tensor,     # (B,S)
    kv_pos: torch.Tensor,    # (B,T)
    kv_valid: torch.Tensor,  # (B,T) bool
    cfg: ModelConfig,
    window: int,
) -> torch.Tensor:
    """Masked GQA SDPA in f32; causality and window on positions. Masked
    logits take NEG_INF (-1e30), never -inf. DTensors run on their shards
    (``_sdpa_on_shards``)."""
    if is_dtensor(q):
        return _sdpa_on_shards(q, k, v, q_pos, kv_pos, kv_valid, cfg, window)
    logits = _masked_logits(q, k, q_pos, kv_pos, kv_valid, cfg, window)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.float())
    return out.reshape(q.shape).to(q.dtype)


def attention_forward(
    p: Params,
    x: torch.Tensor,                       # (B,S,D)
    positions: torch.Tensor,               # (B,S), or (3,B,S) for M-RoPE
    cfg: ModelConfig,
    window: int = 0,
    seq_valid: Optional[torch.Tensor] = None,  # (B,S) bool
    return_kv: bool = False,
):
    """Full-sequence self-attention (prefill and training). With
    ``return_kv``, also returns the rotated K and V (for cache seeding).
    The kernel path is ``kernels.flash_attention`` (K4)."""
    q, k, v = qkv_project(p, x, positions, cfg)
    # logical sharding: context-parallel q (seq over model) when heads can't
    # shard; K/V stay seq-replicated
    q = constrain(q, "batch", "seq", "heads", None)
    k = constrain(k, "batch", None, "kv_heads", None)
    v = constrain(v, "batch", None, "kv_heads", None)
    q_pos = pos1d(positions)
    b, s = q_pos.shape
    valid = (
        seq_valid if seq_valid is not None
        else torch.ones((b, s), dtype=torch.bool, device=x.device)
    )
    if cfg.attn_impl != "reference":
        from ..kernels.flash_attention import ops as flash_ops

        out = flash_ops.flash_attention(
            q, k, v, q_pos, q_pos, valid, window=window, softcap=cfg.attn_softcap,
        )
    else:
        out = _sdpa_reference(q, k, v, q_pos, q_pos, valid, cfg, window)
    out = flatten(out, 2, 2) @ p["wo"]
    if return_kv:
        return out, k, v
    return out


def _project_q_step(
    p: Params, x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig
) -> torch.Tensor:
    """Rope'd query for the current decode token: (B,1,D) -> (B,1,H,Dh)."""
    q = x @ p["wq"]
    if cfg.qkv_bias:
        q = q + p["bq"]
    return apply_rope(cfg, unflatten(q, 2, (cfg.n_heads, cfg.d_head)), positions)


def project_kv_step(
    p: Params, x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K/V for the current decode token (to be inserted into the cache)."""
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        k, v = k + p["bk"], v + p["bv"]
    k = unflatten(k, 2, (cfg.n_kv_heads, cfg.d_head))
    v = unflatten(v, 2, (cfg.n_kv_heads, cfg.d_head))
    return apply_rope(cfg, k, positions), v


def attention_decode(
    p: Params,
    x: torch.Tensor,           # (B,1,D) — the single new token
    positions: torch.Tensor,   # (B,1) or (3,B,1)
    k_cache: torch.Tensor,     # (B,T,KV,Dh) — already includes this token
    v_cache: torch.Tensor,
    kv_pos: torch.Tensor,      # (B,T) absolute positions per slot
    kv_valid: torch.Tensor,    # (B,T)
    cfg: ModelConfig,
    window: int = 0,
) -> torch.Tensor:
    """Single-step decode against a linear cache, full or ring (``kv_pos``
    gives each slot's position, so a ring's slots need no order). The
    kernel path is ``kernels.decode_attention`` (K5)."""
    q_pos = pos1d(positions)
    q = _project_q_step(p, x, positions, cfg)
    if cfg.attn_impl != "reference":
        from ..kernels.decode_attention import ops as decode_ops

        out = decode_ops.decode_attention(
            q, k_cache, v_cache, q_pos, kv_pos, kv_valid,
            window=window, softcap=cfg.attn_softcap,
        )
    else:
        out = _sdpa_reference(q, k_cache, v_cache, q_pos, kv_pos, kv_valid, cfg, window)
    return flatten(out, 2, 2) @ p["wo"]


def attention_decode_paged(
    p: Params,
    x: torch.Tensor,           # (B,1,D) — the single new token
    positions: torch.Tensor,   # (B,1) or (3,B,1)
    pool_k: torch.Tensor,      # (P, ps, KV, Dh) — shared page pool, one layer
    pool_v: torch.Tensor,
    page_table: torch.Tensor,  # (B, MP) physical page ids per lane
    kv_pos: torch.Tensor,      # (B, MP*ps) absolute positions per virtual slot
    cfg: ModelConfig,
    window: int = 0,
    lin_k: Optional[torch.Tensor] = None,  # (B, MP*ps, KV, Dh) pre-gathered view
    lin_v: Optional[torch.Tensor] = None,
    shared_pages: Optional[torch.Tensor] = None,  # (S,) common leading pages
) -> torch.Tensor:
    """Page-table-aware decode. The kernel path attends through the page
    table (``kernels.paged_attention``: K1, and with ``shared_pages`` the
    cascade K2 then K1 over each lane's suffix); the reference path gathers
    the lane's pages into the linear view (or takes the caller's hoisted
    ``lin_k``/``lin_v``) and runs the position-masked SDPA — it reads each
    page once per lane anyway and ignores ``shared_pages``, as in JAX."""
    if cfg.attn_impl != "reference":
        from ..kernels.paged_attention import ops as paged_ops

        b = x.shape[0]
        q = _project_q_step(p, x, positions, cfg)
        out = paged_ops.paged_attention(
            q, pool_k, pool_v, page_table, pos1d(positions), kv_pos, shared_pages,
            window=window, softcap=cfg.attn_softcap,
        )
        return out.reshape(b, 1, cfg.n_heads * cfg.d_head) @ p["wo"]

    from .cache import gather_pages

    ck = lin_k if lin_k is not None else gather_pages(pool_k, page_table)
    cv = lin_v if lin_v is not None else gather_pages(pool_v, page_table)
    return attention_decode(p, x, positions, ck, cv, kv_pos, kv_pos >= 0, cfg, window=window)


def attention_append(
    p: Params,
    x: torch.Tensor,           # (B,S,D) — a chunk of new tokens
    positions: torch.Tensor,   # (B,S) absolute positions, p0 + arange(S); (3,B,S) M-RoPE
    p0: int,                   # the chunk's first position, on the host
    k_cache: torch.Tensor,     # (B,T,KV,Dh) full cache (slot == position)
    v_cache: torch.Tensor,
    kv_pos: torch.Tensor,      # (B,T) — already updated for this chunk
    cfg: ModelConfig,
    window: int = 0,
) -> torch.Tensor:
    """Multi-token decode: S new tokens mid-sequence attend against a full
    cache holding the prior prefix. The chunk's rotated K/V are written
    into the cache at their absolute positions (in place, slots past the
    cache dropped) *before* attention, so intra-chunk causality falls out
    of the position mask. The kernel path is ``kernels.flash_attention``
    (K4). Returns the attention output (B,S,D)."""
    from .cache import write_chunk

    b, s, _ = x.shape
    q_pos = pos1d(positions)
    q, k, v = qkv_project(p, x, positions, cfg)
    write_chunk(k_cache, k, p0)
    write_chunk(v_cache, v, p0)
    kv_valid = kv_pos >= 0
    if cfg.attn_impl != "reference":
        from ..kernels.flash_attention import ops as flash_ops

        out = flash_ops.flash_attention(
            q, k_cache, v_cache, q_pos, kv_pos, kv_valid,
            window=window, softcap=cfg.attn_softcap,
        )
    else:
        out = _sdpa_reference(q, k_cache, v_cache, q_pos, kv_pos, kv_valid, cfg, window)
    return out.reshape(b, s, cfg.n_heads * cfg.d_head) @ p["wo"]


def attention_chunk_paged(
    p: Params,
    x: torch.Tensor,           # (B,S,D) — a chunk of prompt tokens
    positions: torch.Tensor,   # (B,S) absolute positions, or (3,B,S) for M-RoPE
    valid: torch.Tensor,       # (B,S) bool — False for bucket padding
    pool_k: torch.Tensor,      # (P, ps, KV, Dh) — shared page pool, one layer
    pool_v: torch.Tensor,
    page_table: torch.Tensor,  # (B, MP) physical page ids per lane
    p0: torch.Tensor,          # (B,) absolute position of chunk row 0
    true_len: torch.Tensor,    # (B,) real chunk lengths
    cfg: ModelConfig,
    window: int = 0,
    n_skip: int = 0,
    lin_k: Optional[torch.Tensor] = None,  # (B, MP*ps, KV, Dh) pre-gathered view
    lin_v: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Chunked paged prefill: the chunk's K/V are written straight into
    their page cells (in place, before attention — intra-chunk causality
    falls out of the positional mask), then the chunk attends through the
    page table. The kernel path is ``kernels.chunked_prefill`` (K3); the
    reference path inserts the chunk into the caller's pre-scatter gathered
    view (same drop set as the pool write) and runs the position-masked
    SDPA with slot ``t`` valid exactly when ``t < p0 + true_len``. Returns
    the attention output (B,S,D)."""
    from .cache import gather_pages, paged_write_chunk

    b, s, _ = x.shape
    ps = pool_k.shape[1]
    q, k, v = qkv_project(p, x, positions, cfg)
    positions = pos1d(positions)
    ck = cv = None
    if cfg.attn_impl == "reference":
        # the linear view must be taken before this chunk's pool write
        ck = lin_k if lin_k is not None else gather_pages(pool_k, page_table)
        cv = lin_v if lin_v is not None else gather_pages(pool_v, page_table)
    paged_write_chunk(pool_k, pool_v, k, v, positions, valid, page_table, ps, n_skip=n_skip)
    if cfg.attn_impl != "reference":
        from ..kernels.chunked_prefill import ops as chunk_ops

        out = chunk_ops.chunked_prefill_attention(
            q, pool_k, pool_v, page_table, p0, true_len,
            window=window, softcap=cfg.attn_softcap,
        )
        return out.reshape(b, s, cfg.n_heads * cfg.d_head) @ p["wo"]

    t = ck.shape[1]
    # mirror the pool write's drop set on the linear view: padding rows and
    # shared-page slots are not inserted (a host-synchronising mask is fine
    # on this reference path)
    keep = valid & (positions >= n_skip * ps) & (positions < t) & (positions >= 0)
    bi, si = torch.nonzero(keep, as_tuple=True)
    slots = positions[bi, si].long()
    ck[bi, slots] = k[bi, si].to(ck.dtype)
    cv[bi, slots] = v[bi, si].to(cv.dtype)
    slot = torch.arange(t, dtype=torch.int32, device=x.device)[None, :]
    kv_valid = slot < (p0 + true_len)[:, None]
    kv_pos = torch.where(kv_valid, slot, torch.full_like(slot, -1))
    out = _sdpa_reference(q, ck, cv, positions, kv_pos, kv_valid, cfg, window)
    return out.reshape(b, s, cfg.n_heads * cfg.d_head) @ p["wo"]
