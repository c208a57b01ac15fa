"""Prefill — the PyTorch counterpart of ``repro.models.prefill``: the full
prefill that seeds full caches, ring caches and SSM state (``prefill``;
dense, moe, gemma_pair, mamba and zamba groups), the chunk append into
existing full caches (``prefill_append``, session-level KV reuse on the
dense route), and the paged route's chunked prefill straight into KV
pages (``prefill_chunk_paged``); the last two for full-cache dense and moe
groups only.
Caches and pools are written in place. A moe layer's experts see every row
of the call — bucket padding included — as in JAX, so the same rows fill
the experts' capacity."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from .attention import attention_append, attention_chunk_paged, attention_forward
from .cache import (
    Cache,
    append_kv_pos,
    gather_pages_stacked,
    prefill_kv_pos,
    ring_from_prefill,
    trim_kv_pos,
)
from .config import ModelConfig
from .layers import (
    Params,
    dtype_of,
    embed_tokens,
    mlp_forward,
    rms_norm,
    text_positions,
    unembed,
)
from .moe import moe_forward
from .pjit_rules import from_shards, is_dtensor, local_shard, placement_span, placements
from .transformer import (
    _mamba_block_full,
    default_positions,
    embed_inputs,
    layer_groups,
    make_decode_caches,
    pair_windows,
)


def supports_append(cfg: ModelConfig) -> bool:
    """Incremental and chunked paged prefill need full-cache (slot ==
    position) dense or moe groups: SSM and hybrid state cannot be extended
    in place the same way (as in JAX)."""
    if cfg.attn_variant != "full":
        return False
    try:
        return all(spec.kind in ("dense", "moe") for spec in layer_groups(cfg))
    except NotImplementedError:
        return False


def _dense_block_prefill(
    bp: Params, x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig,
    window: int, seq_valid: Optional[torch.Tensor],
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    h, k, v = attention_forward(
        bp["attn"], rms_norm(x, bp["norm1"], cfg.norm_eps), positions, cfg,
        window=window, seq_valid=seq_valid, return_kv=True,
    )
    x = x + h
    x = x + mlp_forward(bp["mlp"], rms_norm(x, bp["norm2"], cfg.norm_eps), cfg)
    return x, k, v


def _moe_block_prefill(
    bp: Params, x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig,
    window: int, seq_valid: Optional[torch.Tensor],
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    h, k, v = attention_forward(
        bp["attn"], rms_norm(x, bp["norm1"], cfg.norm_eps), positions, cfg,
        window=window, seq_valid=seq_valid, return_kv=True,
    )
    x = x + h
    m, _ = moe_forward(bp["moe"], rms_norm(x, bp["norm2"], cfg.norm_eps), cfg)
    return x + m, k, v


def _pack_attn_cache(
    ks: List[torch.Tensor], vs: List[torch.Tensor], slots: int, ring: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A group's per-layer prefill K/V (B, S, KV, Dh) placed into a cache of
    ``slots`` slots (``repro.models.prefill._pack_attn_cache``): packed into
    ring order when ``ring`` and the sequence is longer than the ring
    (``ring_from_prefill``), else at slot == position with the rest zero.
    Returns (k, v (L, B, slots, KV, Dh), kv_pos (B, slots))."""
    b, s = ks[0].shape[:2]
    dev = ks[0].device
    packed = ring and slots < s
    if not packed and slots < s:
        raise ValueError(f"prefill of {s} tokens into {slots} slots")
    shape = (len(ks), b, slots) + tuple(ks[0].shape[2:])
    ck = torch.zeros(shape, dtype=ks[0].dtype, device=dev)
    cv = torch.zeros(shape, dtype=vs[0].dtype, device=dev)
    for i, (k, v) in enumerate(zip(ks, vs)):
        if packed:
            ck[i], cv[i] = ring_from_prefill(k, slots), ring_from_prefill(v, slots)
        else:
            ck[i, :, :s], cv[i, :, :s] = k, v
    return ck, cv, prefill_kv_pos(b, slots, s, dev, packed)


def _mesh_cache_specs(cfg: ModelConfig, x: torch.Tensor, max_len: int):
    """(mesh, per-group cache specs) for a prefill whose activations ``x``
    are DTensors, else None: ``launch.sharding.cache_specs`` on ``x``'s
    mesh, as the dry-run places a decode step's caches (slots over data
    for a single sequence, B = 1; else the batch), so a ``decode_step``
    follows without a redistribution. JAX computes none: GSPMD
    propagates."""
    if not is_dtensor(x):
        return None
    from ..launch.sharding import cache_specs

    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    b = x.shape[0]
    abstract = make_decode_caches(cfg, b, max_len, device="meta")
    return mesh, cache_specs(cfg, abstract, "pod" in names,
                             model_size=mesh.size(names.index("model")), seq_shard=b == 1)


def _pack_on_shards(
    ks: List[torch.Tensor], vs: List[torch.Tensor], slots: int, ring: bool, specs: Dict, mesh,
) -> Cache:
    """``_pack_attn_cache`` of DTensor K/V, built on each rank's shards in
    the placements of ``specs`` (``cache_specs``' k / v / kv_pos): each
    layer's K/V are redistributed to the cache's batch and head
    placements with the sequence whole, and each rank packs the slots of
    its own range."""
    from torch.distributed.tensor import Replicate, Shard

    b, s = ks[0].shape[:2]
    packed = ring and slots < s
    if not packed and slots < s:
        raise ValueError(f"prefill of {s} tokens into {slots} slots")
    pl = placements(specs["k"], mesh)                      # (L, B, T, KV, Dh)
    src = [Shard(p.dim - 1) if isinstance(p, Shard) and p.dim != 2 else Replicate() for p in pl]
    span = placement_span(slots, 2, pl, mesh)
    cache = {name: from_shards(torch.stack([
        ring_from_prefill(local_shard(t, mesh, src), slots, span) for t in ts]), mesh, pl)
        for name, ts in (("k", ks), ("v", vs))}
    ppos = placements(specs["kv_pos"], mesh)                # (B, T)
    _, b_loc = placement_span(b, 0, ppos, mesh)
    kv_pos = prefill_kv_pos(b_loc, slots, s, ks[0].device, packed,
                            span=placement_span(slots, 1, ppos, mesh))
    cache["kv_pos"] = from_shards(kv_pos, mesh, ppos)
    return cache


def _attn_cache(
    ks: List[torch.Tensor], vs: List[torch.Tensor], slots: int, ring: bool, on_mesh,
    specs: Optional[Dict],
) -> Cache:
    """A group's attention cache from its layers' prefill K/V: packed on
    the shards on a mesh (``on_mesh`` = (mesh, specs)), else
    ``_pack_attn_cache``."""
    if on_mesh is not None:
        return _pack_on_shards(ks, vs, slots, ring, specs, on_mesh[0])
    ck, cv, kv_pos = _pack_attn_cache(ks, vs, slots, ring)
    return {"k": ck, "v": cv, "kv_pos": kv_pos}


def _ssm_cache(hs: List[torch.Tensor], convs: List[torch.Tensor], on_mesh,
               specs: Optional[Dict]) -> Cache:
    """A group's SSM cache from its layers' final states and conv windows,
    stacked; on a mesh in the placements of ``specs`` (``cache_specs``'
    h / conv)."""
    if on_mesh is None:
        return {"h": torch.stack(hs), "conv": torch.stack(convs)}
    from torch.distributed.tensor import Shard

    mesh = on_mesh[0]
    out = {}
    for name, ts in (("h", hs), ("conv", convs)):
        pl = placements(specs[name], mesh)
        per = [Shard(p.dim - 1) if isinstance(p, Shard) else p for p in pl]
        out[name] = from_shards(torch.stack([local_shard(t, mesh, per) for t in ts]), mesh, pl)
    return out


def prefill(
    params: Dict,
    cfg: ModelConfig,
    tokens: torch.Tensor,                         # (B,S), or (B,S,K) audio
    max_len: int,
    positions: Optional[torch.Tensor] = None,     # (B,S), or (3,B,S) for mrope
    patch_embeds: Optional[torch.Tensor] = None,  # (B,P,D) VLM stub frontend
    seq_valid: Optional[torch.Tensor] = None,     # (B,S) bool
    true_len: Optional[torch.Tensor] = None,      # (B,) real lengths (bucketed input)
) -> Tuple[torch.Tensor, List[Cache], torch.Tensor]:
    """Full prefill of a sequence into fresh caches
    (``repro.models.prefill.prefill``): returns (last-position logits
    (B,V), or (B,K,V) for K audio codebooks, caches, next_pos (B,)).
    ``positions`` default to 0..S-1 (every
    M-RoPE stream the same), and a VLM's ``patch_embeds`` overwrite the
    first rows of the embeddings, as in ``forward_full``. Attention K/V
    fill slots [0, S) of ``max_len``-slot full caches and the rest stay
    zero; a ring cache (a gemma pair's local layers, and every attention
    layer of the sliding-window variant: the window's slots, at most
    ``max_len``) keeps the last positions at slot = position % slots
    (``_pack_attn_cache``); a mamba layer's cache is its final SSM state
    and conv window. With ``true_len`` the input is right-padded to a
    bucket length (``seq_valid`` is then ``arange(S) < true_len``) and
    logits/next_pos refer to position ``true_len - 1``. On a device mesh (parameters and inputs as
    DTensors) the caches come back as DTensors in
    ``launch.sharding.cache_specs``' placements (``_mesh_cache_specs``),
    each built on the ranks' shards. As in JAX, the
    padding is masked out of attention, and a dense or moe group's kv_pos
    is valid below ``true_len`` only (such a group needs full caches); but
    a mamba layer runs its SSM over the padded rows too (so its state has
    absorbed them), and the kv_pos of a zamba group and of a gemma pair is
    not trimmed: their padded slots lie after every decode query and are
    overwritten before a query reaches them, but a gemma local ring whose
    padded length exceeds the window has kept padded positions in place of
    real ones (ROADMAP, Queue 3 R7). With the kernels, attention is K4 and
    every mamba layer's SSD is K6."""
    groups = layer_groups(cfg)
    b, s = tokens.shape[:2]
    dev = tokens.device
    idx = torch.arange(s, dtype=torch.int32, device=dev)
    if true_len is not None:
        seq_valid = idx[None, :] < true_len[:, None]
    if positions is None:
        positions = default_positions(cfg, tokens)
    x = embed_inputs(params, cfg, tokens, patch_embeds)
    sw = cfg.sliding_window or 8192
    ring = cfg.attn_variant == "sliding_window"
    on_mesh = _mesh_cache_specs(cfg, x, max_len)
    caches: List[Cache] = []
    for gi, (spec, gp) in enumerate(zip(groups, params["groups"])):
        gspec = on_mesh[1][gi] if on_mesh is not None else None
        if spec.kind == "mamba":
            hs, convs = [], []
            for bp in gp:
                x, final, conv = _mamba_block_full(bp, x, cfg)
                hs.append(final)
                convs.append(conv)
            caches.append(_ssm_cache(hs, convs, on_mesh, gspec))
            continue
        if spec.kind == "zamba":
            hs, convs, ks, vs = [], [], [], []
            for group in gp:
                for bp in group:
                    x, final, conv = _mamba_block_full(bp, x, cfg)
                    hs.append(final)
                    convs.append(conv)
                x, k, v = _dense_block_prefill(
                    params["shared_attn"], x, positions, cfg, sw if ring else 0, seq_valid
                )
                ks.append(k)
                vs.append(v)
            caches.append({
                "ssm": _ssm_cache(hs, convs, on_mesh, gspec and gspec["ssm"]),
                "attn": _attn_cache(ks, vs, min(sw, max_len) if ring else max_len, ring,
                                    on_mesh, gspec and gspec["attn"]),
            })
            continue
        if spec.kind == "gemma_pair":
            local_w, global_w = pair_windows(cfg)
            lks, lvs, gks, gvs = [], [], [], []
            for bp in gp:
                x, k, v = _dense_block_prefill(bp["local"], x, positions, cfg, local_w,
                                               seq_valid)
                lks.append(k)
                lvs.append(v)
                x, k, v = _dense_block_prefill(bp["global"], x, positions, cfg, global_w,
                                               seq_valid)
                gks.append(k)
                gvs.append(v)
            caches.append({
                "local": _attn_cache(lks, lvs, min(cfg.sliding_window, max_len), True, on_mesh,
                                     gspec and gspec["local"]),
                "global": _attn_cache(gks, gvs, min(sw, max_len) if ring else max_len, ring,
                                      on_mesh, gspec and gspec["global"]),
            })
            continue
        w = cfg.window_for_layer(0)
        block = _dense_block_prefill if spec.kind == "dense" else _moe_block_prefill
        ks, vs = [], []
        for bp in gp:
            x, k, v = block(bp, x, positions, cfg, w, seq_valid)
            ks.append(k)
            vs.append(v)
        cache = _attn_cache(ks, vs, min(sw, max_len) if ring else max_len, ring, on_mesh, gspec)
        if true_len is not None:
            assert not ring, "bucketed prefill needs full caches"
            cache["kv_pos"] = trim_kv_pos(cache["kv_pos"], true_len)
        caches.append(cache)
    bi = torch.arange(b, device=dev)
    if true_len is not None:
        last = x[bi, true_len.long() - 1][:, None, :]
        return unembed(params["embed"], last, cfg)[:, 0], caches, true_len.to(torch.int32)
    logits = unembed(params["embed"], x[:, -1:, :], cfg)
    return logits[:, 0], caches, torch.full((b,), s, dtype=torch.int32, device=dev)


def _dense_block_append(
    bp: Params, x: torch.Tensor, positions: torch.Tensor, p0: int, ck: torch.Tensor,
    cv: torch.Tensor, kv_pos: torch.Tensor, cfg: ModelConfig, window: int,
) -> torch.Tensor:
    h = attention_append(
        bp["attn"], rms_norm(x, bp["norm1"], cfg.norm_eps), positions, p0,
        ck, cv, kv_pos, cfg, window=window,
    )
    x = x + h
    return x + mlp_forward(bp["mlp"], rms_norm(x, bp["norm2"], cfg.norm_eps), cfg)


def _moe_block_append(
    bp: Params, x: torch.Tensor, positions: torch.Tensor, p0: int, ck: torch.Tensor,
    cv: torch.Tensor, kv_pos: torch.Tensor, cfg: ModelConfig, window: int,
) -> torch.Tensor:
    h = attention_append(
        bp["attn"], rms_norm(x, bp["norm1"], cfg.norm_eps), positions, p0,
        ck, cv, kv_pos, cfg, window=window,
    )
    x = x + h
    m, _ = moe_forward(bp["moe"], rms_norm(x, bp["norm2"], cfg.norm_eps), cfg)
    return x + m


def prefill_append(
    params: Dict,
    cfg: ModelConfig,
    caches: List[Cache],
    tokens: torch.Tensor,                       # (B,S) new-token chunk, or (B,S,K)
    p0: int,                                    # every lane's start offset
    true_len: Optional[torch.Tensor] = None,    # (B,) real chunk lengths
) -> Tuple[torch.Tensor, List[Cache], torch.Tensor]:
    """Prefill a token chunk starting at position ``p0`` into *existing*
    full caches (``repro.models.prefill.prefill_append``, whose ``p0`` is
    a (B,) array; here every caller appends one offset the host knows), in
    place: K/V land in slots ``[p0, p0 + S)`` (slots past the cache dropped),
    ``kv_pos`` is extended (padded rows write -1), and the chunk attends
    against every prior valid slot — a returning session computes only its
    new tokens. Returns (last-valid-position logits (B,V) or (B,K,V), caches,
    next_pos (B,)). A caller that must keep the caches it passes (a pool
    entry) passes a copy. With the kernels, attention is K4."""
    if not supports_append(cfg):
        raise NotImplementedError(
            f"prefill_append requires full-cache dense/moe groups ({cfg.name})"
        )
    b, s = tokens.shape[:2]
    dev = tokens.device
    idx = torch.arange(s, dtype=torch.int32, device=dev)
    q_pos = (p0 + idx)[None, :].expand(b, s)                           # (B,S)
    valid = (
        idx[None, :] < true_len[:, None] if true_len is not None
        else torch.ones((b, s), dtype=torch.bool, device=dev)
    )
    positions = text_positions(cfg, q_pos)
    x = embed_tokens(params["embed"], tokens, cfg).to(dtype_of(cfg.compute_dtype))
    for spec, gp, cache in zip(layer_groups(cfg), params["groups"], caches):
        append_kv_pos(cache["kv_pos"], p0, valid)
        w = cfg.window_for_layer(0)
        block = _dense_block_append if spec.kind == "dense" else _moe_block_append
        for i, bp in enumerate(gp):
            x = block(
                bp, x, positions, p0, cache["k"][i], cache["v"][i], cache["kv_pos"], cfg, w,
            )
    n_new = (
        true_len.to(torch.int32) if true_len is not None
        else torch.full((b,), s, dtype=torch.int32, device=dev)
    )
    last = x[torch.arange(b, device=dev), n_new.long() - 1][:, None, :]
    logits = unembed(params["embed"], last, cfg)
    return logits[:, 0], caches, p0 + n_new


def _dense_block_chunk_paged(
    bp: Params, x: torch.Tensor, positions: torch.Tensor, valid: torch.Tensor,
    pk: torch.Tensor, pv: torch.Tensor, page_table: torch.Tensor, p0: torch.Tensor,
    true_len: torch.Tensor, cfg: ModelConfig, n_skip: int,
    lin_k: Optional[torch.Tensor] = None, lin_v: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    h = attention_chunk_paged(
        bp["attn"], rms_norm(x, bp["norm1"], cfg.norm_eps), positions, valid,
        pk, pv, page_table, p0, true_len, cfg, n_skip=n_skip, lin_k=lin_k, lin_v=lin_v,
    )
    x = x + h
    return x + mlp_forward(bp["mlp"], rms_norm(x, bp["norm2"], cfg.norm_eps), cfg)


def _moe_block_chunk_paged(
    bp: Params, x: torch.Tensor, positions: torch.Tensor, valid: torch.Tensor,
    pk: torch.Tensor, pv: torch.Tensor, page_table: torch.Tensor, p0: torch.Tensor,
    true_len: torch.Tensor, cfg: ModelConfig, n_skip: int,
    lin_k: Optional[torch.Tensor] = None, lin_v: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    h = attention_chunk_paged(
        bp["attn"], rms_norm(x, bp["norm1"], cfg.norm_eps), positions, valid,
        pk, pv, page_table, p0, true_len, cfg, n_skip=n_skip, lin_k=lin_k, lin_v=lin_v,
    )
    x = x + h
    m, _ = moe_forward(bp["moe"], rms_norm(x, bp["norm2"], cfg.norm_eps), cfg)
    return x + m


def prefill_chunk_paged(
    params: Dict,
    cfg: ModelConfig,
    pools: List[Cache],          # per group: {"k","v"} (L, P, ps, KV, Dh)
    page_table: torch.Tensor,    # (B, MP) physical page ids per lane
    tokens: torch.Tensor,        # (B, S) prompt chunk (bucketed), or (B, S, K)
    p0: torch.Tensor,            # (B,) absolute position of chunk row 0
    true_len: torch.Tensor,      # (B,) real chunk lengths
    n_skip: int = 0,
) -> torch.Tensor:
    """Prefill a prompt chunk directly into KV pages: each layer writes the
    chunk's rotated K/V into page cells through the table (in place) before
    attending, and the chunk attends against the lane's whole causal prefix
    ``[0, p0 + true_len)``. ``n_skip`` leading pages are read-only shared
    pages (writes below ``n_skip * page_size`` are dropped). Rows beyond
    ``true_len`` are bucket padding. Returns the logits at row
    ``true_len - 1``, shape (B, V) (or (B, K, V)). With the kernels each
    layer attends through the page table (K3); the reference path gathers the stack's
    pages once, before any layer writes."""
    if not supports_append(cfg):
        raise NotImplementedError(
            f"prefill_chunk_paged requires full-cache dense/moe groups ({cfg.name})"
        )
    b, s = tokens.shape[:2]
    idx = torch.arange(s, dtype=torch.int32, device=tokens.device)
    p0 = p0.to(torch.int32)
    true_len = true_len.to(torch.int32)
    q_pos = p0[:, None] + idx[None, :]                       # (B, S)
    valid = idx[None, :] < true_len[:, None]
    positions = text_positions(cfg, q_pos)
    x = embed_tokens(params["embed"], tokens, cfg).to(dtype_of(cfg.compute_dtype))
    use_kernel = cfg.attn_impl != "reference"
    for spec, gp, pool in zip(layer_groups(cfg), params["groups"], pools):
        block = _dense_block_chunk_paged if spec.kind == "dense" else _moe_block_chunk_paged
        if not use_kernel:
            lin_k, lin_v = gather_pages_stacked(pool["k"], pool["v"], page_table)
        for i, bp in enumerate(gp):
            x = block(
                bp, x, positions, valid, pool["k"][i], pool["v"][i], page_table, p0, true_len,
                cfg, n_skip,
                None if use_kernel else lin_k[i], None if use_kernel else lin_v[i],
            )
    n = torch.clamp(true_len, min=1).long()
    last = x[torch.arange(b, device=x.device), n - 1][:, None, :]
    return unembed(params["embed"], last, cfg)[:, 0]
