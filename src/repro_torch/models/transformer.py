"""Decoder assembly — the PyTorch counterpart of
``repro.models.transformer`` for the ``"dense"``, ``"mamba"`` and
``"zamba"`` layer groups: the full-sequence forward (inference), the dense
route's decode step against full caches and SSM state, and the paged
route's decode step against a page pool (dense groups only).

Parameters are ``{"embed": {...}, "groups": [group, ...]}`` plus, for a
zamba hybrid, ``"shared_attn"`` (one dense block's dict, shared by every
zamba group). A dense or mamba group is a list of per-layer dicts; a zamba
group is a list of ``n_groups`` lists of ``period`` mamba-layer dicts (the
JAX package stacks each group on leading axes and scans it; Python loops
over layers replace ``scan_or_unroll`` here). Caches, pools and ``kv_pos``
are updated in place; the caches keep JAX's stacked layouts (L, B, ...).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

from ..device import DeviceLike, resolve_device
from .attention import (
    attention_decode,
    attention_decode_paged,
    attention_forward,
    init_attention,
    project_kv_step,
)
from .cache import (
    Cache,
    gather_pages_stacked,
    init_attn_cache,
    init_ssm_cache,
    paged_write_step,
    update_kv_pos,
    update_kv_pos_paged,
    write_step,
)
from .config import ModelConfig
from .layers import (
    Params,
    dtype_of,
    embed_tokens,
    init_embed,
    init_mlp,
    init_rms_norm,
    mlp_forward,
    rms_norm,
    unembed,
)
from .ssm import init_ssm, ssm_decode_step, ssm_forward


@dataclass(frozen=True)
class GroupSpec:
    kind: str          # dense | mamba | zamba (the kinds this port serves so far)
    n_blocks: int      # layers (zamba: shared-attention invocations)
    period: int = 0    # zamba: mamba layers per shared-attention invocation


def layer_groups(cfg: ModelConfig) -> List[GroupSpec]:
    """The layer groups of ``cfg``, as in JAX: ``"zamba"`` groups (then any
    remainder of mamba layers) for the zamba hybrid, one ``"mamba"`` group
    for an SSM, one ``"dense"`` group for the uniform dense decoders. The
    JAX package's other kinds (gemma_pair, moe) are not ported yet and
    raise."""
    if cfg.layer_pattern == "zamba_hybrid":
        period = cfg.shared_attn_period
        n_groups, rem = divmod(cfg.n_layers, period)
        groups = [GroupSpec("zamba", n_groups, period)]
        if rem:
            groups.append(GroupSpec("mamba", rem))
        return groups
    if (
        cfg.layer_pattern != "uniform"
        or cfg.arch_type == "hybrid"
        or cfg.n_experts > 0
    ):
        raise NotImplementedError(
            f"{cfg.name}: only uniform dense decoders, SSMs and the zamba hybrid "
            "are ported (ROADMAP, Queue 1 items 7-8)"
        )
    if cfg.arch_type == "ssm":
        return [GroupSpec("mamba", cfg.n_layers)]
    return [GroupSpec("dense", cfg.n_layers)]


def _init_dense_block(cfg: ModelConfig, gen: torch.Generator, device: torch.device) -> Dict:
    dt = dtype_of(cfg.param_dtype)
    return {
        "norm1": init_rms_norm(cfg.d_model, dt, device),
        "attn": init_attention(cfg, gen, device),
        "norm2": init_rms_norm(cfg.d_model, dt, device),
        "mlp": init_mlp(cfg, gen, device),
    }


def _init_mamba_block(cfg: ModelConfig, gen: torch.Generator, device: torch.device) -> Dict:
    dt = dtype_of(cfg.param_dtype)
    return {"norm": init_rms_norm(cfg.d_model, dt, device), "ssm": init_ssm(cfg, gen, device)}


def init_params(cfg: ModelConfig, seed: int = 0, device: DeviceLike = None) -> Dict:
    """Random weights with the JAX package's shapes, dtypes and scales
    (``repro.models.transformer.init_params``), drawn from a seeded
    ``torch.Generator`` on ``device`` (default ``"cuda"``). The draws differ
    from ``jax.random``'s; tests that compare the packages bridge the JAX
    weights with ``models.weights.params_from_numpy`` instead."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params: Dict = {"embed": init_embed(cfg, gen, dev), "groups": []}
    for spec in layer_groups(cfg):
        if spec.kind == "dense":
            group = [_init_dense_block(cfg, gen, dev) for _ in range(spec.n_blocks)]
        elif spec.kind == "mamba":
            group = [_init_mamba_block(cfg, gen, dev) for _ in range(spec.n_blocks)]
        else:   # zamba: (n_groups, period) mamba blocks
            group = [[_init_mamba_block(cfg, gen, dev) for _ in range(spec.period)]
                     for _ in range(spec.n_blocks)]
        params["groups"].append(group)
    if cfg.layer_pattern == "zamba_hybrid":
        params["shared_attn"] = _init_dense_block(cfg, gen, dev)
    return params


def _full_caches_only(cfg: ModelConfig) -> None:
    if cfg.attn_variant != "full":
        raise NotImplementedError(
            f"{cfg.name}: ring caches (attn_variant={cfg.attn_variant!r}) are not "
            "ported (ROADMAP, Queue 1 item 8)"
        )


def _dense_block_full(
    bp: Params, x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig,
    window: int, seq_valid: Optional[torch.Tensor],
) -> torch.Tensor:
    h = attention_forward(
        bp["attn"], rms_norm(x, bp["norm1"], cfg.norm_eps), positions, cfg,
        window=window, seq_valid=seq_valid,
    )
    x = x + h
    return x + mlp_forward(bp["mlp"], rms_norm(x, bp["norm2"], cfg.norm_eps), cfg)


def _mamba_block_full(
    bp: Params, x: torch.Tensor, cfg: ModelConfig,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One mamba layer: returns (x, final SSM state, conv state)."""
    out, final, conv_state = ssm_forward(bp["ssm"], rms_norm(x, bp["norm"], cfg.norm_eps), cfg)
    return x + out, final, conv_state


def _run_zamba_full(
    gp: List[List[Params]], shared_bp: Params, x: torch.Tensor, positions: torch.Tensor,
    cfg: ModelConfig, seq_valid: Optional[torch.Tensor],
) -> torch.Tensor:
    """``period`` mamba layers then the shared attention block, per group."""
    w = 0 if cfg.attn_variant == "full" else (cfg.sliding_window or 8192)
    for group in gp:
        for bp in group:
            x, _, _ = _mamba_block_full(bp, x, cfg)
        x = _dense_block_full(shared_bp, x, positions, cfg, w, seq_valid)
    return x


def forward_full(
    params: Dict,
    cfg: ModelConfig,
    tokens: torch.Tensor,                      # (B,S)
    seq_valid: Optional[torch.Tensor] = None,  # (B,S) bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward for inference (``repro.models.transformer.
    forward_full``) at positions 0..S-1: returns (logits (B,S,V), aux loss
    0 — these groups carry none). With the kernels, attention is K4 and
    every mamba layer's SSD is K6."""
    b, s = tokens.shape
    positions = torch.arange(s, dtype=torch.int32, device=tokens.device)[None].expand(b, s)
    x = embed_tokens(params["embed"], tokens, cfg).to(dtype_of(cfg.compute_dtype))
    for spec, gp in zip(layer_groups(cfg), params["groups"]):
        if spec.kind == "zamba":
            x = _run_zamba_full(gp, params["shared_attn"], x, positions, cfg, seq_valid)
        elif spec.kind == "mamba":
            for bp in gp:
                x, _, _ = _mamba_block_full(bp, x, cfg)
        else:
            w = cfg.window_for_layer(0)  # uniform groups share one window
            for bp in gp:
                x = _dense_block_full(bp, x, positions, cfg, w, seq_valid)
    return unembed(params["embed"], x, cfg), torch.zeros((), dtype=torch.float32)


def make_decode_caches(
    cfg: ModelConfig, batch: int, max_len: int, device: DeviceLike = None,
) -> List[Cache]:
    """Empty caches matching ``layer_groups(cfg)`` on ``device`` (default
    ``"cuda"``): full caches of ``max_len`` slots per lane, SSM state for
    mamba layers, both for a zamba group."""
    _full_caches_only(cfg)
    dev = resolve_device(device)
    caches: List[Cache] = []
    for spec in layer_groups(cfg):
        if spec.kind == "dense":
            caches.append(init_attn_cache(cfg, spec.n_blocks, batch, max_len, dev))
        elif spec.kind == "mamba":
            caches.append(init_ssm_cache(cfg, spec.n_blocks, batch, dev))
        else:
            caches.append({
                "ssm": init_ssm_cache(cfg, spec.n_blocks * spec.period, batch, dev),
                "attn": init_attn_cache(cfg, spec.n_blocks, batch, max_len, dev),
            })
    return caches


def _dense_block_decode(
    bp: Params, x: torch.Tensor, positions: torch.Tensor, cache_k: torch.Tensor,
    cache_v: torch.Tensor, kv_pos: torch.Tensor, kv_valid: torch.Tensor,
    cfg: ModelConfig, window: int,
) -> torch.Tensor:
    """One decode layer against a full cache: write the token's K/V at its
    (clamped) slot, attend, then the MLP. kv_pos is already updated."""
    h_in = rms_norm(x, bp["norm1"], cfg.norm_eps)
    k_new, v_new = project_kv_step(bp["attn"], h_in, positions, cfg)
    write_step(cache_k, cache_v, k_new, v_new, positions[:, 0])
    h = attention_decode(
        bp["attn"], h_in, positions, cache_k, cache_v, kv_pos, kv_valid, cfg, window=window
    )
    x = x + h
    return x + mlp_forward(bp["mlp"], rms_norm(x, bp["norm2"], cfg.norm_eps), cfg)


def _mamba_block_decode(
    bp: Params, x: torch.Tensor, ssm: Cache, i: int, cfg: ModelConfig,
) -> torch.Tensor:
    """One mamba layer's decode step; layer ``i`` of ``ssm`` is updated in
    place."""
    out, st = ssm_decode_step(
        bp["ssm"], rms_norm(x, bp["norm"], cfg.norm_eps),
        {"h": ssm["h"][i], "conv": ssm["conv"][i]}, cfg,
    )
    ssm["h"][i] = st["h"]
    ssm["conv"][i] = st["conv"]
    return x + out


def decode_step(
    params: Dict,
    cfg: ModelConfig,
    caches: List[Cache],         # per group: see make_decode_caches
    tokens: torch.Tensor,        # (B, 1)
    pos: torch.Tensor,           # (B,) absolute position of this token
) -> Tuple[torch.Tensor, List[Cache]]:
    """serve_step against full caches and SSM state (``repro.models.
    transformer.decode_step``): returns (logits (B, 1, V), caches). The
    token's K/V and position land in ``caches`` in place, at slot
    ``min(pos, T - 1)`` (JAX clamps: the full-width server decodes its empty
    lanes too); ``kv_pos`` is updated once per group, before the layer
    loop; each mamba layer's ``h`` and ``conv`` are replaced in place. With
    the kernels each attention layer (dense, or zamba's shared block)
    attends through K5."""
    _full_caches_only(cfg)
    positions = pos[:, None].to(torch.int32)
    x = embed_tokens(params["embed"], tokens, cfg).to(dtype_of(cfg.compute_dtype))
    for spec, gp, cache in zip(layer_groups(cfg), params["groups"], caches):
        if spec.kind == "mamba":
            for i, bp in enumerate(gp):
                x = _mamba_block_decode(bp, x, cache, i, cfg)
            continue
        attn = cache["attn"] if spec.kind == "zamba" else cache
        update_kv_pos(attn["kv_pos"], pos)
        kv_valid = attn["kv_pos"] >= 0
        if spec.kind == "zamba":
            for g, group in enumerate(gp):
                for i, bp in enumerate(group):
                    x = _mamba_block_decode(bp, x, cache["ssm"], g * spec.period + i, cfg)
                x = _dense_block_decode(
                    params["shared_attn"], x, positions, attn["k"][g], attn["v"][g],
                    attn["kv_pos"], kv_valid, cfg, 0,
                )
            continue
        for i, bp in enumerate(gp):
            x = _dense_block_decode(
                bp, x, positions, attn["k"][i], attn["v"][i], attn["kv_pos"], kv_valid, cfg, 0,
            )
    return unembed(params["embed"], x, cfg), caches


def _dense_block_decode_paged(
    bp: Params, x: torch.Tensor, positions: torch.Tensor,
    pool_k: torch.Tensor, pool_v: torch.Tensor, page_table: torch.Tensor,
    kv_pos: torch.Tensor, cfg: ModelConfig, window: int, page_size: int,
    lin_k: Optional[torch.Tensor] = None, lin_v: Optional[torch.Tensor] = None,
    shared_pages: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One paged decode layer: write the token's K/V into its page cell,
    attend through the page table, then the MLP. On the reference path the
    hoisted linear views get the new token inserted at slot == position
    (dropped past their width, like the pool write)."""
    pos = positions[:, 0]
    h_in = rms_norm(x, bp["norm1"], cfg.norm_eps)
    k_new, v_new = project_kv_step(bp["attn"], h_in, positions, cfg)
    paged_write_step(pool_k, pool_v, k_new, v_new, pos, page_table, page_size)
    if lin_k is not None:
        keep = (pos >= 0) & (pos < lin_k.shape[1])
        (bi,) = torch.nonzero(keep, as_tuple=True)
        lin_k[bi, pos[bi].long()] = k_new[bi, 0].to(lin_k.dtype)
        lin_v[bi, pos[bi].long()] = v_new[bi, 0].to(lin_v.dtype)
    h = attention_decode_paged(
        bp["attn"], h_in, positions, pool_k, pool_v, page_table, kv_pos, cfg,
        window=window, lin_k=lin_k, lin_v=lin_v, shared_pages=shared_pages,
    )
    x = x + h
    return x + mlp_forward(bp["mlp"], rms_norm(x, bp["norm2"], cfg.norm_eps), cfg)


def decode_step_paged(
    params: Dict,
    cfg: ModelConfig,
    pools: List[Cache],          # per group: {"k","v"} (L, P, ps, KV, Dh)
    page_table: torch.Tensor,    # (B, MP) physical page ids per lane
    kv_pos: torch.Tensor,        # (B, MP*ps) slot positions, updated in place
    tokens: torch.Tensor,        # (B, 1)
    pos: torch.Tensor,           # (B,) absolute position of this token
    shared_pages: Optional[torch.Tensor] = None,  # (S,) common leading pages
) -> torch.Tensor:
    """serve_step against a paged KV pool (``repro.models.transformer.
    decode_step_paged``): returns the logits (B, 1, V). The token's K/V land
    in ``pools`` and its position in ``kv_pos``, both in place; a lane whose
    position is at or past the table's width (at capacity, or pushed there
    by the batched server for a lane that must not decode) has both
    dropped. ``page_table``/``kv_pos`` may be trimmed to fewer pages than
    the lanes' full width, as long as every decoding lane's tokens fit in
    it (slot == position). With the kernels each layer attends straight
    through the page table (K1), and with ``shared_pages`` — a run of pages
    every lane's table starts with — through the cascade (K2, then K1 over
    each lane's suffix); the reference path ignores ``shared_pages`` and
    gathers the whole stack's pages once per step, before any layer
    writes."""
    positions = pos[:, None].to(torch.int32)
    x = embed_tokens(params["embed"], tokens, cfg).to(dtype_of(cfg.compute_dtype))
    page_size = pools[0]["k"].shape[2]
    update_kv_pos_paged(kv_pos, pos)
    use_kernel = cfg.attn_impl != "reference"
    for spec, gp, pool in zip(layer_groups(cfg), params["groups"], pools):
        if not use_kernel:
            lin_k, lin_v = gather_pages_stacked(pool["k"], pool["v"], page_table)
        for i, bp in enumerate(gp):
            x = _dense_block_decode_paged(
                bp, x, positions, pool["k"][i], pool["v"][i], page_table, kv_pos,
                cfg, 0, page_size,
                None if use_kernel else lin_k[i], None if use_kernel else lin_v[i],
                shared_pages=shared_pages if use_kernel else None,
            )
    return unembed(params["embed"], x, cfg)
