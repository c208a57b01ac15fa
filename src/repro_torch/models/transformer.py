"""Decoder assembly — the PyTorch counterpart of
``repro.models.transformer`` for the ``"dense"`` layer group: the
full-sequence forward (inference), the dense route's decode step against
full caches, and the paged route's decode step against a page pool.

Parameters are ``{"embed": {...}, "groups": [[layer dict, ...], ...]}``:
one list of per-layer dicts per group (the JAX package stacks each group on
a leading L axis and scans it; a Python loop over layers replaces
``scan_or_unroll`` here). Caches, pools and ``kv_pos`` are updated in
place; the caches keep JAX's stacked layout (L, B, T, KV, Dh).
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


@dataclass(frozen=True)
class GroupSpec:
    kind: str          # dense (the only kind this port serves so far)
    n_blocks: int


def layer_groups(cfg: ModelConfig) -> List[GroupSpec]:
    """The layer groups of ``cfg``: one ``"dense"`` group for the uniform
    dense decoders. The JAX package's other kinds (gemma_pair, mamba,
    zamba, moe) are not ported yet and raise."""
    if (
        cfg.layer_pattern != "uniform"
        or cfg.arch_type in ("ssm", "hybrid")
        or cfg.n_experts > 0
    ):
        raise NotImplementedError(
            f"{cfg.name}: only uniform dense decoders are ported "
            "(ROADMAP, Queue 1 items 7-9)"
        )
    return [GroupSpec("dense", cfg.n_layers)]


def _init_dense_block(cfg: ModelConfig, gen: torch.Generator, device: torch.device) -> Dict:
    dt = dtype_of(cfg.param_dtype)
    return {
        "norm1": init_rms_norm(cfg.d_model, dt, device),
        "attn": init_attention(cfg, gen, device),
        "norm2": init_rms_norm(cfg.d_model, dt, device),
        "mlp": init_mlp(cfg, gen, device),
    }


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
        params["groups"].append(
            [_init_dense_block(cfg, gen, dev) for _ in range(spec.n_blocks)]
        )
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


def forward_full(
    params: Dict,
    cfg: ModelConfig,
    tokens: torch.Tensor,                      # (B,S)
    seq_valid: Optional[torch.Tensor] = None,  # (B,S) bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward for inference (``repro.models.transformer.
    forward_full``) at positions 0..S-1: returns (logits (B,S,V), aux loss
    0 — dense groups carry none). With the kernels, attention is K4."""
    b, s = tokens.shape
    positions = torch.arange(s, dtype=torch.int32, device=tokens.device)[None].expand(b, s)
    x = embed_tokens(params["embed"], tokens, cfg).to(dtype_of(cfg.compute_dtype))
    for spec, gp in zip(layer_groups(cfg), params["groups"]):
        w = cfg.window_for_layer(0)  # uniform groups share one window
        for bp in gp:
            x = _dense_block_full(bp, x, positions, cfg, w, seq_valid)
    return unembed(params["embed"], x, cfg), torch.zeros((), dtype=torch.float32)


def make_decode_caches(
    cfg: ModelConfig, batch: int, max_len: int, device: DeviceLike = None,
) -> List[Cache]:
    """Empty full caches matching ``layer_groups(cfg)``: ``max_len`` slots
    per lane, on ``device`` (default ``"cuda"``)."""
    _full_caches_only(cfg)
    dev = resolve_device(device)
    return [
        init_attn_cache(cfg, spec.n_blocks, batch, max_len, dev)
        for spec in layer_groups(cfg)
    ]


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


def decode_step(
    params: Dict,
    cfg: ModelConfig,
    caches: List[Cache],         # per group: {"k","v"} (L,B,T,KV,Dh), "kv_pos" (B,T)
    tokens: torch.Tensor,        # (B, 1)
    pos: torch.Tensor,           # (B,) absolute position of this token
) -> Tuple[torch.Tensor, List[Cache]]:
    """serve_step against full caches (``repro.models.transformer.
    decode_step``): returns (logits (B, 1, V), caches). The token's K/V and
    position land in ``caches`` in place, at slot ``min(pos, T - 1)`` (JAX
    clamps: the full-width server decodes its empty lanes too); ``kv_pos``
    is updated once per group, before the layer loop. With the kernels
    each layer attends through K5."""
    _full_caches_only(cfg)
    positions = pos[:, None].to(torch.int32)
    x = embed_tokens(params["embed"], tokens, cfg).to(dtype_of(cfg.compute_dtype))
    for spec, gp, cache in zip(layer_groups(cfg), params["groups"], caches):
        update_kv_pos(cache["kv_pos"], pos)
        kv_valid = cache["kv_pos"] >= 0
        for i, bp in enumerate(gp):
            x = _dense_block_decode(
                bp, x, positions, cache["k"][i], cache["v"][i], cache["kv_pos"], kv_valid,
                cfg, 0,
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
