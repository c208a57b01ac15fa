"""Decoder assembly for the paged serving route — the PyTorch counterpart
of ``repro.models.transformer`` for the ``"dense"`` layer group.

Parameters are ``{"embed": {...}, "groups": [[layer dict, ...], ...]}``:
one list of per-layer dicts per group (the JAX package stacks each group on
a leading L axis and scans it; a Python loop over layers replaces
``scan_or_unroll`` here). Pools and ``kv_pos`` are updated in place.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import torch

from ..device import DeviceLike, resolve_device
from .attention import attention_decode_paged, init_attention, project_kv_step
from .cache import Cache, gather_pages_stacked, paged_write_step, update_kv_pos_paged
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


def _dense_block_decode_paged(
    bp: Params, x: torch.Tensor, positions: torch.Tensor,
    pool_k: torch.Tensor, pool_v: torch.Tensor, page_table: torch.Tensor,
    kv_pos: torch.Tensor, cfg: ModelConfig, window: int, page_size: int,
    lin_k: Optional[torch.Tensor] = None, lin_v: Optional[torch.Tensor] = None,
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
        window=window, lin_k=lin_k, lin_v=lin_v,
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
) -> torch.Tensor:
    """serve_step against a paged KV pool (``repro.models.transformer.
    decode_step_paged``): returns the logits (B, 1, V). The token's K/V land
    in ``pools`` and its position in ``kv_pos``, both in place (a lane at
    table capacity has both dropped). With the kernels each layer attends
    straight through the page table (K1); the reference path gathers the
    whole stack's pages once per step, before any layer writes."""
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
            )
    return unembed(params["embed"], x, cfg)
