"""Prefill — the PyTorch counterpart of ``repro.models.prefill``: the full
prefill that seeds full caches and SSM state (``prefill``; dense, mamba and
zamba groups), the chunk append into existing full caches
(``prefill_append``, session-level KV reuse on the dense route), and the
paged route's chunked prefill straight into KV pages
(``prefill_chunk_paged``); the last two for dense and moe groups only.
Caches and pools are written in place. A moe layer's experts see every row
of the call — bucket padding included — as in JAX, so the same rows fill
the experts' capacity."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from .attention import attention_append, attention_chunk_paged, attention_forward
from .cache import Cache, append_kv_pos, gather_pages_stacked, prefill_kv_pos, trim_kv_pos
from .config import ModelConfig
from .layers import Params, dtype_of, embed_tokens, mlp_forward, rms_norm, unembed
from .moe import moe_forward
from .transformer import _mamba_block_full, layer_groups


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


def _alloc_kv(n_layers: int, b: int, max_len: int, k: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    shape = (n_layers, b, max_len) + tuple(k.shape[2:])
    return (torch.zeros(shape, dtype=k.dtype, device=k.device),
            torch.zeros(shape, dtype=k.dtype, device=k.device))


def prefill(
    params: Dict,
    cfg: ModelConfig,
    tokens: torch.Tensor,                       # (B,S)
    max_len: int,
    true_len: Optional[torch.Tensor] = None,    # (B,) real lengths (bucketed input)
) -> Tuple[torch.Tensor, List[Cache], torch.Tensor]:
    """Full prefill of positions 0..S-1 into fresh caches
    (``repro.models.prefill.prefill``): returns (last-position logits
    (B,V), caches, next_pos (B,)). Attention K/V fill slots [0, S) of
    ``max_len``-slot full caches and the rest stay zero; a mamba layer's
    cache is its final SSM state and conv window. With ``true_len`` the
    input is right-padded to a bucket length and logits/next_pos refer to
    position ``true_len - 1``. As in JAX, the padding is masked out of
    attention, and a dense group's kv_pos is valid below ``true_len`` only;
    but a mamba layer runs its SSM over the padded rows too (so its state
    has absorbed them), and a zamba group's kv_pos is not trimmed (its
    padded slots lie after every decode query and are overwritten before a
    query reaches them). With the kernels, attention is K4 and every mamba
    layer's SSD is K6."""
    if cfg.attn_variant != "full":
        raise NotImplementedError(f"prefill requires full caches ({cfg.name})")
    groups = layer_groups(cfg)
    b, s = tokens.shape
    dev = tokens.device
    if s > max_len and any(spec.kind != "mamba" for spec in groups):
        raise ValueError(f"prefill of {s} tokens into {max_len} slots")
    idx = torch.arange(s, dtype=torch.int32, device=dev)
    seq_valid = idx[None, :] < true_len[:, None] if true_len is not None else None
    positions = idx[None].expand(b, s)
    x = embed_tokens(params["embed"], tokens, cfg).to(dtype_of(cfg.compute_dtype))
    caches: List[Cache] = []
    for spec, gp in zip(groups, params["groups"]):
        if spec.kind == "mamba":
            hs, convs = [], []
            for bp in gp:
                x, final, conv = _mamba_block_full(bp, x, cfg)
                hs.append(final)
                convs.append(conv)
            caches.append({"h": torch.stack(hs), "conv": torch.stack(convs)})
            continue
        if spec.kind == "zamba":
            hs, convs = [], []
            ck = cv = None
            for g, group in enumerate(gp):
                for bp in group:
                    x, final, conv = _mamba_block_full(bp, x, cfg)
                    hs.append(final)
                    convs.append(conv)
                x, k, v = _dense_block_prefill(
                    params["shared_attn"], x, positions, cfg, 0, seq_valid
                )
                if ck is None:
                    ck, cv = _alloc_kv(len(gp), b, max_len, k)
                ck[g, :, :s] = k
                cv[g, :, :s] = v
            caches.append({
                "ssm": {"h": torch.stack(hs), "conv": torch.stack(convs)},
                "attn": {"k": ck, "v": cv, "kv_pos": prefill_kv_pos(b, max_len, s, dev)},
            })
            continue
        w = cfg.window_for_layer(0)
        block = _dense_block_prefill if spec.kind == "dense" else _moe_block_prefill
        ck = cv = None
        for i, bp in enumerate(gp):
            x, k, v = block(bp, x, positions, cfg, w, seq_valid)
            if ck is None:
                ck, cv = _alloc_kv(len(gp), b, max_len, k)
            ck[i, :, :s] = k
            cv[i, :, :s] = v
        kv_pos = prefill_kv_pos(b, max_len, s, dev)
        if true_len is not None:
            kv_pos = trim_kv_pos(kv_pos, true_len)
        caches.append({"k": ck, "v": cv, "kv_pos": kv_pos})
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
    tokens: torch.Tensor,                       # (B,S) new-token chunk
    p0: int,                                    # every lane's start offset
    true_len: Optional[torch.Tensor] = None,    # (B,) real chunk lengths
) -> Tuple[torch.Tensor, List[Cache], torch.Tensor]:
    """Prefill a token chunk starting at position ``p0`` into *existing*
    full caches (``repro.models.prefill.prefill_append``, whose ``p0`` is
    a (B,) array; here every caller appends one offset the host knows), in
    place: K/V land in slots ``[p0, p0 + S)`` (slots past the cache dropped),
    ``kv_pos`` is extended (padded rows write -1), and the chunk attends
    against every prior valid slot — a returning session computes only its
    new tokens. Returns (last-valid-position logits (B,V), caches,
    next_pos (B,)). A caller that must keep the caches it passes (a pool
    entry) passes a copy. With the kernels, attention is K4."""
    if not supports_append(cfg):
        raise NotImplementedError(
            f"prefill_append requires full-cache dense/moe groups ({cfg.name})"
        )
    b, s = tokens.shape
    dev = tokens.device
    idx = torch.arange(s, dtype=torch.int32, device=dev)
    q_pos = (p0 + idx)[None, :].expand(b, s)                           # (B,S)
    valid = (
        idx[None, :] < true_len[:, None] if true_len is not None
        else torch.ones((b, s), dtype=torch.bool, device=dev)
    )
    x = embed_tokens(params["embed"], tokens, cfg).to(dtype_of(cfg.compute_dtype))
    for spec, gp, cache in zip(layer_groups(cfg), params["groups"], caches):
        append_kv_pos(cache["kv_pos"], p0, valid)
        w = cfg.window_for_layer(0)
        block = _dense_block_append if spec.kind == "dense" else _moe_block_append
        for i, bp in enumerate(gp):
            x = block(
                bp, x, q_pos, p0, cache["k"][i], cache["v"][i], cache["kv_pos"], cfg, w,
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
    tokens: torch.Tensor,        # (B, S) prompt chunk (bucketed)
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
    ``true_len - 1``, shape (B, V). With the kernels each layer attends
    through the page table (K3); the reference path gathers the stack's
    pages once, before any layer writes."""
    if not supports_append(cfg):
        raise NotImplementedError(
            f"prefill_chunk_paged requires full-cache dense/moe groups ({cfg.name})"
        )
    b, s = tokens.shape
    idx = torch.arange(s, dtype=torch.int32, device=tokens.device)
    p0 = p0.to(torch.int32)
    true_len = true_len.to(torch.int32)
    q_pos = p0[:, None] + idx[None, :]                       # (B, S)
    valid = idx[None, :] < true_len[:, None]
    x = embed_tokens(params["embed"], tokens, cfg).to(dtype_of(cfg.compute_dtype))
    use_kernel = cfg.attn_impl != "reference"
    for spec, gp, pool in zip(layer_groups(cfg), params["groups"], pools):
        block = _dense_block_chunk_paged if spec.kind == "dense" else _moe_block_chunk_paged
        if not use_kernel:
            lin_k, lin_v = gather_pages_stacked(pool["k"], pool["v"], page_table)
        for i, bp in enumerate(gp):
            x = block(
                bp, x, q_pos, valid, pool["k"][i], pool["v"][i], page_table, p0, true_len,
                cfg, n_skip,
                None if use_kernel else lin_k[i], None if use_kernel else lin_v[i],
            )
    n = torch.clamp(true_len, min=1).long()
    last = x[torch.arange(b, device=x.device), n - 1][:, None, :]
    return unembed(params["embed"], last, cfg)[:, 0]
