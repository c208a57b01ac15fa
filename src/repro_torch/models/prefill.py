"""Paged chunked prefill — prompt chunks land straight in KV pages (the
PyTorch counterpart of ``repro.models.prefill.prefill_chunk_paged``)."""

from __future__ import annotations

from typing import Dict, List

import torch

from .attention import attention_chunk_paged
from .cache import Cache, gather_pages_stacked
from .config import ModelConfig
from .layers import dtype_of, embed_tokens, mlp_forward, rms_norm, unembed
from .transformer import layer_groups


def supports_append(cfg: ModelConfig) -> bool:
    """Chunked paged prefill needs full-cache (slot == position) groups."""
    if cfg.attn_variant != "full":
        return False
    try:
        return all(spec.kind == "dense" for spec in layer_groups(cfg))
    except NotImplementedError:
        return False


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
            f"prefill_chunk_paged requires full-cache dense groups ({cfg.name})"
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
        if not use_kernel:
            lin_k, lin_v = gather_pages_stacked(pool["k"], pool["v"], page_table)
        for i, bp in enumerate(gp):
            h = attention_chunk_paged(
                bp["attn"], rms_norm(x, bp["norm1"], cfg.norm_eps), q_pos, valid,
                pool["k"][i], pool["v"][i], page_table, p0, true_len, cfg,
                n_skip=n_skip,
                lin_k=None if use_kernel else lin_k[i],
                lin_v=None if use_kernel else lin_v[i],
            )
            x = x + h
            x = x + mlp_forward(bp["mlp"], rms_norm(x, bp["norm2"], cfg.norm_eps), cfg)
    n = torch.clamp(true_len, min=1).long()
    last = x[torch.arange(b, device=x.device), n - 1][:, None, :]
    return unembed(params["embed"], last, cfg)[:, 0]
