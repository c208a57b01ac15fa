"""Attention for the paged serving route — the PyTorch counterpart of
``repro.models.attention``.

Two execution paths, chosen by ``cfg.attn_impl``:

- ``"reference"`` — plain PyTorch: gather the lane's pages into the linear
  slot == position view and run the position-masked SDPA in f32.
- anything else — the hand-written Hopper kernels
  (``repro_torch.kernels.paged_attention`` for decode,
  ``repro_torch.kernels.chunked_prefill`` for prefill chunks), which attend
  through the page table. On a CPU tensor those wrappers run their plain
  versions, so the CPU tests reach this branch too.

The paged pools are written in place (JAX returns new pools).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .config import ModelConfig
from .layers import Params, init_normal, apply_rope, dtype_of, softcap

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
    b, s, _ = x.shape
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, cfg.n_heads, cfg.d_head)
    k = k.reshape(b, s, cfg.n_kv_heads, cfg.d_head)
    v = v.reshape(b, s, cfg.n_kv_heads, cfg.d_head)
    return apply_rope(cfg, q, positions), apply_rope(cfg, k, positions), v


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
    logits take NEG_INF (-1e30), never -inf."""
    b, s, h, dh = q.shape
    kvh = k.shape[2]
    g = h // kvh
    q5 = q.reshape(b, s, kvh, g, dh)
    scale = 1.0 / np.sqrt(dh)
    logits = torch.einsum("bskgd,btkd->bkgst", q5.float(), k.float()) * scale
    logits = softcap(logits, cfg.attn_softcap)
    causal = kv_pos[:, None, :] <= q_pos[:, :, None]            # (B,S,T)
    mask = causal & kv_valid[:, None, :]
    if window > 0:
        mask = mask & (q_pos[:, :, None] - kv_pos[:, None, :] < window)
    logits = torch.where(mask[:, None, None], logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.float())
    return out.reshape(b, s, h, dh).to(q.dtype)


def _project_q_step(
    p: Params, x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig
) -> torch.Tensor:
    """Rope'd query for the current decode token: (B,1,D) -> (B,1,H,Dh)."""
    b = x.shape[0]
    q = x @ p["wq"]
    if cfg.qkv_bias:
        q = q + p["bq"]
    return apply_rope(cfg, q.reshape(b, 1, cfg.n_heads, cfg.d_head), positions)


def project_kv_step(
    p: Params, x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K/V for the current decode token (to be inserted into the cache)."""
    b = x.shape[0]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        k, v = k + p["bk"], v + p["bv"]
    k = k.reshape(b, 1, cfg.n_kv_heads, cfg.d_head)
    v = v.reshape(b, 1, cfg.n_kv_heads, cfg.d_head)
    return apply_rope(cfg, k, positions), v


def attention_decode(
    p: Params,
    x: torch.Tensor,           # (B,1,D) — the single new token
    positions: torch.Tensor,   # (B,1)
    k_cache: torch.Tensor,     # (B,T,KV,Dh) — already includes this token
    v_cache: torch.Tensor,
    kv_pos: torch.Tensor,      # (B,T) absolute positions per slot
    kv_valid: torch.Tensor,    # (B,T)
    cfg: ModelConfig,
    window: int = 0,
) -> torch.Tensor:
    """Single-step decode against a linear cache — the reference branch.
    The JAX package's kernel branch (``decode_attention_pallas``) serves the
    dense route and is not ported yet (ROADMAP, Queue 2 K5)."""
    if cfg.attn_impl != "reference":
        raise NotImplementedError(
            "attention_decode's kernel branch (decode_attention_pallas) is the "
            "dense route, not ported yet (ROADMAP, Queue 2 K5)"
        )
    b = x.shape[0]
    q = _project_q_step(p, x, positions, cfg)
    out = _sdpa_reference(q, k_cache, v_cache, positions, kv_pos, kv_valid, cfg, window)
    return out.reshape(b, 1, cfg.n_heads * cfg.d_head) @ p["wo"]


def attention_decode_paged(
    p: Params,
    x: torch.Tensor,           # (B,1,D) — the single new token
    positions: torch.Tensor,   # (B,1)
    pool_k: torch.Tensor,      # (P, ps, KV, Dh) — shared page pool, one layer
    pool_v: torch.Tensor,
    page_table: torch.Tensor,  # (B, MP) physical page ids per lane
    kv_pos: torch.Tensor,      # (B, MP*ps) absolute positions per virtual slot
    cfg: ModelConfig,
    window: int = 0,
    lin_k: Optional[torch.Tensor] = None,  # (B, MP*ps, KV, Dh) pre-gathered view
    lin_v: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Page-table-aware decode. The kernel path attends through the page
    table (``kernels.paged_attention``: K1); the reference path gathers the
    lane's pages into the linear view (or takes the caller's hoisted
    ``lin_k``/``lin_v``) and runs the position-masked SDPA."""
    if cfg.attn_impl != "reference":
        from ..kernels.paged_attention import ops as paged_ops

        b = x.shape[0]
        q = _project_q_step(p, x, positions, cfg)
        out = paged_ops.paged_attention(
            q, pool_k, pool_v, page_table, positions, kv_pos,
            window=window, softcap=cfg.attn_softcap,
        )
        return out.reshape(b, 1, cfg.n_heads * cfg.d_head) @ p["wo"]

    from .cache import gather_pages

    ck = lin_k if lin_k is not None else gather_pages(pool_k, page_table)
    cv = lin_v if lin_v is not None else gather_pages(pool_v, page_table)
    return attention_decode(p, x, positions, ck, cv, kv_pos, kv_pos >= 0, cfg, window=window)


def attention_chunk_paged(
    p: Params,
    x: torch.Tensor,           # (B,S,D) — a chunk of prompt tokens
    positions: torch.Tensor,   # (B,S) absolute positions
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
