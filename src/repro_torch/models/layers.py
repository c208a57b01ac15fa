"""Shared neural layers: norms, RoPE, MLPs, embeddings — the PyTorch
counterpart of ``repro.models.layers``.

Parameters are plain dicts of tensors, laid out exactly as the JAX package's
pytrees (matrices stored ``(in, out)``, norms stored as ``weight - 1``), so
``models.weights.params_from_numpy`` can bridge the JAX weights one to one.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .config import ModelConfig
from .pjit_rules import all_reduce, from_shards, is_dtensor, local_shard, shard_span, unflatten

Params = Dict[str, torch.Tensor]

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm in f32; ``weight`` is stored as ``weight - 1``."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * (1.0 + weight.float())).to(x.dtype)


def init_rms_norm(d: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.zeros((d,), dtype=dtype, device=device)  # stored as (weight - 1)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if cap <= 0.0:
        return x
    return cap * torch.tanh(x / cap)


# ---------------------------------------------------------------------------
# RoPE — standard, ChatGLM 2D (rotary on the first half of the head) and
# M-RoPE (three position streams), in JAX's half-split form
# ---------------------------------------------------------------------------

def _rope_freqs(d_rot: int, theta: float, device: torch.device) -> torch.Tensor:
    return 1.0 / (
        theta ** (torch.arange(0, d_rot, 2, dtype=torch.float32, device=device) / d_rot)
    )


def _apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, d_rot) rotated by angles ang (B, S, d_rot/2), in f32."""
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    return _apply_rotary(x.float(), cos, sin).to(x.dtype)


def rope_standard(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, Dh); positions: (B, S). Rotates in f32, then casts."""
    freqs = _rope_freqs(x.shape[-1], theta, x.device)
    return _rotate(x, positions[..., None].float() * freqs)


def rope_chatglm2d(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """ChatGLM's 2D RoPE: the first half of the head dims is rotated (with
    frequencies over that half), the second half passes through."""
    d_rot = x.shape[-1] // 2
    freqs = _rope_freqs(d_rot, theta, x.device)
    xr = _rotate(x[..., :d_rot], positions[..., None].float() * freqs)
    return torch.cat([xr, x[..., d_rot:]], dim=-1)


def rope_mrope(
    x: torch.Tensor, positions3: torch.Tensor, theta: float, sections: Tuple[int, int, int],
) -> torch.Tensor:
    """Qwen2-VL's M-RoPE: the rotary frequencies split into (temporal,
    height, width) sections, each rotated by its own position stream.
    x: (B, S, H, Dh); positions3: (3, B, S)."""
    d = x.shape[-1]
    assert sum(sections) * 2 == d, (sections, d)
    f_parts = torch.split(_rope_freqs(d, theta, x.device), list(sections))
    ang = torch.cat(
        [positions3[i][..., None].float() * f_parts[i] for i in range(3)], dim=-1
    )                                                       # (B, S, d/2)
    return _rotate(x, ang)


def apply_rope(cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """positions: (B, S) for standard and chatglm2d; (3, B, S) for mrope."""
    if cfg.rope_style == "standard":
        return rope_standard(x, positions, cfg.rope_theta)
    if cfg.rope_style == "chatglm2d":
        return rope_chatglm2d(x, positions, cfg.rope_theta)
    if cfg.rope_style == "mrope":
        return rope_mrope(x, positions, cfg.rope_theta, cfg.mrope_sections)
    raise ValueError(cfg.rope_style)


def pos1d(positions: torch.Tensor) -> torch.Tensor:
    """The positions masks and caches use: (B, S) as given, or stream 0 of
    M-RoPE's (3, B, S) (its temporal stream, as in JAX)."""
    return positions[0] if positions.dim() == 3 else positions


def text_positions(cfg: ModelConfig, pos: torch.Tensor) -> torch.Tensor:
    """Rope positions of text tokens at ``pos`` (B, S): ``pos`` itself, or
    for mrope the one stream broadcast to all three (3, B, S), as JAX's
    text paths do (where M-RoPE equals standard RoPE)."""
    if cfg.rope_style == "mrope":
        return pos[None].expand(3, *pos.shape)
    return pos


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def init_mlp(
    cfg: ModelConfig, gen: torch.Generator, device: torch.device,
    d_ff: Optional[int] = None,
) -> Params:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    dt = dtype_of(cfg.param_dtype)
    p: Params = {
        "w_up": init_normal((d, f), 1.0 / np.sqrt(d), dt, gen, device),
        "w_down": init_normal((f, d), 1.0 / np.sqrt(f), dt, gen, device),
    }
    if cfg.mlp_type in ("swiglu", "geglu"):
        p["w_gate"] = init_normal((d, f), 1.0 / np.sqrt(d), dt, gen, device)
    return p


def mlp_forward(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    up = x @ p["w_up"]
    if cfg.mlp_type == "swiglu":
        act = F.silu(x @ p["w_gate"]) * up
    elif cfg.mlp_type == "geglu":
        # jax.nn.gelu defaults to the tanh approximation
        act = F.gelu(x @ p["w_gate"], approximate="tanh") * up
    elif cfg.mlp_type == "relu2":
        r = F.relu(up)
        act = r * r
    elif cfg.mlp_type == "gelu":
        act = F.gelu(up, approximate="tanh")
    else:
        raise ValueError(cfg.mlp_type)
    return act @ p["w_down"]


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def init_embed(cfg: ModelConfig, gen: torch.Generator, device: torch.device) -> Params:
    """The token table (V, D) and, untied, the head (D, V); an audio model
    with K > 1 codebooks (musicgen) has a (K, V, D) table and a (D, K * V)
    head, as in JAX."""
    dt = dtype_of(cfg.param_dtype)
    v, d, n_cb = cfg.vocab_size, cfg.d_model, cfg.n_codebooks
    p: Params = {
        "tok": init_normal((n_cb, v, d) if n_cb > 1 else (v, d), 0.02, dt, gen, device),
        "final_norm": init_rms_norm(d, dt, device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = init_normal((d, n_cb * v) if n_cb > 1 else (d, v), 0.02, dt, gen,
                                   device)
    return p


def _lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows ``ids`` of ``table``. A DTensor table whose vocab dim is sharded
    is read vocab-parallel on the shards where no gradient is recorded
    (``_lookup_on_shards``: serving); under autograd it is gathered over
    its vocab dim first (DTensor's masked vocab-parallel lookup loses its
    mask when an operator comes between it and its reduction) and read
    through ``F.embedding`` (not every DTensor version shards the backward
    of an index, ``index_put``)."""
    if is_dtensor(table):
        from torch.distributed.tensor import Replicate, Shard

        vocab = [i for i, p in enumerate(table.placements) if isinstance(p, Shard) and p.dim == 0]
        if vocab and not (torch.is_grad_enabled() and table.requires_grad):
            return _lookup_on_shards(table, ids, vocab)
        pl = [Replicate() if isinstance(p, Shard) and p.dim == 0 else p
              for p in table.placements]
        return F.embedding(ids.long(), table.redistribute(table.device_mesh, pl))
    return table[ids.long()]


def _lookup_on_shards(table: torch.Tensor, ids: torch.Tensor, vocab) -> torch.Tensor:
    """The vocab-parallel lookup, as GSPMD partitions a gather from a
    table sharded on its rows: each rank reads the ids inside its vocab
    range from its rows (the table's other dims gathered, as FSDP gathers
    a weight), zeros elsewhere, and the rows are all-reduced by SUM over
    the mesh dims ``vocab`` that cut the vocab. The ids keep their batch
    sharding."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = table.device_mesh
    rows = table.redistribute(mesh, [Shard(0) if i in vocab else Replicate()
                                     for i in range(mesh.ndim)]).to_local()
    off, n = shard_span(table, 0)
    pid = [p if i not in vocab and isinstance(p, Shard) else Replicate()
           for i, p in enumerate(ids.placements)] if is_dtensor(ids) else [Replicate()] * mesh.ndim
    lid = local_shard(ids, mesh, pid).long() - off
    hit = (lid >= 0) & (lid < n)
    out = F.embedding(torch.clamp(lid, 0, n - 1), rows)
    out = torch.where(hit[..., None], out, torch.zeros_like(out))
    return from_shards(all_reduce(out, "sum", mesh, vocab), mesh, pid)


def embed_tokens(p: Params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """tokens: (B, S) int ids, or (B, S, K) for K > 1 codebooks, whose K
    embeddings are summed in the table's dtype, k = 0..K-1 (JAX's order)."""
    if cfg.n_codebooks > 1:
        out = _lookup(p["tok"][0], tokens[..., 0])
        for k in range(1, cfg.n_codebooks):
            out = out + _lookup(p["tok"][k], tokens[..., k])
        return out
    return _lookup(p["tok"], tokens)


def unembed(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Logits (B, S, V), or (B, S, K, V) for K > 1 codebooks (codebook-major
    head columns; tied embeddings read codebook 0's table)."""
    x = rms_norm(x, p["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        table = p["tok"] if cfg.n_codebooks <= 1 else p["tok"][0]
        logits = x @ table.t()
    else:
        logits = x @ p["lm_head"]
    if cfg.n_codebooks > 1:
        logits = unflatten(logits, 2, (cfg.n_codebooks, cfg.vocab_size))
    return softcap(logits, cfg.logit_softcap)


# ---------------------------------------------------------------------------
# Seeded draws (torch.Generator; the numbers differ from jax.random's, so
# cross-package tests bridge the JAX weights instead of re-drawing them)
# ---------------------------------------------------------------------------

def init_normal(shape, scale: float, dtype: torch.dtype, gen: torch.Generator,
                device: torch.device) -> torch.Tensor:
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w * scale).to(dtype)
