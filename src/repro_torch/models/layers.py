"""Shared neural layers: norms, RoPE, MLPs, embeddings — the PyTorch
counterpart of ``repro.models.layers``.

Parameters are plain dicts of tensors, laid out exactly as the JAX package's
pytrees (matrices stored ``(in, out)``, norms stored as ``weight - 1``), so
``models.weights.params_from_numpy`` can bridge the JAX weights one to one.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .config import ModelConfig

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
# RoPE — standard only in this slice
# ---------------------------------------------------------------------------

def _rope_freqs(d_rot: int, theta: float, device: torch.device) -> torch.Tensor:
    return 1.0 / (
        theta ** (torch.arange(0, d_rot, 2, dtype=torch.float32, device=device) / d_rot)
    )


def _apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def rope_standard(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, Dh); positions: (B, S). Rotates in f32, then casts."""
    d = x.shape[-1]
    freqs = _rope_freqs(d, theta, x.device)
    ang = positions[..., None].float() * freqs               # (B, S, d/2)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    return _apply_rotary(x.float(), cos, sin).to(x.dtype)


def apply_rope(cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    if cfg.rope_style == "standard":
        return rope_standard(x, positions, cfg.rope_theta)
    raise NotImplementedError(
        f"rope_style={cfg.rope_style!r} is not ported yet "
        "(ROADMAP, Queue 1 item 8)"
    )


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
    if cfg.n_codebooks > 1:
        raise NotImplementedError(
            "audio codebooks are not ported yet (ROADMAP, Queue 1 item 8)"
        )
    dt = dtype_of(cfg.param_dtype)
    v, d = cfg.vocab_size, cfg.d_model
    p: Params = {
        "tok": init_normal((v, d), 0.02, dt, gen, device),
        "final_norm": init_rms_norm(d, dt, device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = init_normal((d, v), 0.02, dt, gen, device)
    return p


def embed_tokens(p: Params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """tokens: (B, S) int ids."""
    if cfg.n_codebooks > 1:
        raise NotImplementedError(
            "audio codebooks are not ported yet (ROADMAP, Queue 1 item 8)"
        )
    return p["tok"][tokens.long()]


def unembed(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = rms_norm(x, p["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = x @ p["tok"].t()
    else:
        logits = x @ p["lm_head"]
    return softcap(logits, cfg.logit_softcap)


# ---------------------------------------------------------------------------
# Seeded draws (torch.Generator; the numbers differ from jax.random's, so
# cross-package tests bridge the JAX weights instead of re-drawing them)
# ---------------------------------------------------------------------------

def init_normal(shape, scale: float, dtype: torch.dtype, gen: torch.Generator,
                device: torch.device) -> torch.Tensor:
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w * scale).to(dtype)
