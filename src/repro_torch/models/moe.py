"""Mixture-of-Experts FFN (dbrx: 16e top-4 fine-grained; granite: 40e
top-8) — the PyTorch counterpart of ``repro.models.moe``, in its
single-program ("gspmd") formulation.

Dispatch is the static-shape, sort-based capacity algorithm: the (token,
choice) pairs are stably sorted by expert id, each expert takes up to
C = ``expert_capacity(cfg, T)`` slots in that order, and the overflow
drops (GShard-style). C is taken over every row that reaches
:func:`moe_forward` — bucket padding and idle decode lanes included — so
the same rows drop as in JAX.

The expert products are batched matmuls (``torch.einsum``), as JAX's are
einsums outside any Pallas kernel. One deliberate difference: JAX combines
with a scatter-add (``zeros.at[slot_token].add``), whose CUDA counterpart
(``index_add_``) sums with atomics in no fixed order. Here each token
gathers its K slots, sorted by slot (the order in which JAX's scatter
visits them), and adds them one at a time in the compute dtype: the same
sums, in a fixed order, bit-identical from run to run.

``cfg.moe_impl == "shard_map"`` (JAX's explicit expert parallelism, which
needs a device mesh) takes this path too, as JAX does when no mesh rules
are active; the multi-device form is not ported yet.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import Params, dtype_of, init_normal


def init_moe(cfg: ModelConfig, gen: torch.Generator, device: torch.device) -> Params:
    """The router (D, E) and the expert stacks (E, D, F) / (E, F, D), with
    JAX's shapes, dtypes and scales (``w_gate`` for swiglu only, as
    there)."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    dt = dtype_of(cfg.param_dtype)
    s_in, s_out = 1.0 / np.sqrt(d), 1.0 / np.sqrt(f)
    p: Params = {
        "router": init_normal((d, e), s_in, dt, gen, device),
        "w_up": init_normal((e, d, f), s_in, dt, gen, device),
        "w_down": init_normal((e, f, d), s_out, dt, gen, device),
    }
    if cfg.mlp_type == "swiglu":
        p["w_gate"] = init_normal((e, d, f), s_in, dt, gen, device)
    return p


def expert_capacity(cfg: ModelConfig, n_tokens: int) -> int:
    c = int(np.ceil(n_tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor))
    return max(8, int(np.ceil(c / 8)) * 8)  # pad to a multiple of 8, as JAX


def _dispatch_plan(top_idx: torch.Tensor, e: int, cap: int) -> torch.Tensor:
    """(T, K) expert choices -> (T·K,) slot of each (token, choice) pair in
    token-major order: ``expert * cap + rank within the expert`` (stable by
    token), or ``e * cap`` when the expert is full (dropped). Each expert's
    first sorted position is found by ``searchsorted`` (JAX's
    ``cumsum(counts) - counts``): ``bincount`` would wait for the device
    to size its output."""
    flat_expert = top_idx.reshape(-1).long()
    order = torch.argsort(flat_expert, stable=True)
    se = flat_expert[order]
    starts = torch.searchsorted(se, torch.arange(e, device=se.device))
    pos_in_e = torch.arange(se.numel(), device=se.device) - starts[se]
    dest_sorted = torch.where(pos_in_e < cap, se * cap + pos_in_e,
                              torch.full_like(se, e * cap))
    dest = torch.empty_like(dest_sorted)
    dest[order] = dest_sorted
    return dest


def _sort_dispatch(
    xf: torch.Tensor, top_idx: torch.Tensor, top_w: torch.Tensor, e: int, cap: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sort-based capacity dispatch. xf (T, D); top_idx/top_w (T, K).
    Returns (xe (E, C, D), slot_token (E·C,) int32 — T marks an empty
    slot —, slot_w (E·C,) f32)."""
    return _dispatch(xf, top_idx, top_w, e, cap)[:3]


def _dispatch(xf, top_idx, top_w, e, cap):
    """``_sort_dispatch``'s outputs and the dispatch plan. Dropped pairs
    land in a spare slot ``e * cap`` that is cut off, as in JAX (no boolean
    indexing: it would wait for the device)."""
    t, d = xf.shape
    k = top_idx.shape[1]
    dest = _dispatch_plan(top_idx, e, cap)
    flat_token = torch.arange(t, dtype=torch.int32, device=xf.device).repeat_interleave(k)
    slot_token = torch.full((e * cap + 1,), t, dtype=torch.int32, device=xf.device)
    slot_token[dest] = flat_token
    slot_w = torch.zeros((e * cap + 1,), dtype=torch.float32, device=xf.device)
    slot_w[dest] = top_w.reshape(-1).float()
    slot_token, slot_w = slot_token[:-1], slot_w[:-1]
    xpad = torch.cat([xf, xf.new_zeros((1, d))], dim=0)
    xe = xpad[slot_token.long()].reshape(e, cap, d)
    return xe, slot_token, slot_w, dest


def _expert_mlp(p: Params, xe: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """xe (E, C, D) through per-expert MLPs (weights (E, D, F) / (E, F, D))."""
    up = torch.einsum("ecd,edf->ecf", xe, p["w_up"])
    if cfg.mlp_type in ("swiglu", "geglu"):
        gate = torch.einsum("ecd,edf->ecf", xe, p["w_gate"])
        # jax.nn.gelu defaults to the tanh approximation
        act = (F.silu(gate) if cfg.mlp_type == "swiglu"
               else F.gelu(gate, approximate="tanh")) * up
    elif cfg.mlp_type == "relu2":
        r = F.relu(up)
        act = r * r
    else:
        act = F.gelu(up, approximate="tanh")
    return torch.einsum("ecf,efd->ecd", act, p["w_down"])


def _route(
    p: Params, xf: torch.Tensor, cfg: ModelConfig,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Router probabilities (f32 softmax), top-k, the renormalised top-k
    weights and the Switch aux loss. xf (T, D). ``torch.topk`` returns the
    values in descending order, as ``jax.lax.top_k`` does; exact ties may
    break differently."""
    e, k = cfg.n_experts, cfg.top_k
    probs = torch.softmax((xf @ p["router"]).float(), dim=-1)          # (T, E)
    top_vals, top_idx = torch.topk(probs, k, dim=-1)                   # (T, K)
    top_w = top_vals / torch.sum(top_vals, dim=-1, keepdim=True)
    me = torch.mean(probs, dim=0)                                       # (E,)
    # the mean over tokens of each expert's one-hot count; summed from exact
    # integer counts (one_hot would wait for the device to check the ids)
    ones = torch.ones(top_idx.numel(), dtype=torch.float32, device=xf.device)
    ce = probs.new_zeros(e).index_add_(0, top_idx.reshape(-1), ones) / xf.shape[0]
    aux = e * torch.sum(me * ce) * cfg.router_aux_coef
    return top_idx, top_w, aux


def moe_forward(p: Params, x: torch.Tensor, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (out (B, S, D) in x's dtype, aux loss f32 scalar)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    t = b * s
    cap = expert_capacity(cfg, t)
    xf = x.reshape(t, d)
    top_idx, top_w, aux = _route(p, xf, cfg)
    xe, _, slot_w, dest = _dispatch(xf, top_idx, top_w, e, cap)
    ye = _expert_mlp(p, xe, cfg)                                        # (E, C, D)
    ye_flat = ye.reshape(e * cap, d) * slot_w[:, None].to(ye.dtype)
    ye_pad = torch.cat([ye_flat, ye_flat.new_zeros((1, d))], dim=0)     # row E·C: dropped
    slots = torch.sort(dest.view(t, k), dim=1).values                   # JAX's visit order
    out = ye_pad[slots[:, 0]]
    for j in range(1, k):
        out = out + ye_pad[slots[:, j]]
    return out.reshape(b, s, d).to(x.dtype), aux.float()
