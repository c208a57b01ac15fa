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

``cfg.moe_impl == "shard_map"`` is JAX's explicit expert parallelism
(``_moe_forward_shard_map``): with the active rules carrying a device mesh
(``pjit_rules.sharding_rules``) and DTensor inputs, each rank routes its
data shard's tokens, runs its model rank's E/msize experts, and one
all-reduce over ``model`` completes the tokens' outputs. With no mesh
bound it takes the single-program path, as JAX does.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import Params, dtype_of, init_normal
from .pjit_rules import P, current_rules, is_dtensor, placements


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


def _replicated(idx: torch.Tensor) -> torch.Tensor:
    """``idx`` as a plain tensor: a DTensor's whole value (gathered, as
    every rank needs the whole dispatch plan, which DTensor cannot shard);
    a plain tensor itself."""
    return idx.full_tensor() if is_dtensor(idx) else idx


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
    dest = _dispatch_plan(_replicated(top_idx), e, cap)
    flat_token = torch.arange(t, dtype=torch.int32, device=xf.device).repeat_interleave(k)
    slot_token = torch.full((e * cap + 1,), t, dtype=torch.int32, device=xf.device)
    slot_token[dest] = flat_token
    # each slot's (token, choice) pair, t·k for an empty slot: the weights
    # are gathered (differentiable, and a DTensor's gather needs no scatter)
    slot_pair = torch.full((e * cap + 1,), t * k, dtype=torch.long, device=xf.device)
    slot_pair[dest] = torch.arange(t * k, device=xf.device)
    w = top_w.reshape(-1).float()
    slot_w = torch.cat([w, w.new_zeros((1,))])[slot_pair[:-1]]
    slot_token = slot_token[:-1]
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
    ce = torch.zeros(e, dtype=torch.float32, device=xf.device).index_add_(
        0, _replicated(top_idx).reshape(-1), ones) / xf.shape[0]
    aux = e * torch.sum(me * ce) * cfg.router_aux_coef
    return top_idx, top_w, aux


def _combine(ye_flat: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """Each token's sum of its K slots' rows of ``ye_flat`` (N, D), in the
    order of ``slots`` (T, K); a slot N (dropped, or not held here) adds
    zeros."""
    ye_pad = torch.cat([ye_flat, ye_flat.new_zeros((1, ye_flat.shape[1]))], dim=0)
    out = ye_pad[slots[:, 0]]
    for j in range(1, slots.shape[1]):
        out = out + ye_pad[slots[:, j]]
    return out


def moe_forward(p: Params, x: torch.Tensor, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (out (B, S, D) in x's dtype, aux loss f32 scalar)."""
    if cfg.moe_impl == "shard_map":
        rules = current_rules()
        if rules is not None and rules.get("_mesh") is not None:
            return _moe_forward_shard_map(p, x, cfg, rules)

    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    t = b * s
    cap = expert_capacity(cfg, t)
    xf = x.reshape(t, d)
    top_idx, top_w, aux = _route(p, xf, cfg)
    xe, _, slot_w, dest = _dispatch(xf, top_idx, top_w, e, cap)
    ye = _expert_mlp(p, xe, cfg)                                        # (E, C, D)
    ye_flat = ye.reshape(e * cap, d) * slot_w[:, None].to(ye.dtype)     # slot E·C: dropped
    slots = torch.sort(dest.view(t, k), dim=1).values                   # JAX's visit order
    return _combine(ye_flat, slots).reshape(b, s, d).to(x.dtype), aux.float()


class _PSum(torch.autograd.Function):
    """JAX's ``psum`` inside the shard map: the sum of the tensor over the
    ranks of ``group``. The sum is one value, replicated over the group and
    counted once downstream (DTensor's semantics), so each rank's share of
    it gets the sum's whole gradient: the backward is the identity (an
    all-reduce there, as ``torch.distributed.nn``'s, would count it once
    per rank)."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def _moe_forward_shard_map(p: Params, x, cfg: ModelConfig, rules) -> Tuple[torch.Tensor, torch.Tensor]:
    """Explicit expert-parallel MoE, JAX's shard map over (batch = data,
    expert = model) on DTensors.

    x is sharded over the data axes and replicated over ``model``, so each
    model rank already holds its data shard's tokens: it routes them (with
    the Switch statistics ``me`` and ``ce`` averaged over the data axes
    before their product), slices ITS experts' capacity buffers, runs its
    E/msize experts, combines their outputs locally, and one all-reduce
    over ``model`` completes the tokens' outputs. Each input's gradient is
    a sum of the ranks' shares (``to_local``'s ``grad_placements``): the
    tokens' over ``model``, the router's over every axis, the experts'
    over the data axes. The aux loss is the same on every rank, so only
    model rank 0 lets its gradient into the router's share. Capacity is
    taken over the local tokens, as in JAX."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Partial, Replicate

    mesh = rules["_mesh"]
    dp = rules.get("batch") or ("data",)
    dp = (dp,) if isinstance(dp, str) else tuple(dp)
    names = mesh.mesh_dim_names
    mdim = names.index("model")
    msize = mesh.size(mdim)
    e, k = cfg.n_experts, cfg.top_k
    assert e % msize == 0, (e, msize)
    assert isinstance(x, DTensor), "the shard-map MoE takes DTensors (launch.sharding)"

    def local(t, spec, summed):
        """This rank's block of ``t`` under ``spec``; its gradient is a
        share summed over the mesh axes ``summed``."""
        pl = placements(spec, mesh)
        grad = [Partial() if names[i] in summed else q for i, q in enumerate(pl)]
        return t.redistribute(mesh, pl).to_local(grad_placements=grad)

    x_spec = P(dp, None, None)
    xb = local(x, x_spec, ("model",))
    router = local(p["router"], P(None, None), names)
    experts = {n: local(p[n], P("model", None, None), dp)
               for n in ("w_up", "w_gate", "w_down") if n in p}

    b_loc, s, d = xb.shape
    t_loc = b_loc * s
    xf = xb.reshape(t_loc, d)
    probs = torch.softmax((xf @ router).float(), dim=-1)                # (T_loc, E)
    top_vals, top_idx = torch.topk(probs, k, dim=-1)
    top_w = top_vals / torch.sum(top_vals, dim=-1, keepdim=True)
    # routing statistics are averaged over the data shards BEFORE the me·ce
    # product (the mean of per-shard products is not the Switch loss)
    m_rank = mesh.get_local_rank(mdim)
    me = torch.mean(probs if m_rank == 0 else probs.detach(), dim=0)
    ones = torch.ones(top_idx.numel(), dtype=torch.float32, device=xf.device)
    ce = probs.new_zeros(e).index_add_(0, top_idx.reshape(-1), ones) / t_loc
    for axis in dp:
        group = mesh.get_group(names.index(axis))
        me = _PSum.apply(me, group) / dist.get_world_size(group)
        ce = _PSum.apply(ce.detach(), group) / dist.get_world_size(group)
    aux = e * torch.sum(me * ce) * cfg.router_aux_coef

    cap = expert_capacity(cfg, t_loc)
    e_loc = e // msize
    lo, hi = m_rank * e_loc * cap, (m_rank + 1) * e_loc * cap
    xe, _, slot_w, dest = _dispatch(xf, top_idx, top_w, e, cap)
    yr = _expert_mlp(experts, xe[m_rank * e_loc:(m_rank + 1) * e_loc], cfg)   # (E_loc, C, D)
    yr_flat = yr.reshape(e_loc * cap, d) * slot_w[lo:hi, None].to(yr.dtype)
    slots = torch.sort(dest.view(t_loc, k), dim=1).values
    mine = torch.where((slots >= lo) & (slots < hi), slots - lo, torch.full_like(slots, hi - lo))
    partial = _combine(yr_flat, mine)
    # each rank contributed its experts; one all-reduce over model
    out = _PSum.apply(partial, mesh.get_group(mdim))
    out = DTensor.from_local(out.reshape(b_loc, s, d).to(xb.dtype), mesh,
                             placements(x_spec, mesh), run_check=False)
    aux = DTensor.from_local(aux.float(), mesh, [Replicate()] * mesh.ndim, run_check=False)
    return out, aux
