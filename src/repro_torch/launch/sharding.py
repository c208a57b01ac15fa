"""Partition specs for every parameter, optimizer moment, input and cache
of the system (``repro.launch.sharding``).

Strategy (Megatron-style tensor parallelism on ``model``, data parallelism
on ``data`` (+ ``pod``)):

- attention: head (column) dim of wq/wk/wv over ``model``; row dim of wo;
- MLP: d_ff over ``model`` (column-parallel up/gate, row-parallel down);
- MoE: expert dim over ``model`` when divisible (expert parallelism),
  else fall back to d_ff sharding (granite's 40 experts on 16-way model);
- embeddings: vocab over ``model`` when divisible, else d_model;
- Mamba2: d_inner/heads over ``model``;
- batch dims over (``pod``,) + ``data``;
- decode KV caches: batch over data; kv-head dim over ``model`` when
  divisible, else the *slot* (T) dim over ``model`` (flash-decode style);
  long_500k (batch=1) shards slots over data(+pod) instead of batch.

Rules are applied by leaf *path name*, then left-padded with None to match
the leaf rank (group stacking prepends layer dims).

Parameter specs are computed on, and returned in, JAX's stacked layout of
the tree (``models.weights.jax_layout``: each group's layers stacked on
leading axes), whatever layout the tree given is in. The layout matters:
``_shard_first_free_dim`` may put ``data`` on a stack axis (Mamba2-1.3B's
48-layer ``A_log``, ``D``, ``dt_bias``, ``conv_w`` and ``conv_b``), which
a per-layer leaf does not have.

``layer_specs`` cuts stacked specs into the port's per-layer tree by
dropping each leaf's stack entries, and ``distribute_tree`` places a tree
(parameters, moments, a batch, caches) on a ``DeviceMesh`` by its specs as
DTensors. Where a dropped stack entry named ``data`` (only Mamba2-1.3B's
five leaves above, under FSDP or ZeRO-1), the per-layer leaf is replicated
over ``data``: a deliberate difference from JAX of 124,560 bytes per
device on 16 x 16 (8,304 bytes of the five leaves per device in JAX,
132,864 here).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from ..models.config import ModelConfig
from ..models.pjit_rules import P, attention_weights_replicated
from ..models.weights import jax_layout, tree_map


def _divisible(n: int, k: int) -> bool:
    return n > 0 and n % k == 0


def _pad(spec: Tuple, ndim: int) -> P:
    assert len(spec) <= ndim, (spec, ndim)
    return P(*((None,) * (ndim - len(spec)) + tuple(spec)))


def _map_with_names(fn: Callable[[Sequence[Optional[str]], Any], Any], tree: Any,
                    names: Tuple[Optional[str], ...] = ()) -> Any:
    """``fn(names, leaf)`` over a tree of dicts, lists and tuples, in its
    structure; ``names`` holds the dict keys on the way to the leaf, and
    ``None`` for each sequence index (JAX's ``getattr(path_entry, "key",
    None)``)."""
    if isinstance(tree, dict):
        return {k: _map_with_names(fn, v, names + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_names(fn, v, names + (None,)) for v in tree)
    return fn(names, tree)


def _shard_first_free_dim(spec_leaf: P, arr, axis: str = "data") -> P:
    """Add `axis` on an unsharded dim divisible by 16 (ZeRO/FSDP).

    Dim 0 is tried LAST: a layer-stacked parameter is sliced along dim 0 by
    the layer loop, and a sharded dim 0 keeps fully gathered gradient and
    optimizer buffers alive across the backward pass. Sharding an inner dim
    keeps the slicing local and the accumulators sharded."""
    if arr.ndim == 0:
        return spec_leaf
    parts = list(spec_leaf)
    parts += [None] * (arr.ndim - len(parts))
    order = list(range(1, arr.ndim)) + [0] if arr.ndim > 1 else [0]
    for i in order:
        if parts[i] is None and arr.shape[i] % 16 == 0:
            parts[i] = axis
            return P(*parts)
    return spec_leaf


def _stacked(tree: Any) -> Any:
    """``tree`` (parameters, or a tree holding them) in JAX's stacked
    layout; a tree already in it is returned as it is."""
    return jax_layout(tree, torch.stack)


def fsdp_param_specs(cfg: ModelConfig, abstract: Any, model_size: int = 16) -> Any:
    """FSDP: parameters additionally sharded over ``data`` — required for
    the 132B/340B configs whose tensor-parallel shards exceed one device's
    memory."""
    abstract = _stacked(abstract)
    return tree_map(_shard_first_free_dim, param_specs(cfg, abstract, model_size), abstract)


def param_specs(cfg: ModelConfig, abstract: Any, model_size: int = 16) -> Any:
    """Partition-spec tree matching ``abstract_params(cfg)`` in JAX's
    stacked layout."""
    shard_vocab = _divisible(cfg.vocab_size, model_size)
    # head counts that don't divide the model axis: attention weights are
    # replicated; attention runs context-parallel (pjit_rules)
    attn_replicated = attention_weights_replicated(cfg, model_size)
    kv_replicated = attn_replicated or not _divisible(cfg.n_kv_heads, model_size)
    moe_expert = _divisible(cfg.n_experts, model_size)

    def rule(names, leaf) -> P:
        name = names[-1]
        nd = leaf.ndim

        if name == "tok":
            return _pad(("model", None) if shard_vocab else (None, "model"), nd)
        if name == "lm_head":
            return _pad((None, "model") if shard_vocab else ("model", None), nd)
        if name in ("final_norm", "norm", "norm1", "norm2", "gate_norm"):
            return _pad((), nd)
        if name == "wq":
            return _pad((), nd) if attn_replicated else _pad((None, "model"), nd)
        if name in ("wk", "wv"):
            # kv heads that can't shard are computed replicated (they're
            # small under GQA) — avoids sub-head resharding
            return _pad((), nd) if kv_replicated else _pad((None, "model"), nd)
        if name == "bq":
            return _pad((), nd) if attn_replicated else _pad(("model",), nd)
        if name in ("bk", "bv"):
            return _pad((), nd) if kv_replicated else _pad(("model",), nd)
        if name == "wo":
            return _pad((), nd) if attn_replicated else _pad(("model", None), nd)
        if name in ("w_up", "w_gate"):
            if "moe" in names:
                return _pad(("model", None, None) if moe_expert else (None, None, "model"), nd)
            return _pad((None, "model"), nd)
        if name == "w_down":
            if "moe" in names:
                return _pad(("model", None, None) if moe_expert else (None, "model", None), nd)
            return _pad(("model", None), nd)
        if name == "router":
            return _pad((), nd)
        if name in ("in_proj", "conv_w"):
            return _pad((None, "model"), nd)
        if name == "conv_b":
            return _pad(("model",), nd)
        if name in ("A_log", "D", "dt_bias"):
            return _pad(("model",), nd) if _divisible(cfg.n_ssm_heads, model_size) else _pad((), nd)
        if name == "out_proj":
            return _pad(("model", None), nd)
        return _pad((), nd)

    return _map_with_names(rule, _stacked(abstract))


def opt_state_specs(cfg: ModelConfig, abstract_opt: Any, model_size: int = 16,
                    zero1: bool = False) -> Any:
    """Moments inherit parameter specs; with zero1, they are additionally
    sharded over ``data`` on their first free dim (``_shard_first_free_dim``)."""
    moments = _stacked(abstract_opt["m"])
    m_specs = param_specs(cfg, moments, model_size)
    if zero1:
        m_specs = tree_map(_shard_first_free_dim, m_specs, moments)
    return {"m": m_specs, "v": m_specs, "step": P()}


# ---------------------------------------------------------------------------
# Inputs & caches
# ---------------------------------------------------------------------------

def batch_specs(cfg: ModelConfig, multi_pod: bool, kind: str) -> Dict[str, P]:
    dp = ("pod", "data") if multi_pod else ("data",)
    specs: Dict[str, P] = {}
    tok_nd = 3 if cfg.n_codebooks > 1 else 2
    specs["tokens"] = P(dp, *(None,) * (tok_nd - 1))
    if kind == "train":
        specs["labels"] = P(dp, *(None,) * (tok_nd - 1))
    if cfg.n_patches:
        specs["patch_embeds"] = P(dp, None, None)
    return specs


def cache_specs(
    cfg: ModelConfig,
    abstract_caches: Any,
    multi_pod: bool,
    model_size: int = 16,
    seq_shard: bool = False,
) -> Any:
    """Specs for the decode caches. seq_shard=True (long_500k, batch=1):
    slots shard over data(+pod); otherwise batch over data(+pod)."""
    dp = ("pod", "data") if multi_pod else ("data",)
    kv_over_model = _divisible(cfg.n_kv_heads, model_size)
    heads_over_model = _divisible(cfg.n_ssm_heads, model_size)
    conv_over_model = _divisible(cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state, model_size)

    def rule(names, leaf) -> P:
        name = names[-1]
        if name in ("k", "v"):
            # (L, B, T, KV, Dh)
            if seq_shard:
                return P(None, None, dp, "model" if kv_over_model else None, None)
            return P(None, dp, None if kv_over_model else "model",
                     "model" if kv_over_model else None, None)
        if name == "kv_pos":
            # (B, T)
            if seq_shard:
                return P(None, dp)
            return P(dp, None if kv_over_model else "model")
        if name == "h":
            # (L, B, H, P, N)
            return P(None, None if seq_shard else dp, "model" if heads_over_model else None,
                     None, None)
        if name == "conv":
            # (L, B, K, cdim)
            return P(None, None if seq_shard else dp, None, "model" if conv_over_model else None)
        return P(*(None,) * leaf.ndim)

    return _map_with_names(rule, abstract_caches)


def logits_spec(cfg: ModelConfig, multi_pod: bool, batched: bool = True) -> P:
    dp = ("pod", "data") if multi_pod else ("data",)
    lead = dp if batched else None
    if cfg.n_codebooks > 1:
        return P(lead, None, None, None)
    return P(lead, None, None)


# ---------------------------------------------------------------------------
# Placing trees on a device mesh
# ---------------------------------------------------------------------------

def layer_specs(like: Any, specs: Any) -> Any:
    """``specs`` (a spec tree in JAX's stacked layout, or one whose layout
    already matches) cut into the structure of the port tree ``like``: a
    group's one stacked spec tree serves each of its layers, each spec
    keeping its last ``leaf.ndim`` entries (the stack entries dropped: L
    for dense, moe and mamba groups, L/2 for gemma pairs, (n_groups,
    period) for zamba)."""
    if isinstance(like, dict):
        return {k: layer_specs(v, specs[k]) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        if isinstance(specs, (list, tuple)):
            return type(like)(layer_specs(x, s) for x, s in zip(like, specs))
        return type(like)(layer_specs(x, specs) for x in like)
    return P(*tuple(specs)[len(specs) - like.ndim:])


def distribute_tree(tree: Any, specs: Any, mesh) -> Any:
    """``tree``'s tensors as DTensors on ``mesh``, each placed by its spec
    (``layer_specs(tree, specs)``, ``pjit_rules.placements``). The tensors
    keep their device: meta tensors give meta shards (nothing allocated),
    and tensors on the mesh's device are cut into this rank's shards
    (every rank must hold the same values: ``distribute_tensor`` sends rank
    0's)."""
    from torch.distributed.tensor import distribute_tensor

    from ..models.pjit_rules import placements

    return tree_map(lambda t, s: distribute_tensor(t, mesh, placements(s, mesh)),
                    tree, layer_specs(tree, specs))
