"""Weight bridge: the JAX package's ``init_params`` pytree, as numpy
arrays, into the port's parameter dicts.

The tests draw weights once with ``repro.models.init_params``, convert them
with ``jax.tree_util.tree_map(np.asarray, params)`` and hand them to both
packages, so the two run the same numbers. Each group's leading L axis is
un-stacked into a list of per-layer dicts (a moe group's (L, E, D, F)
expert stacks and (L, D, E) router into per-layer (E, D, F) and (D, E); a
gemma_pair group's ``{"local": stack, "global": stack}`` into a list of
``{"local": layer, "global": layer}`` pairs; a zamba group's two leading
axes, (n_groups, period), into a list of lists), and a zamba hybrid's
``shared_attn`` block crosses as one dict; an audio model's (K, V, D)
token table and (D, K * V) head cross as they are.
bf16 arrays (numpy dtype ``ml_dtypes.bfloat16``, which
``torch.from_numpy`` refuses) cross through a 16-bit integer view and come
out bit-exact.

``params_to_numpy`` goes the other way, for the checkpoint and the tests
that compare the port's trees (trained weights, gradients) with JAX's leaf
for leaf: ``jax_layout`` re-stacks each group's per-layer list on the
leading axes JAX's tree has, and ``port_layout`` cuts such a stacked tree
back into the per-layer lists of a port tree.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, Sequence

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .config import ModelConfig
from .transformer import layer_groups


def tensor_from_numpy(a: Any, device: torch.device) -> torch.Tensor:
    """One array to a tensor on ``device``; bf16 bit-exact."""
    a = np.array(a)  # a writable copy (jax-backed arrays are read-only)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _convert(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, Mapping):
        return {k: _convert(v, device) for k, v in tree.items()}
    return tensor_from_numpy(tree, device)


def _layer(tree: Any, i: int) -> Any:
    if isinstance(tree, Mapping):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def params_from_numpy(tree: Mapping, cfg: ModelConfig, device: DeviceLike = None) -> Dict:
    """``{"embed": {...}, "groups": (stacked group, ...)[, "shared_attn":
    {...}]}`` of numpy arrays -> the port's ``{"embed": {...}, "groups":
    [[layer, ...], ...][, "shared_attn": {...}]}``."""
    dev = resolve_device(device)
    groups = []
    for spec, g in zip(layer_groups(cfg), tree["groups"]):
        stacked = _convert(g, dev)
        if spec.kind == "zamba":
            groups.append([[_layer(_layer(stacked, j), i) for i in range(spec.period)]
                           for j in range(spec.n_blocks)])
        else:
            groups.append([_layer(stacked, i) for i in range(spec.n_blocks)])
    params = {"embed": _convert(tree["embed"], dev), "groups": groups}
    if "shared_attn" in tree:
        params["shared_attn"] = _convert(tree["shared_attn"], dev)
    return params


def _stack_group(layers: List, stack: Callable[[List], Any]) -> Any:
    """A group's per-layer trees (a zamba group's lists of them) as one tree
    whose leaves are ``stack`` of the layers' leaves."""
    items = [_stack_group(x, stack) if isinstance(x, list) else x for x in layers]

    def zip_leaves(nodes: List) -> Any:
        if isinstance(nodes[0], Mapping):
            return {k: zip_leaves([n[k] for n in nodes]) for k in nodes[0]}
        return stack(nodes)

    return zip_leaves(items)


def jax_layout(tree: Any, stack: Callable[[List], Any]) -> Any:
    """The JAX package's layout of a tree that holds port parameters (the
    params, their gradients, an optimizer's moments): under every mapping's
    ``"groups"`` key the list of groups becomes a tuple, and each group's
    list of per-layer trees one tree of ``stack``-ed leaves — (L, ...) for a
    dense, moe or mamba group, (L, E, ...) for the experts, ``{"local":
    (L/2, ...), "global": ...}`` for gemma pairs, (n_groups, period, ...)
    for a zamba group. A tree already in that layout (groups in a tuple),
    and every other node, is returned as it is."""
    if isinstance(tree, Mapping):
        return {
            k: tuple(_stack_group(g, stack) for g in v)
            if k == "groups" and isinstance(v, list) else jax_layout(v, stack)
            for k, v in tree.items()
        }
    if isinstance(tree, (list, tuple)):
        return type(tree)(jax_layout(v, stack) for v in tree)
    return tree


def _unstack_group(layers: List, stacked: Any) -> List:
    return [_unstack_group(x, _layer(stacked, j)) if isinstance(x, list) else _layer(stacked, j)
            for j, x in enumerate(layers)]


def port_layout(like: Any, stacked: Any) -> Any:
    """``jax_layout``'s inverse: ``stacked`` (a tree in JAX's layout, of
    tensors) cut into the structure of the port tree ``like``; each layer's
    leaves are views of the stacked ones."""
    if isinstance(like, Mapping):
        return {
            k: [_unstack_group(g, s) for g, s in zip(v, stacked[k])]
            if k == "groups" and isinstance(v, list) else port_layout(v, stacked[k])
            for k, v in like.items()
        }
    if isinstance(like, (list, tuple)):
        return type(like)(port_layout(x, s) for x, s in zip(like, stacked))
    return stacked


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """One tensor to a host array; bf16 as its uint16 bit patterns (numpy has
    no bfloat16: ``.view(ml_dtypes.bfloat16)`` of them is JAX's array)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of a tree of dicts, lists and tuples, in a fixed order
    (dict insertion order, sequence order)."""
    if isinstance(tree, Mapping):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and of the trees ``rest`` of its
    structure."""
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def params_to_numpy(params: Mapping, cfg: ModelConfig) -> Dict:
    """``params_from_numpy``'s inverse: the port's parameter dicts (or a
    tree of their shape: gradients) -> JAX's ``init_params`` pytree of
    numpy arrays, each group re-stacked on its leading axes
    (``jax_layout``); bf16 leaves as uint16 bit patterns
    (``tensor_to_numpy``)."""
    specs = layer_groups(cfg)
    groups: Sequence = params["groups"]
    counts = [len(g) for g in groups]
    want = [s.n_blocks for s in specs]
    if counts != want:
        raise ValueError(f"{cfg.name}: groups of {counts} blocks, the config has {want}")
    return tree_map(tensor_to_numpy, jax_layout(params, torch.stack))
