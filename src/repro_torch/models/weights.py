"""Weight bridge: the JAX package's ``init_params`` pytree, as numpy
arrays, into the port's parameter dicts.

The tests draw weights once with ``repro.models.init_params``, convert them
with ``jax.tree_util.tree_map(np.asarray, params)`` and hand them to both
packages, so the two run the same numbers. Each group's leading L axis is
un-stacked into a list of per-layer dicts (a moe group's (L, E, D, F)
expert stacks and (L, D, E) router into per-layer (E, D, F) and (D, E); a
zamba group's two leading axes, (n_groups, period), into a list of
lists), and a zamba hybrid's ``shared_attn`` block crosses as one dict.
bf16 arrays (numpy dtype ``ml_dtypes.bfloat16``, which
``torch.from_numpy`` refuses) cross through a 16-bit integer view and come
out bit-exact.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

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
