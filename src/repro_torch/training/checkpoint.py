"""Pytree checkpoints in the JAX package's file format
(``repro.training.checkpoint``), written and read without msgpack
(``_msgpack.py`` carries the subset these files use).

A file is the msgpack map ``{"step": int, "arrays": {key: {"dtype",
"shape", "data"}}}``: one entry per leaf, keyed by its path (``"groups/0/
attn/wq"``), in the order ``jax.tree_util.tree_flatten_with_path`` visits
the tree (dict keys sorted, sequence indices in order); ``data`` is the
leaf's raw little-endian bytes, bf16 as ``"bfloat16"`` over its uint16
bits. A tree that holds port parameters is written in JAX's stacked
layout (``models.weights.jax_layout``, as ``params_to_numpy`` writes it),
so the port's file of a model is byte for byte JAX's file of the same
weights, and each package loads the other's. A leaf over 4 GiB overflows
msgpack's bin 32 in both packages (``ValueError``); a leaf is a whole
stacked group, so at full width nemotron-4-340b, dbrx-132b, gemma2-27b and
zamba2-7b cannot be saved by either.
"""

from __future__ import annotations

import os
from typing import Any, Iterator, List, Mapping, Tuple

import numpy as np
import torch

from ..models.weights import jax_layout, port_layout, tree_map
from . import _msgpack


def _flatten_with_path(tree: Any, path: Tuple = ()) -> Iterator[Tuple[Tuple, Any]]:
    if isinstance(tree, Mapping):
        for k in sorted(tree):
            yield from _flatten_with_path(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten_with_path(v, path + (i,))
    else:
        yield path, tree


def _key_str(path: Tuple) -> str:
    return "/".join(str(p) for p in path)


def _stack_on_host(leaves: List[torch.Tensor]) -> torch.Tensor:
    return torch.stack([t.detach().cpu() for t in leaves])


def _encode_array(x: Any) -> Mapping[str, Any]:
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        bf16 = t.dtype == torch.bfloat16
        arr = t.view(torch.int16).numpy() if bf16 else t.numpy()
    else:
        arr = np.ascontiguousarray(x)
        bf16 = arr.dtype.name == "bfloat16"
        if bf16:
            arr = arr.view(np.uint16)
    return {
        "dtype": "bfloat16" if bf16 else str(arr.dtype),
        "shape": list(arr.shape),
        "data": memoryview(arr.reshape(-1).view(np.uint8)),
    }


def save_checkpoint(path: str, tree: Any, step: int = 0) -> None:
    """Write ``tree`` (tensors or arrays; port parameters in JAX's layout)
    and ``step`` to ``path``, through ``path + ".tmp"`` and ``os.replace``."""
    flat = {
        _key_str(kp): _encode_array(leaf)
        for kp, leaf in _flatten_with_path(jax_layout(tree, _stack_on_host))
    }
    payload = {"step": int(step), "arrays": flat}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    try:
        with open(tmp, "wb") as f:
            _msgpack.pack(payload, f.write)
    except BaseException:
        os.remove(tmp)       # JAX packs in memory first: a failed save leaves no file
        raise
    os.replace(tmp, path)


def _decode_array(d: Mapping[str, Any]) -> torch.Tensor:
    if d["dtype"] == "bfloat16":
        raw = np.frombuffer(d["data"], dtype=np.uint16).reshape(d["shape"])
        return torch.from_numpy(raw.copy()).view(torch.bfloat16)
    raw = np.frombuffer(d["data"], dtype=np.dtype(d["dtype"])).reshape(d["shape"])
    return torch.from_numpy(raw.copy())


def load_checkpoint(path: str, like: Any) -> Tuple[Any, int]:
    """Restore into the structure of ``like`` (a tree of tensors or arrays:
    anything with a ``.shape``): returns (tree, step). Each leaf keeps the
    file's dtype and lands on the device of ``like``'s leaf (the CPU for a
    leaf that is no tensor). A key the file lacks raises ``KeyError``, a
    shape that differs ``ValueError``, as in JAX."""
    with open(path, "rb") as f:
        payload = _msgpack.unpack(f.read())
    arrays = payload["arrays"]

    def restore(node: Any, path: Tuple = ()) -> Any:
        if isinstance(node, Mapping):
            return {k: restore(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(restore(v, path + (i,)) for i, v in enumerate(node))
        k = _key_str(path)
        if k not in arrays:
            raise KeyError(f"checkpoint missing {k}")
        shape = tuple(arrays[k]["shape"])
        if shape != tuple(node.shape):
            raise ValueError(f"{k}: shape {shape} != {tuple(node.shape)}")
        return _decode_array(arrays[k])

    shapes = tree_map(lambda x: torch.empty(tuple(x.shape), device="meta"), like)
    host = port_layout(like, restore(jax_layout(shapes, torch.stack)))
    on_device = lambda x, t: t.to(x.device) if isinstance(x, torch.Tensor) else t  # noqa: E731
    return tree_map(on_device, like, host), payload["step"]
