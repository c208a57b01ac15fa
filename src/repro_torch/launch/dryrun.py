"""The dry-run's cost count on one device (``repro.launch.dryrun``'s
``_cost_metrics``): one step's FLOPs of any configuration at any input
shape, counted by ``torch.utils.flop_counter.FlopCounterMode`` over the
port's plain path, on meta tensors, so that a full-size configuration
allocates nothing:

- train: ``training.trainer.grads_fn`` (``loss_fn`` and its backward, remat
  and microbatches as configured; AdamW's elementwise updates count no
  FLOPs);
- prefill: ``models.forward_full`` on the shape's tokens;
- decode: ``models.decode_step`` on ``launch.shapes.decode_cache_abstract``.

The whole depth is counted as it runs (JAX probes two depths and
extrapolates only because XLA counts a loop body once). The counter sees
PyTorch operators only, not the kernels' ``ctypes`` calls, so a kernel
configuration is refused. The production mesh, its lowering and the
per-device division come with the device mesh, which is not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..device import DeviceLike, resolve_device
from ..models import abstract_params, decode_step, forward_full, init_params
from ..models.config import ModelConfig
from ..training.trainer import grads_fn
from .shapes import (
    InputShape,
    decode_cache_abstract,
    decode_inputs_abstract,
    prefill_inputs_abstract,
    train_batch_abstract,
)


def _on(tree: Any, dev: torch.device) -> Any:
    """An abstract tree's tensors as zeros on ``dev`` (itself on meta)."""
    if isinstance(tree, dict):
        return {k: _on(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_on(v, dev) for v in tree)
    if dev.type == "meta":
        return tree
    return torch.zeros(tree.shape, dtype=tree.dtype, device=dev)


def _step_inputs(cfg: ModelConfig, shape: InputShape, device: DeviceLike = "meta") -> Dict:
    """What one step of ``shape.kind`` takes: ``params`` (seed 0 on a real
    device) and the batch, or the tokens (and patch embeddings), or the
    tokens, positions and caches, all zeros."""
    dev = resolve_device(device)
    params = abstract_params(cfg) if dev.type == "meta" else init_params(cfg, device=dev)
    if shape.kind == "train":
        return {"params": params, "batch": _on(train_batch_abstract(cfg, shape), dev)}
    if shape.kind == "prefill":
        return {"params": params, **_on(prefill_inputs_abstract(cfg, shape), dev)}
    if shape.kind == "decode":
        return {"params": params, "caches": _on(decode_cache_abstract(cfg, shape), dev),
                **_on(decode_inputs_abstract(cfg, shape), dev)}
    raise ValueError(f"unknown step kind {shape.kind!r}")


def _run_step(cfg: ModelConfig, kind: str, inputs: Dict) -> None:
    """One step of ``kind`` on ``_step_inputs``' tensors."""
    if kind == "train":
        grads_fn(inputs["params"], cfg, inputs["batch"])
        return
    with torch.no_grad():
        if kind == "prefill":
            forward_full(inputs["params"], cfg, inputs["tokens"],
                         patch_embeds=inputs.get("patch_embeds"))
        else:
            decode_step(inputs["params"], cfg, inputs["caches"], inputs["tokens"],
                        inputs["pos"])


def step_flops(cfg: ModelConfig, shape: InputShape, device: DeviceLike = "meta") -> int:
    """FLOPs of one step of ``cfg`` at ``shape`` (kind train, prefill or
    decode), on one device, by ``FlopCounterMode``. The caller selects the
    variant (``shapes.arch_for_shape``). ``device="meta"`` (the default)
    allocates nothing; any other device runs the step on zeros, for the
    same count."""
    if cfg.attn_impl != "reference":
        raise ValueError(
            f"{cfg.name}: step_flops counts the plain path (attn_impl='reference'), got "
            f"{cfg.attn_impl!r}: FlopCounterMode does not see the kernels' calls")
    inputs = _step_inputs(cfg, shape, device)
    with FlopCounterMode(display=False) as counter:
        _run_step(cfg, shape.kind, inputs)
    return counter.get_total_flops()
