"""AdamW + LR schedule + global-norm clipping — the port's counterpart of
``repro.training.optimizer``, as plain tensor functions.

Optimizer moments are f32 whatever the parameters' dtype (bf16 training
needs f32 state), and every update is made in f32 and rounded to the
parameter's dtype, with JAX's formula in JAX's order of operations.
``torch.optim.AdamW`` is not used: it keeps its moments in the parameter
dtype and orders the arithmetic differently. The per-leaf arithmetic runs
as ``torch._foreach_*`` calls over all leaves at once (the same operations
per element, in the same order, as a loop over leaves would make). Trees
are the port's parameter dicts: nested dicts and lists of tensors.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Tuple, Union

import torch

from ..models.pjit_rules import is_dtensor
from ..models.weights import tree_leaves, tree_map


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def schedule(cfg: OptConfig, step: Union[int, torch.Tensor]) -> torch.Tensor:
    """Linear warmup then cosine decay to min_lr_ratio·lr (f32)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(1.0, cfg.warmup_steps)
    prog = torch.clamp(
        (step - cfg.warmup_steps) / max(1.0, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0,
    )
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(params: Any) -> Dict[str, Any]:
    """f32 zeros ``m`` and ``v`` of the params' structure, and an int32
    ``step`` on the params' device."""
    zeros32 = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
    device = tree_leaves(params)[0].device
    return {
        "m": tree_map(zeros32, params),
        "v": tree_map(zeros32, params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in f32."""
    return torch.sqrt(torch.stack(
        [torch.sum(torch.square(x.to(torch.float32))) for x in tree_leaves(tree)]
    ).sum())


@torch.no_grad()
def adamw_update(
    params: Any, grads: Any, state: Dict[str, Any], cfg: OptConfig
) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step. ``params`` and the moments ``state["m"]`` /
    ``state["v"]`` are updated in place and returned, with a new ``step``;
    the metrics are ``{"grad_norm", "lr"}`` (f32 tensors on the device)."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = schedule(cfg, step)
    bc1 = 1.0 - cfg.b1 ** step.to(torch.float32)
    bc2 = 1.0 - cfg.b2 ** step.to(torch.float32)

    p = tree_leaves(params)
    g = [x.to(torch.float32) for x in tree_leaves(grads)]
    m, v = tree_leaves(state["m"]), tree_leaves(state["v"])
    g = torch._foreach_mul(g, scale)                    # g·scale (a new list)
    torch._foreach_mul_(m, cfg.b1)                      # m = b1·m + (1-b1)·g
    torch._foreach_add_(m, torch._foreach_mul(g, 1 - cfg.b1))
    gg = torch._foreach_mul(g, 1 - cfg.b2)              # v = b2·v + ((1-b2)·g)·g
    torch._foreach_mul_(gg, g)
    torch._foreach_mul_(v, cfg.b2)
    torch._foreach_add_(v, gg)
    del g, gg
    delta = torch._foreach_div(m, bc1)                  # mh / (sqrt(vh) + eps)
    den = torch._foreach_div(v, bc2)
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, cfg.eps)
    torch._foreach_div_(delta, den)
    p32 = [x.to(torch.float32) for x in p]
    torch._foreach_add_(delta, torch._foreach_mul(p32, cfg.weight_decay))
    torch._foreach_mul_(delta, lr)                      # p - lr·delta, rounded to p's dtype
    new = torch._foreach_sub(p32, delta)
    if is_dtensor(p[0]):   # DTensors: no sharding rule for _foreach_copy_
        for x, y in zip(p, new):
            x.copy_(y)
    else:
        torch._foreach_copy_(p, new)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, {"m": state["m"], "v": state["v"], "step": step}, metrics
