"""Training step: loss, gradient accumulation, remat, optimizer update —
the port's counterpart of ``repro.training.trainer``.

Gradients come from autograd through the plain path (``attn_impl=
"reference"``), as JAX's come from ``jax.value_and_grad`` through its
reference path: no kernel has a backward in either package, and both
refuse a kernel config (``_require_reference``). Remat is
``cfg.remat`` in ``models.transformer.forward_full``. Gradient
accumulation is a loop over microbatches (cfg.grad_accum) in place of
JAX's ``lax.scan``. ``grad_specs`` (JAX's sharding constraint on the
gradients, a partition-spec tree) redistributes the gradients of DTensor
parameters to the specs' placements on the mesh of the active rules
(``pjit_rules.sharding_rules`` with ``"_mesh"``); with no mesh bound a spec
tree raises, as JAX's ``with_sharding_constraint`` does. A batch is a dict
of tensors on the params' device: ``tokens`` and ``labels``, and
optionally ``mask``, ``positions`` and ``patch_embeds``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..models import ModelConfig, forward_full
from ..models.pjit_rules import current_rules, is_dtensor, placements
from ..models.weights import tree_leaves, tree_map
from .optimizer import OptConfig, adamw_update

Batch = Dict[str, torch.Tensor]


def _logsumexp(x: torch.Tensor) -> torch.Tensor:
    """``logsumexp`` over the last dim. On a DTensor it is spelt as a max
    and a sum, which DTensor reduces over a sharded vocab as partials (its
    ``logsumexp`` gathers the whole vocab first)."""
    if not is_dtensor(x):
        return torch.logsumexp(x, dim=-1)
    m = torch.amax(x.detach(), dim=-1, keepdim=True)
    return torch.log(torch.sum(torch.exp(x - m), dim=-1)) + m[..., 0]


def cross_entropy(
    logits: torch.Tensor,                # (B,S,V) or (B,S,K,V)
    labels: torch.Tensor,                # (B,S) or (B,S,K)
    mask: Optional[torch.Tensor] = None,  # (B,S)
    impl: str = "gather",
) -> torch.Tensor:
    logits = logits.to(torch.float32)
    logz = _logsumexp(logits)
    if impl == "onehot":
        onehot = torch.nn.functional.one_hot(labels.long(), logits.shape[-1]).to(logits.dtype)
        gold = torch.sum(logits * onehot, dim=-1)
        nll = logz - gold
    else:
        # the gold logit keeps its vocab dim until the subtraction: on
        # vocab-sharded DTensor logits the gather is a masked partial sum,
        # whose mask has the gather's shape
        gold = torch.gather(logits, -1, labels.long()[..., None])
        nll = (logz[..., None] - gold)[..., 0]
    if nll.ndim == 3:   # audio codebooks: average over K
        nll = torch.mean(nll, dim=-1)
    if mask is None:
        return torch.mean(nll)
    mask = mask.to(torch.float32)
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def _require_reference(cfg: ModelConfig) -> None:
    if cfg.attn_impl != "reference":
        raise NotImplementedError(
            f"{cfg.name}: training needs attn_impl='reference' (got {cfg.attn_impl!r}): "
            "no kernel has a backward, as no Pallas kernel of the JAX package has one"
        )


def loss_fn(
    params: Any, cfg: ModelConfig, batch: Batch
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    _require_reference(cfg)
    logits, aux = forward_full(
        params,
        cfg,
        batch["tokens"],
        positions=batch.get("positions"),
        patch_embeds=batch.get("patch_embeds"),
        seq_valid=batch.get("mask"),
    )
    ce = cross_entropy(logits, batch["labels"], batch.get("mask"), impl=cfg.ce_impl)
    loss = ce + aux
    return loss, {"ce": ce, "aux": aux}


def _split_microbatches(batch: Batch, n: int) -> Batch:
    def rs(x):
        if x.ndim >= 1 and x.shape[0] % n == 0:
            shape = (n, x.shape[0] // n) + tuple(x.shape[1:])
            if not is_dtensor(x):
                return x.reshape(shape)
            # DTensor cannot cut a sharded dim in two: gather the batch, then
            # shard each microbatch as the batch was
            from torch.distributed.tensor import Replicate, Shard

            mesh = x.device_mesh
            y = x.redistribute(mesh, [Replicate()] * mesh.ndim).reshape(shape)
            return y.redistribute(mesh, [Shard(p.dim + 1) if isinstance(p, Shard) else p
                                         for p in x.placements])
        return x.expand((n,) + tuple(x.shape))  # e.g. (3,B,S) positions

    return {k: rs(v) for k, v in batch.items() if v is not None}


def _value_and_grad(params: Any, cfg: ModelConfig, batch: Batch):
    """(loss, metrics, grads) of ``loss_fn``: gradients by autograd with
    respect to leaves detached from ``params`` (the caller's tensors never
    require grad); a leaf the loss does not reach gets zeros, as in JAX."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    it = iter(leaves)
    tracked = tree_map(lambda _: next(it), params)
    with torch.enable_grad():
        loss, metrics = loss_fn(tracked, cfg, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = iter(torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads))
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_map(lambda _: next(it), params))


def _constrainer(grad_specs: Any):
    """JAX's ``cst``: the identity without specs, else a function that
    redistributes a gradient tree to ``grad_specs`` (stacked or per-layer)
    on the active rules' mesh."""
    if grad_specs is None:
        return lambda tree: tree
    rules = current_rules()
    mesh = None if rules is None else rules.get("_mesh")
    if mesh is None:
        raise RuntimeError(
            "grad_specs constrains the gradients' sharding and requires a device mesh in "
            "context: bind one with sharding_rules({..., '_mesh': mesh})")
    from ..launch.sharding import layer_specs

    def cst(tree):
        return tree_map(lambda g, s: g.redistribute(mesh, placements(s, mesh)),
                        tree, layer_specs(tree, grad_specs))

    return cst


def grads_fn(params: Any, cfg: ModelConfig, batch: Batch, grad_specs: Any = None):
    """Value-and-grad with optional microbatch accumulation (mean over
    microbatches): returns (loss, metrics, grads), grads in the params'
    structure. With ``cfg.grad_accum`` > 1 the gradients are summed in f32
    (``acc + g / n``, JAX's order) and the metrics are JAX's ``{"ce":
    loss, "aux": 0}``. ``grad_specs`` pins each microbatch's gradients and
    the f32 accumulator to the parameters' sharding on the bound mesh (so
    FSDP-sharded parameters get gradients reduce-scattered into their
    shards); ``None`` is a no-op, and specs with no mesh bound raise
    ``RuntimeError``."""
    cst = _constrainer(grad_specs)
    n = cfg.grad_accum
    if n <= 1:
        loss, metrics, grads = _value_and_grad(params, cfg, batch)
        return loss, metrics, cst(grads)

    micro = _split_microbatches(batch, n)
    grads = cst(tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params))
    loss = torch.zeros((), dtype=torch.float32, device=tree_leaves(params)[0].device)
    for i in range(n):
        mb_loss, _, g = _value_and_grad(params, cfg, {k: v[i] for k, v in micro.items()})
        g = cst(g)
        torch._foreach_add_(tree_leaves(grads),
                            torch._foreach_div([x.to(torch.float32) for x in tree_leaves(g)], n))
        grads = cst(grads)
        loss = loss + mb_loss / n
    return loss, {"ce": loss, "aux": torch.zeros((), dtype=torch.float32, device=loss.device)}, grads


def train_step(
    params: Any,
    opt_state: Dict[str, Any],
    batch: Batch,
    cfg: ModelConfig,
    opt_cfg: OptConfig,
    grad_specs: Any = None,
) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """``grads_fn`` then ``adamw_update`` (params and moments updated in
    place)."""
    loss, metrics, grads = grads_fn(params, cfg, batch, grad_specs=grad_specs)
    params, opt_state, opt_metrics = adamw_update(params, grads, opt_state, opt_cfg)
    out = {"loss": loss, **metrics, **opt_metrics}
    return params, opt_state, out


def make_train_step(cfg: ModelConfig, opt_cfg: OptConfig, grad_specs: Any = None):
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``;
    it runs on the device of the tensors it is given. ``grad_specs`` as in
    ``grads_fn``."""

    def step(params, opt_state, batch):
        return train_step(params, opt_state, batch, cfg, opt_cfg, grad_specs=grad_specs)

    return step
