"""The kernels carry no gradient: no hand-written kernel has a backward,
as no Pallas kernel of the JAX package has one (``jax.value_and_grad``
through ``attn_impl="pallas"`` fails in Pallas' JVP rule). A kernel's
output is a raw launch's, with no ``grad_fn``, so a backward through it
would silently leave the attention's inputs (``wq``/``wk``/``wv``, the
SSD's projections) without their share of the gradient. Each wrapper
calls ``refuse_grad`` before it launches on the card; the plain versions,
which run on CPU tensors, are autograd-visible and are not guarded."""

from __future__ import annotations

from typing import Optional

import torch


def refuse_grad(name: str, *tensors: Optional[torch.Tensor]) -> None:
    """Raise if autograd would record a launch of kernel ``name`` on any of
    ``tensors`` (grad mode on and an input that requires grad)."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward (nor has the JAX package's "
            "Pallas kernel), so its inputs would get no gradient; train with "
            "attn_impl='reference'"
        )
