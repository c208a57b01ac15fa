"""Token sampling (``repro.serving.sampling``). The paper runs greedy
(temperature 0). JAX's PRNG key becomes a ``torch.Generator`` here; the
engines, like JAX's, always sample greedily."""

from __future__ import annotations

from typing import Optional

import torch


def _tempered(logits: torch.Tensor, temperature: float, top_k: int) -> torch.Tensor:
    """``logits / temperature``, every logit below the k-th largest of its
    row set to -1e30 when ``top_k > 0`` (what JAX draws from)."""
    logits = logits / temperature
    if top_k > 0:
        cutoff = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits < cutoff, torch.full_like(logits, -1e30), logits)
    return logits


def sample(
    logits: torch.Tensor,          # (B, V)
    *,
    temperature: float = 0.0,
    top_k: int = 0,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Returns (B,) int32 sampled token ids, on the logits' device: the
    argmax at ``temperature <= 0``, else a draw from the softmax of
    :func:`_tempered` logits by the Gumbel-max trick, as
    ``jax.random.categorical`` draws."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = _tempered(logits, temperature, top_k)
    assert generator is not None, "temperature > 0 needs a PRNG key"
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    u = u.clamp_min(torch.finfo(u.dtype).tiny)
    return torch.argmax(logits.float() - torch.log(-torch.log(u)), dim=-1).to(torch.int32)
