"""Token sampling (``repro.serving.sampling``). The paper runs greedy
(temperature 0). The JAX engine never passes the PRNG key that
temperature > 0 needs, so any other temperature fails its assert; the port
keeps that assert and samples greedily only."""

from __future__ import annotations

import torch


def sample(logits: torch.Tensor, *, temperature: float = 0.0) -> torch.Tensor:
    """(B, V) logits -> (B,) int32 greedy token ids, on the logits' device."""
    assert temperature <= 0.0, "temperature > 0 needs a PRNG key"
    return torch.argmax(logits, dim=-1).to(torch.int32)
