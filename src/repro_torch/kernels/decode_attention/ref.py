"""Plain PyTorch version of flash decode (the counterpart of
``repro.kernels.decode_attention.ref``): the exact masked softmax of one
query position against the whole cache — flash attention with S = 1 — and
the unnormalised state of one split of the kernel's walk."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..flash_attention.ref import flash_attention_ref
from ..paged_attention.ref import Stats, _logits, _stats


def decode_attention_ref(
    q: torch.Tensor,         # (B, 1, H, Dh)
    k: torch.Tensor,         # (B, T, KV, Dh)
    v: torch.Tensor,
    q_pos: torch.Tensor,     # (B, 1)
    kv_pos: torch.Tensor,    # (B, T)
    kv_valid: torch.Tensor,  # (B, T)
    *,
    window: int = 0,
    softcap: float = 0.0,
) -> torch.Tensor:
    return flash_attention_ref(
        q, k, v, q_pos, kv_pos, kv_valid, window=window, softcap=softcap
    )


def decode_stats_ref(
    q: torch.Tensor,         # (B, KV, G, Dh) — the kernel binding's layout
    k: torch.Tensor,         # (B, T, KV, Dh)
    v: torch.Tensor,
    q_pos: torch.Tensor,     # (B,)
    kv_pos: torch.Tensor,    # (B, T)
    kv_valid: torch.Tensor,  # (B, T)
    *,
    window: int = 0,
    softcap: float = 0.0,
    span: Optional[Tuple[int, int]] = None,
) -> Stats:
    """The f32 ``(acc, m, l)`` of each lane's query over the slots in
    ``span = [lo, hi)`` (all T by default): the state one block of K5's
    split walk hands to the cluster's merge (``ref.merge_stats`` in
    ``kernels/paged_attention``)."""
    qp = q_pos.reshape(-1, 1).long()
    mask = (kv_valid != 0) & (kv_pos <= qp)
    if window > 0:
        mask = mask & (qp - kv_pos < window)
    if span is not None:
        slot = torch.arange(k.shape[1], device=k.device)[None, :]
        mask = mask & (slot >= span[0]) & (slot < span[1])
    return _stats(_logits(q.float(), k, softcap), mask[:, None, None, :], v)
