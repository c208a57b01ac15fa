"""Binding of the flash decode CUDA kernel (``csrc/decode_attention.cu``,
the Hopper counterpart of
``repro.kernels.decode_attention.kernel.decode_attention_pallas``).

Takes the layouts the JAX kernel takes after its wrapper's GQA reshape,
checks device, dtype, shape and contiguity, allocates the output with
``torch.empty`` and launches on the current stream. The kernel itself
allocates nothing and does not synchronise."""

from __future__ import annotations

from typing import Tuple

import torch

from ..build import DTYPE_CODES, check, load_library, require, stream_ptr
from ..flash_attention.kernel import check_linear_kv
from ..paged_attention.kernel import MAX_G_DH, plan_splits, row_groups

WHERE = "decode_attention_cuda"


def decode_plan(b: int, kvh: int, t: int,
                n_groups: int = 1) -> Tuple[int, Tuple[int, int, int]]:
    """K5's launch: ``(splits, grid)``, the grid ``(splits, KV x n_groups,
    B)`` with clusters of ``(splits, 1, 1)`` (``n_groups`` row groups per
    KV head, ``row_groups``), each split a run of whole 128-slot tiles of
    the T slots (``plan_splits``)."""
    splits = plan_splits(b * kvh * n_groups, t)
    return splits, (splits, kvh * n_groups, b)


def decode_attention_cuda(
    q: torch.Tensor,         # (B, KV, G, Dh) — reshaped by ops.py
    k: torch.Tensor,         # (B, T, KV, Dh)
    v: torch.Tensor,
    q_pos: torch.Tensor,     # (B,) int32
    kv_pos: torch.Tensor,    # (B, T) int32
    kv_valid: torch.Tensor,  # (B, T) int32, nonzero = valid
    *,
    window: int = 0,
    softcap: float = 0.0,
) -> torch.Tensor:
    """Launch K5 -> (B, KV, G, Dh) in q's dtype: one cluster launch,
    planned by ``decode_plan`` over ``row_groups(G, Dh)``."""
    b, kvh, g, dh = q.shape
    t = k.shape[1]
    require(WHERE, tuple(k.shape[::2]) == (b, kvh) and k.shape[3] == dh,
            f"k shape {tuple(k.shape)} vs q {tuple(q.shape)}")
    require(WHERE, b > 0 and t > 0, f"empty batch ({b}) or cache ({t})")
    require(WHERE, g * dh <= MAX_G_DH, f"G * Dh = {g * dh} exceeds {MAX_G_DH}")
    check_linear_kv(WHERE, q, k, v, (
        ("q_pos", q_pos, (b,)), ("kv_pos", kv_pos, (b, t)), ("kv_valid", kv_valid, (b, t)),
    ))
    n_groups, rows = row_groups(g, dh)
    splits, _ = decode_plan(b, kvh, t, n_groups)
    out = torch.empty_like(q)
    err = load_library().repro_decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(), kv_pos.data_ptr(),
        kv_valid.data_ptr(), out.data_ptr(), b, t, kvh, g, rows, dh, splits, int(window),
        float(softcap), 1.0 / (dh ** 0.5), DTYPE_CODES[q.dtype], stream_ptr(q),
    )
    check(err, "repro_decode_attention")
    return out
