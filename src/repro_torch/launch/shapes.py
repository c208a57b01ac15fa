"""The four assigned input shapes and their abstract inputs
(``repro.launch.shapes``): tensors on the meta device, with shapes and
dtypes and no storage, in place of JAX's ``ShapeDtypeStruct``s."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import torch

from ..models.cache import Cache
from ..models.config import ModelConfig
from ..models.layers import dtype_of
from ..models.transformer import make_decode_caches


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                  # train | prefill | decode


SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}

# archs that run long_500k natively (sub-quadratic state); all others use the
# sliding-window variant
NATIVE_LONG = {"mamba2-1.3b", "zamba2-7b", "gemma2-27b"}


def arch_for_shape(cfg: ModelConfig, shape: InputShape) -> ModelConfig:
    """Variant selection: long_500k forces the sliding-window variant for
    pure full-attention archs."""
    if shape.name == "long_500k" and cfg.name not in NATIVE_LONG and not cfg.is_attention_free:
        return cfg.replace(attn_variant="sliding_window", sliding_window=8192)
    return cfg


def meta(shape, dtype: torch.dtype) -> torch.Tensor:
    """An abstract tensor (JAX's ``sds``)."""
    return torch.empty(shape, dtype=dtype, device="meta")


def _token_shape(cfg: ModelConfig, b: int, s: int) -> tuple:
    return (b, s, cfg.n_codebooks) if cfg.n_codebooks > 1 else (b, s)


def train_batch_abstract(cfg: ModelConfig, shape: InputShape) -> Dict[str, torch.Tensor]:
    b, s = shape.global_batch, shape.seq_len
    batch = {"tokens": meta(_token_shape(cfg, b, s), torch.int32),
             "labels": meta(_token_shape(cfg, b, s), torch.int32)}
    if cfg.n_patches:
        batch["patch_embeds"] = meta((b, cfg.n_patches, cfg.d_model),
                                     dtype_of(cfg.compute_dtype))
    return batch


def prefill_inputs_abstract(cfg: ModelConfig, shape: InputShape) -> Dict[str, torch.Tensor]:
    b, s = shape.global_batch, shape.seq_len
    out = {"tokens": meta(_token_shape(cfg, b, s), torch.int32)}
    if cfg.n_patches:
        out["patch_embeds"] = meta((b, cfg.n_patches, cfg.d_model),
                                   dtype_of(cfg.compute_dtype))
    return out


def decode_cache_abstract(cfg: ModelConfig, shape: InputShape) -> List[Cache]:
    """The decode caches of ``layer_groups(cfg)`` for the shape's batch and
    slots, on the meta device: long_500k's 524288 slots allocate
    nothing."""
    return make_decode_caches(cfg, shape.global_batch, shape.seq_len, device="meta")


def decode_inputs_abstract(cfg: ModelConfig, shape: InputShape) -> Dict[str, torch.Tensor]:
    b = shape.global_batch
    return {"tokens": meta(_token_shape(cfg, b, 1), torch.int32),
            "pos": meta((b,), torch.int32)}
