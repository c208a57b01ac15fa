from .config import ModelConfig
from .prefill import prefill, prefill_append, prefill_chunk_paged, supports_append
from .transformer import (
    abstract_params,
    decode_step,
    decode_step_paged,
    forward_full,
    init_params,
    layer_groups,
    make_decode_caches,
)
from .weights import params_from_numpy, params_to_numpy

__all__ = [
    "ModelConfig",
    "abstract_params",
    "decode_step",
    "decode_step_paged",
    "forward_full",
    "init_params",
    "layer_groups",
    "make_decode_caches",
    "params_from_numpy",
    "params_to_numpy",
    "prefill",
    "prefill_append",
    "prefill_chunk_paged",
    "supports_append",
]
