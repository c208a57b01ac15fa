from .config import ModelConfig
from .prefill import prefill_chunk_paged, supports_append
from .transformer import decode_step_paged, init_params, layer_groups
from .weights import params_from_numpy

__all__ = [
    "ModelConfig",
    "decode_step_paged",
    "init_params",
    "layer_groups",
    "params_from_numpy",
    "prefill_chunk_paged",
    "supports_append",
]
