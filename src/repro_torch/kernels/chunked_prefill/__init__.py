from .ops import chunked_prefill_attention
from .ref import chunked_prefill_ref

__all__ = ["chunked_prefill_attention", "chunked_prefill_ref"]
