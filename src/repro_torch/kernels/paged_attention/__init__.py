from .ops import paged_attention, shared_prefix
from .ref import paged_attention_ref, shared_prefix_ref

__all__ = ["paged_attention", "paged_attention_ref", "shared_prefix", "shared_prefix_ref"]
