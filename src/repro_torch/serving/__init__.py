from .chunked_prefill import PagedPrefiller, prime_fill_pages
from .engine import (
    GenerateResult,
    InferenceEngine,
    TorchLLMService,
    bucketed_prefill,
    chunked_append,
    prime_session_pool,
    truncate_for_cache,
)
from .paged_kv import SCRATCH_PAGE, PagedKVAllocator, PrefixPageIndex
from .sampling import sample
from .scheduler import BatchedLLMService, BatchedServer, FinishedRequest, SlotState
from .session_cache import CacheEntry, SessionCachePool

__all__ = [
    "BatchedLLMService",
    "BatchedServer",
    "CacheEntry",
    "FinishedRequest",
    "GenerateResult",
    "InferenceEngine",
    "PagedKVAllocator",
    "PagedPrefiller",
    "PrefixPageIndex",
    "SCRATCH_PAGE",
    "SessionCachePool",
    "SlotState",
    "TorchLLMService",
    "bucketed_prefill",
    "chunked_append",
    "prime_fill_pages",
    "prime_session_pool",
    "sample",
    "truncate_for_cache",
]
