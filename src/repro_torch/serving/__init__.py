from .chunked_prefill import PagedPrefiller
from .engine import (
    GenerateResult,
    InferenceEngine,
    PagePoolExhausted,
    ServiceCapabilities,
    ServiceResult,
    TorchLLMService,
    truncate_for_cache,
)
from .paged_kv import SCRATCH_PAGE, PagedKVAllocator, PrefixPageIndex, page_digests
from .sampling import sample
from .session_cache import CacheEntry, SessionCachePool

__all__ = [
    "CacheEntry",
    "GenerateResult",
    "InferenceEngine",
    "PagePoolExhausted",
    "PagedKVAllocator",
    "PagedPrefiller",
    "PrefixPageIndex",
    "SCRATCH_PAGE",
    "ServiceCapabilities",
    "ServiceResult",
    "SessionCachePool",
    "TorchLLMService",
    "page_digests",
    "sample",
    "truncate_for_cache",
]
