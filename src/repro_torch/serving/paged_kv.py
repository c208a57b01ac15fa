"""Block-granular paged KV allocator for the serving layer — the PyTorch
counterpart of ``repro.serving.paged_kv``, as far as the paged route needs
it: page lifecycle (``alloc``/``incref``/``decref``), cross-session prefix
sharing (``PrefixPageIndex``, ``match_prefix``, ``register_pages``), page
tables (``table_for``) and the tail-page handoff (``copy_page``).

One shared physical pool of fixed-size KV pages per node service, and
per-sequence page tables sized to each sequence's actual token count.
Layout invariant: a sequence's pages, concatenated in table order,
reproduce the linear ``slot == absolute position`` layout. Ownership is
reference-counted per page; page id 0 is the scratch page (table padding),
never allocated.

The pools are long-lived device tensors that compute writes **in place**
(``models.cache``); ``copy_page`` copies in place too. The JAX package's
dense-lane moves (``store``/``gather``/``write_through``) and page export
and import belong to the dense route and the next slice.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..models import ModelConfig, layer_groups, supports_append
from ..models.cache import init_paged_pool

# Physical page 0 is never allocated: page-table padding points here.
SCRATCH_PAGE = 0


def page_digests(
    token_ids: Sequence[int], page_size: int, limit: Optional[int] = None
) -> List[bytes]:
    """Chained content digests of the page-aligned full blocks of
    ``token_ids`` (a copy of ``repro.store.kv_ship.page_digests``): digest
    ``i`` commits to tokens ``[0, (i+1)*page_size)``, so two sequences share
    digest ``i`` iff their prefixes through page ``i`` are identical — the
    condition under which their KV pages are interchangeable. ``limit``
    caps the number of digests."""
    n_full = len(token_ids) // page_size
    if limit is not None:
        n_full = min(n_full, max(0, limit))
    out: List[bytes] = []
    h = hashlib.blake2b(digest_size=16)
    for i in range(n_full):
        block = np.asarray(
            token_ids[i * page_size : (i + 1) * page_size], np.int64
        )
        h.update(block.tobytes())
        out.append(h.digest())
    return out


class PrefixPageIndex:
    """Content-hash index over resident full pages: chained prefix digest
    -> physical page id. Weak by design — registering takes no page
    reference; the allocator drops a page's mapping when its refcount hits
    zero. First writer wins."""

    def __init__(self) -> None:
        self._by_digest: Dict[bytes, int] = {}
        self._by_page: Dict[int, bytes] = {}

    def register(self, digest: bytes, page: int) -> None:
        if digest in self._by_digest or page in self._by_page:
            return
        self._by_digest[digest] = page
        self._by_page[page] = digest

    def lookup_run(self, digests: Sequence[bytes]) -> List[int]:
        """Longest indexed run of consecutive prefix digests, as physical
        page ids (no references taken)."""
        pages: List[int] = []
        for d in digests:
            p = self._by_digest.get(d)
            if p is None:
                break
            pages.append(p)
        return pages

    def drop_page(self, page: int) -> None:
        d = self._by_page.pop(page, None)
        if d is not None:
            del self._by_digest[d]


class PagedKVAllocator:
    """Owns the shared physical KV page pool of one node service.
    ``n_pages`` counts physical pages including the scratch page. Policy
    free: what to evict is the session pool's call."""

    def __init__(
        self,
        cfg: ModelConfig,
        page_size: int = 16,
        n_pages: int = 256,
        device: Optional[torch.device] = None,
    ) -> None:
        if not supports_append(cfg):
            raise NotImplementedError(
                f"paged KV requires full-cache dense groups ({cfg.name})"
            )
        if page_size <= 0 or n_pages <= 1:
            raise ValueError(f"page_size={page_size}, n_pages={n_pages}")
        self.cfg = cfg
        self.page_size = page_size
        self.n_pages = n_pages
        self.index = PrefixPageIndex()
        self.pools: List[Dict[str, torch.Tensor]] = [
            init_paged_pool(cfg, spec.n_blocks, n_pages, page_size, device)
            for spec in layer_groups(cfg)
        ]
        # page 0 reserved as scratch; LIFO free list keeps reuse warm
        self._free: List[int] = list(range(n_pages - 1, 0, -1))
        self._ref = np.zeros(n_pages, np.int32)

    # -- accounting -----------------------------------------------------
    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return (self.n_pages - 1) - len(self._free)

    def pages_for(self, n_tokens: int) -> int:
        """Pages needed to hold ``n_tokens`` positions (at least one)."""
        return max(1, -(-n_tokens // self.page_size))

    # -- page lifecycle -------------------------------------------------
    def alloc(self, n: int) -> Optional[List[int]]:
        """Allocate ``n`` pages (refcount 1 each), or None if the pool
        can't satisfy the request."""
        if n <= 0:
            return []
        if len(self._free) < n:
            return None
        pages = [self._free.pop() for _ in range(n)]
        self._ref[pages] = 1
        return pages

    def incref(self, pages: Sequence[int]) -> None:
        for p in pages:
            assert p != SCRATCH_PAGE and self._ref[p] > 0, p
            self._ref[p] += 1

    def decref(self, pages: Sequence[int]) -> None:
        for p in pages:
            assert p != SCRATCH_PAGE and self._ref[p] > 0, p
            self._ref[p] -= 1
            if self._ref[p] == 0:
                # a released page may be recycled for new content: it must
                # leave the content index now
                self.index.drop_page(p)
                self._free.append(p)

    # -- cross-session prefix sharing -----------------------------------
    def match_prefix(
        self, token_ids: Sequence[int], max_tokens: Optional[int] = None
    ) -> List[int]:
        """Longest run of resident full prefix pages matching ``token_ids``
        (chained content hash), across every session; at most
        ``max_tokens`` leading tokens are considered. No references taken."""
        if not token_ids:
            return []
        n = len(token_ids) if max_tokens is None else min(len(token_ids), max_tokens)
        return self.index.lookup_run(
            page_digests(token_ids, self.page_size, n // self.page_size)
        )

    def register_pages(self, token_ids: Sequence[int], pages: Sequence[int]) -> None:
        """Index the full pages of an at-rest sequence for cross-session
        matching. Only for pages whose bytes are final."""
        for d, p in zip(page_digests(token_ids, self.page_size), pages):
            self.index.register(d, p)

    # -- tables and page moves --------------------------------------------
    def table_for(self, pages: Sequence[int], width: int) -> np.ndarray:
        """(width // page_size,) int32 page table, scratch-padded."""
        mp = width // self.page_size
        assert width % self.page_size == 0, (width, self.page_size)
        assert len(pages) <= mp, (len(pages), mp)
        table = np.full((mp,), SCRATCH_PAGE, np.int32)
        table[: len(pages)] = pages
        return table

    def copy_page(self, src: int, dst: int) -> None:
        """Device-copy one physical page's bytes (every layer of every
        group) from ``src`` into ``dst``, in place — the partial-tail handoff
        of admission: a lane continuing mid-page through a shared entry's
        tail page gets an exclusively-held copy to append into."""
        for pool in self.pools:
            for name in ("k", "v"):
                pool[name][:, dst].copy_(pool[name][:, src])
