"""Block-granular paged KV allocator for the serving layer — the PyTorch
counterpart of ``repro.serving.paged_kv``, as far as the paged route needs
it: page lifecycle (``alloc``/``incref``/``decref``), cross-session prefix
sharing (``PrefixPageIndex``, ``match_prefix``, ``register_pages``), page
tables (``table_for``), the tail-page handoff (``copy_page``), memory
accounting (``page_bytes``, ``stats``), the KV-page shipping wire format
(``export_page_bytes``/``import_page_bytes``), and the dense-lane moves
(``write_through``, ``store``, ``gather``) that put a dense route's B = 1
cache into pages and materialise pages back into one.

One shared physical pool of fixed-size KV pages per node service, and
per-sequence page tables sized to each sequence's actual token count.
Layout invariant: a sequence's pages, concatenated in table order,
reproduce the linear ``slot == absolute position`` layout. Ownership is
reference-counted per page; page id 0 is the scratch page (table padding),
never allocated.

The pools are long-lived device tensors that compute writes **in place**
(``models.cache``); ``copy_page``, ``import_page_bytes`` and
``write_through`` write in place too.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..models import ModelConfig, layer_groups, supports_append
from ..models.cache import init_paged_pool
from ..store.kv_ship import page_digests  # noqa: F401  (re-export)

# Physical page 0 is never allocated: page-table padding points here.
SCRATCH_PAGE = 0


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

    def pages(self) -> List[int]:
        return list(self._by_page)

    def __len__(self) -> int:
        return len(self._by_page)


class PagedKVAllocator:
    """Owns the shared physical KV page pool of one node service.
    ``n_pages`` counts physical pages including the scratch page. Policy
    free: what to evict is the session pool's call. ``share_prefixes``
    False turns cross-session prefix sharing off (nothing is indexed or
    matched)."""

    def __init__(
        self,
        cfg: ModelConfig,
        page_size: int = 16,
        n_pages: int = 256,
        device: Optional[torch.device] = None,
        share_prefixes: bool = True,
    ) -> None:
        if not supports_append(cfg):
            raise NotImplementedError(
                f"paged KV requires full-cache dense/moe groups ({cfg.name})"
            )
        if page_size <= 0 or n_pages <= 1:
            raise ValueError(f"page_size={page_size}, n_pages={n_pages}")
        self.cfg = cfg
        self.page_size = page_size
        self.n_pages = n_pages
        self.share_prefixes = share_prefixes
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

    @property
    def page_bytes(self) -> int:
        """Bytes of one physical page across all layers/groups (k + v)."""
        return sum(
            pool[name][:, 0].numel() * pool[name].element_size()
            for pool in self.pools for name in ("k", "v")
        )

    @property
    def resident_kv_bytes(self) -> int:
        return self.used_pages * self.page_bytes

    @property
    def total_kv_bytes(self) -> int:
        return (self.n_pages - 1) * self.page_bytes

    def pages_for(self, n_tokens: int) -> int:
        """Pages needed to hold ``n_tokens`` positions (at least one)."""
        return max(1, -(-n_tokens // self.page_size))

    def refcount(self, page: int) -> int:
        return int(self._ref[page])

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
        if not self.share_prefixes or not token_ids:
            return []
        n = len(token_ids) if max_tokens is None else min(len(token_ids), max_tokens)
        return self.index.lookup_run(
            page_digests(token_ids, self.page_size, n // self.page_size)
        )

    def register_pages(self, token_ids: Sequence[int], pages: Sequence[int]) -> None:
        """Index the full pages of an at-rest sequence for cross-session
        matching. Only for pages whose bytes are final."""
        if not self.share_prefixes:
            return
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

    # -- KV-page shipping wire format ----------------------------------------
    def export_page_bytes(self, page: int) -> bytes:
        """Serialize one physical page for shipping: per layer group, the K
        block then the V block, each ``(L, page_size, KV, Dh)`` in the
        pool's native dtype, C order, concatenated — byte for byte the JAX
        package's format (``repro.serving.paged_kv.export_page_bytes``), so
        pages shipped by a JAX node install here and the other way round.
        The round trip is bit-exact (bf16 travels as its raw 16 bits)."""
        return b"".join(
            pool[name][:, page].contiguous().cpu().view(torch.uint8).numpy().tobytes()
            for pool in self.pools for name in ("k", "v")
        )

    def import_page_bytes(self, page: int, data: bytes) -> None:
        """Install bytes produced by :meth:`export_page_bytes` (on a pool of
        the same model config, page size and dtype) into ``page``, in
        place. A raw byte move: the shipping layer verifies content against
        the token ground truth before calling this."""
        if page == SCRATCH_PAGE:
            raise ValueError("refusing to import into the scratch page")
        if len(data) != self.page_bytes:
            raise ValueError(f"page payload of {len(data)} bytes, expected {self.page_bytes}")
        off = 0
        for pool in self.pools:
            for name in ("k", "v"):
                cell = pool[name][:, page]                   # (L, ps, KV, Dh) view
                n = cell.numel() * cell.element_size()
                raw = np.frombuffer(data, np.uint8, count=n, offset=off).copy()
                block = torch.from_numpy(raw).view(cell.dtype).reshape(cell.shape)
                cell.copy_(block.to(cell.device))
                off += n

    # -- dense-lane moves (the dense route's pool storage) -------------------
    def write_through(
        self, pages: Sequence[int], dense: List[Dict[str, torch.Tensor]], n_skip: int = 0
    ) -> None:
        """Write a dense B = 1 lane (per group ``{"k","v"}`` of (L, 1, W, KV,
        Dh), W a page_size multiple covering ``pages``) into ``pages``, in
        place. The ``n_skip`` leading pages are not written: shared prefix
        pages are read-only for every sharer (copy-on-write), and their
        bytes are already what the lane holds there. JAX also writes its
        scratch page through the table's padding; nothing reads those
        bytes, so the port leaves the scratch page alone."""
        pages = list(pages)
        width = int(dense[0]["k"].shape[2])
        mp = width // self.page_size
        assert width % self.page_size == 0 and len(pages) <= mp, (width, len(pages))
        if n_skip >= len(pages):
            return
        dev = self.pools[0]["k"].device
        idx = torch.tensor(pages[n_skip:], dtype=torch.long, device=dev)
        for pool, c in zip(self.pools, dense):
            for name in ("k", "v"):
                lane = c[name][:, 0]
                blocks = lane.reshape((lane.shape[0], mp, self.page_size) + tuple(lane.shape[2:]))
                pool[name][:, idx] = blocks[:, n_skip : len(pages)].to(pool[name].dtype)

    def store(
        self, dense: List[Dict[str, torch.Tensor]], n_tokens: int,
        token_ids: Optional[Sequence[int]] = None,
    ) -> Optional[List[int]]:
        """Page an at-rest dense lane: share any resident prefix pages whose
        content matches ``token_ids`` (cross-session, incref — their write
        is skipped), allocate fresh pages for the rest, write the lane
        through, and index the stored full pages. Returns the page list
        (the caller owns one ref per page), or None when the pool can't
        supply the fresh pages (shared refs released again)."""
        shared = self.match_prefix(token_ids, n_tokens) if token_ids else []
        if shared:
            self.incref(shared)
        fresh = self.alloc(self.pages_for(n_tokens) - len(shared))
        if fresh is None:
            if shared:
                self.decref(shared)
            return None
        pages = shared + fresh
        if fresh:
            self.write_through(pages, dense, n_skip=len(shared))
        if token_ids is not None:
            self.register_pages(token_ids, pages)
        return pages

    def gather(self, pages: Sequence[int], n_valid: int, width: int) -> List[Dict[str, torch.Tensor]]:
        """Materialise pages as fresh dense B = 1 caches of ``width`` slots
        with kv_pos valid on [0, n_valid). Pages beyond width // page_size
        are not gathered; the table's padding reads the scratch page, whose
        slots kv_pos leaves invalid."""
        mp = width // self.page_size
        dev = self.pools[0]["k"].device
        table = torch.from_numpy(self.table_for(list(pages)[:mp], width)).to(dev).long()
        j = torch.arange(width, dtype=torch.int32, device=dev)
        kv_pos = torch.where(j < n_valid, j, torch.full_like(j, -1))[None, :]
        out = []
        for pool in self.pools:
            flat = (pool["k"].shape[0], 1, width) + tuple(pool["k"].shape[3:])
            out.append({
                "k": pool["k"][:, table].reshape(flat),
                "v": pool["v"][:, table].reshape(flat),
                "kv_pos": kv_pos.clone(),
            })
        return out

    def stats(self) -> Dict[str, int]:
        return {
            "n_pages": self.n_pages - 1,
            "page_size": self.page_size,
            "used_pages": self.used_pages,
            "free_pages": self.n_free,
            "page_bytes": self.page_bytes,
            "resident_kv_bytes": self.resident_kv_bytes,
            "total_kv_bytes": self.total_kv_bytes,
            "indexed_pages": len(self.index),
        }
