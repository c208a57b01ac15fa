"""Chunked paged prefill loop — prompt tokens land straight in KV pages
(the PyTorch counterpart of ``repro.serving.chunked_prefill``).

The prompt is split into chunks and each chunk runs
:func:`repro_torch.models.prefill_chunk_paged`, which writes its K/V into
the allocator's page pool through the page table before attending. Chunk
widths keep the JAX loop's buckets — a power-of-two multiple of the page
size, and a power-of-two table width — so the tables and shapes here are
the JAX package's, and the two packages compare like with like.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..device import synchronize
from ..models import ModelConfig
from ..models.prefill import prefill_chunk_paged
from .paged_kv import PagedKVAllocator


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


class PagedPrefiller:
    """Runs chunked paged prefill against one allocator's page pool. The
    caller owns page allocation, sharing and chunk scheduling."""

    def __init__(
        self, cfg: ModelConfig, params, allocator: PagedKVAllocator,
        device: torch.device,
    ) -> None:
        self.cfg = cfg
        self.params = params
        self.alloc = allocator
        self.device = device

    def run_chunk(
        self,
        pages: Sequence[int],
        chunk_ids: Sequence[int],
        p0: int,
        n_skip: int = 0,
    ) -> torch.Tensor:
        """Prefill one chunk of ``chunk_ids`` at absolute offset ``p0``
        straight into ``pages``. Returns the logits at the chunk's last
        token, shape (V,), on the device. ``n_skip`` leading pages are
        read-only shared-prefix pages."""
        alloc = self.alloc
        ps = alloc.page_size
        c = len(chunk_ids)
        assert c > 0
        # chunk bucket: pow2 multiple of the page size; table width: pow2
        # page count covering the causal prefix [0, p0 + c)
        s = ps * _pow2(-(-c // ps))
        mp = _pow2(alloc.pages_for(p0 + c))
        assert len(pages) >= alloc.pages_for(p0 + c), (len(pages), p0, c)
        table = alloc.table_for(list(pages)[:mp], mp * ps)
        toks = np.zeros((1, s), np.int32)
        toks[0, :c] = np.asarray(chunk_ids, np.int64) % self.cfg.vocab_size
        # one host->device copy for the chunk's small operands
        host = np.concatenate([table, toks[0], np.asarray([p0, c], np.int32)])
        dev = torch.from_numpy(host).to(self.device)
        logits = prefill_chunk_paged(
            self.params, self.cfg, alloc.pools, dev[:mp][None, :],
            dev[mp : mp + s][None, :], dev[mp + s : mp + s + 1],
            dev[mp + s + 1 :], n_skip=n_skip,
        )
        return logits[0]

    def prefill_ids(
        self,
        pages: Sequence[int],
        token_ids: Sequence[int],
        start: int,
        n_skip: int = 0,
        chunk: int = 256,
    ) -> torch.Tensor:
        """Drain the whole suffix ``token_ids[start:]`` into ``pages`` in
        ``chunk``-capped steps. Returns the final logits (V,)."""
        token_ids = list(token_ids)
        n = len(token_ids)
        logits: Optional[torch.Tensor] = None
        i = start
        while i < n:
            c = min(chunk, n - i)
            logits = self.run_chunk(pages, token_ids[i : i + c], i, n_skip=n_skip)
            i += c
        assert logits is not None, (start, n)
        return logits


def prime_fill_pages(
    pool,
    prefiller: PagedPrefiller,
    token_ids: Sequence[int],
    entry,
    usable: int,
    shipped: Optional[Sequence[bytes]] = None,
    ship_have: int = 0,
) -> Optional[List[int]]:
    """Chunk-prefill ``token_ids`` straight into pages for a session-pool
    entry — the paged warm-start prime path
    (``repro.serving.chunked_prefill.prime_fill_pages``), shared by the
    batched server and the single-stream engine. Off the serving hot path,
    so the whole suffix drains in one loop.

    Shares the matched ``entry``'s full pages (its tail page copied when
    coverage ends mid-page) or a cross-session content-index run; no
    ``n - 1`` cap as at admission — prime needs no logits, so a fully
    covering share is a pure-incref prime. Returns the page list (refs
    owned by the caller's entry-to-be) or None when the pool can't cover
    the context: prime is best-effort and never reclaims other sessions'
    entries.

    With ``shipped``, this is the KV-page install path: ``shipped[i]``
    holds the bytes of full page ``ship_have + i`` of ``token_ids``'s KV,
    digest-verified by the shipper. Those pages are imported as they are;
    only the uncovered gap before them and the partial tail page are
    chunk-prefilled."""
    alloc = prefiller.alloc
    ps = alloc.page_size
    token_ids = list(token_ids)
    n = len(token_ids)
    tail_src: Optional[int] = None
    if entry is not None and usable > 0:
        cover = usable
        shared = list(entry.pages[: cover // ps])
        if cover % ps:
            tail_src = entry.pages[cover // ps]
    else:
        shared = list(alloc.match_prefix(token_ids, n))
        cover = len(shared) * ps
    skip = len(shared)
    fresh_needed = alloc.pages_for(n) - skip
    if fresh_needed > alloc.n_free:
        return None
    if shared:
        alloc.incref(shared)
    fresh = alloc.alloc(fresh_needed)
    if fresh is None:
        if shared:
            alloc.decref(shared)
        return None
    pages = shared + fresh
    if tail_src is not None:
        alloc.copy_page(tail_src, fresh[0])
    if shipped is not None:
        # import the verified bytes into fresh pages (never into a shared,
        # refcounted page: the import range starts at max(skip, ship_have)),
        # compute only the gap below them and the tail beyond them
        want = min(n // ps, ship_have + len(shipped))
        gs = min(max(skip, ship_have), want)
        for i in range(gs, want):
            alloc.import_page_bytes(pages[i], shipped[i - ship_have])
        if cover < gs * ps:
            prefiller.prefill_ids(pages, token_ids[: gs * ps], cover, n_skip=skip)
        t0 = max(cover, want * ps)
        if t0 < n:
            prefiller.prefill_ids(pages, token_ids, t0, n_skip=skip)
    elif cover < n:
        prefiller.prefill_ids(pages, token_ids, cover, n_skip=skip)
    # the prime's compute must finish inside the off-hot-path window
    # (client think time), not contend with the next serving turn
    synchronize(prefiller.device)
    if pool is not None and shared and entry is None:
        pool.shared_hits += 1
        pool.shared_tokens += cover
    return pages
