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

from typing import Optional, Sequence

import numpy as np
import torch

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
