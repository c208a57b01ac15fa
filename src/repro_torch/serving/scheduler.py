"""Multi-tenant continuous-batching server — the PyTorch counterpart of
``repro.serving.scheduler``, in its two modes.

**Full width** (``paged=False``, the default as in JAX): ``n_slots`` lanes
of one ``make_decode_caches`` batch, ``max_len`` slots each. Admission
prefills a request at once — a full prefill (bucket 16, K4), or on a
session hit a chunk append of the suffix (chunk 128, bucket 16, K4) onto a
copy of the stored cache — and copies the B = 1 result into its lane;
every step decodes all lanes (empty ones too, into their own lanes at
their stale positions, as in JAX) through K5. A finished keyed request's
lane is copied out into the session pool.

**Paged** (``paged=True``): a fixed decode batch of ``n_slots`` lanes
shares one physical KV page pool with the session pool. Every
:meth:`BatchedServer.step` is a *unified step*: admission only plans (it
reserves pages, shares resident prefix pages, and queues the uncovered
prompt tokens as a chunk plan); the step
then drains up to ``prefill_chunk_tokens`` prompt tokens from the plans in
strict FIFO order, straight into the lanes' pages (K3), and decodes every
decode-ready lane in one batched call. When the ready lanes' page tables
start with the same pages — tenants sharing a system prompt — the decode
runs the shared-prefix cascade: K2 attends the common run once per KV
head for the whole batch, and K1 continues each lane over its own suffix.

Finished requests move their pages into the session pool under their
``cache_key``, so the next turn admits with a suffix-only plan; ``prime``
and ``install_shipped_pages`` are the migration warm-start hooks.
:class:`BatchedLLMService` mounts the server as a node's LLM Service on
the submit/await path, with per-request ``queue_ms``/``batch_size``.

Tables, chunk widths and bucketing are the JAX server's, so the two
compare like with like.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.manager import ServiceCapabilities, ServiceResult
from ..device import DeviceLike, resolve_device
from ..models import (
    ModelConfig,
    decode_step,
    decode_step_paged,
    init_params,
    make_decode_caches,
    supports_append,
)
from ..models.cache import clone_caches, trim_cache_prefix
from ..store.kv_ship import NodeShipProfile, PageShipment
from ..tokenizer import EOS, IM_END, ByteLevelBPE, get_tokenizer
from .chunked_prefill import PagedPrefiller, prime_fill_pages
from .engine import (
    bucketed_prefill,
    chunked_append,
    export_entry_pages,
    prime_session_pool,
    resident_entry_pages,
    truncate_for_cache,
)
from .paged_kv import SCRATCH_PAGE, PagedKVAllocator
from .sampling import sample
from .session_cache import (
    CacheEntry,
    SessionCachePool,
    longest_common_prefix,
    warm_source_of,
)

@dataclass
class SlotState:
    request_id: int
    pos: int
    generated: List[int] = field(default_factory=list)
    max_new: int = 128
    done: bool = False
    # session-pool bookkeeping (None when submitted without a cache_key)
    cache_key: Optional[str] = None
    token_ids: List[int] = field(default_factory=list)
    reused_tokens: int = 0
    warm_start: bool = False
    warm_source: str = "none"    # "tokens" | "pages" | "none"
    # peak number of occupied slots observed while this request decoded
    batch_size: int = 1
    # chunked-prefill plan: prompt tokens not yet in pages. The slot joins
    # the decode batch only once the plan drains.
    prefilled: bool = False
    pending: List[int] = field(default_factory=list)
    prefill_p0: int = 0      # absolute position of the next chunk
    n_skip: int = 0          # leading read-only shared-prefix pages
    # latency accounting (wall clock)
    ttft_ms: float = 0.0
    gaps_ms: List[float] = field(default_factory=list)
    last_tok_t: Optional[float] = None


@dataclass
class FinishedRequest:
    request_id: int
    token_ids: List[int]
    submitted_at: float
    finished_at: float
    # session-KV reuse accounting (0 / False without a pool hit)
    cache_hit: bool = False
    reused_tokens: int = 0
    warm_start: bool = False
    warm_source: str = "none"    # "tokens" | "pages" | "none"
    # peak decode batch this request shared (1 = it ran alone)
    batch_size: int = 1
    # wall-clock latency: submit -> first generated token determined, and
    # the per-token decode gap distribution
    ttft_ms: float = 0.0
    decode_p50_ms: float = 0.0
    decode_p99_ms: float = 0.0


@dataclass
class DecodePlan:
    """What one step's batched decode call gets: the trimmed table width
    ``w`` (pages), each lane's decode position (``wp = w * page_size`` for
    a lane that must not decode, so its K/V write and kv_pos relabel drop)
    and the shared-prefix run (empty: no cascade)."""

    ready: List[int]
    w: int
    dec_pos: np.ndarray
    shared_run: List[int]


class BatchedServer:
    def __init__(
        self,
        cfg: ModelConfig,
        params,
        n_slots: int = 4,
        max_len: int = 512,
        stop_tokens=(EOS, IM_END),
        session_pool: Optional[SessionCachePool] = None,
        paged: bool = False,
        page_size: int = 16,
        kv_pages: Optional[int] = None,
        share_prefixes: bool = True,
        prefill_chunk_tokens: Optional[int] = 64,
        device: DeviceLike = None,
    ) -> None:
        # as JAX: full-cache attention decoders (gemma2's pairs, whose ring
        # caches cannot be appended to, on the full-width server only)
        if cfg.attn_variant != "full" or cfg.arch_type not in ("dense", "moe", "vlm"):
            raise NotImplementedError(
                f"batched serving requires full-cache attention archs ({cfg.name})"
            )
        if paged and not supports_append(cfg):
            raise NotImplementedError(
                f"paged batched serving requires full-cache dense/moe groups ({cfg.name})"
            )
        if paged and max_len % page_size:
            raise ValueError(f"max_len {max_len} is not a multiple of page_size {page_size}")
        self.device = resolve_device(device)
        self.cfg, self.params = cfg, params
        self.n_slots, self.max_len = n_slots, max_len
        self.stop_tokens = set(stop_tokens)
        self.session_pool = session_pool
        self.paged = paged
        # per-step prompt-token budget: each step drains at most this many
        # prompt tokens before decoding, so a long admission never stalls
        # the resident decoders for its whole prefill (None = unbounded)
        self.prefill_chunk_tokens = prefill_chunk_tokens
        self.slots: List[Optional[SlotState]] = [None] * n_slots
        self.queue: List = []
        self.finished: List[FinishedRequest] = []
        self._submit_times: Dict[int, float] = {}
        self._next_tok = np.zeros((n_slots,), np.int32)
        self._req_seq = 0
        # host-side so lanes that must not decode are pushed past the
        # trimmed table without a device round trip
        self._pos = np.zeros((n_slots,), np.int32)
        # the paged mode's per-slot pages and chunk-plan FIFO (both stay
        # empty in full-width mode)
        self.slot_pages: List[List[int]] = [[] for _ in range(n_slots)]
        self._prefill_fifo: List[int] = []
        if not paged:
            self.allocator = None
            self.caches = make_decode_caches(cfg, n_slots, max_len, device=self.device)
            return

        # one shared page pool backs every decode lane AND every session
        # entry; the default budget is the full-width worst case
        if kv_pages is None:
            cap = session_pool.capacity if session_pool is not None else 0
            kv_pages = 1 + (n_slots + cap) * (max_len // page_size)
        self.allocator = PagedKVAllocator(
            cfg, page_size=page_size, n_pages=kv_pages, device=self.device,
            share_prefixes=share_prefixes,
        )
        if session_pool is not None:
            if session_pool.allocator is not None:
                raise ValueError("session pool already bound to another allocator")
            session_pool.allocator = self.allocator
            # pages are the memory bound: the entry cap must never evict
            # before the page budget does (every entry holds >= 1 page)
            session_pool.capacity = max(session_pool.capacity, kv_pages)
        self.caches = None
        # the table lives on the host and is uploaded once per step
        self._table = np.full((n_slots, max_len // page_size), SCRATCH_PAGE, np.int32)
        self._kv_pos = torch.full((n_slots, max_len), -1, dtype=torch.int32, device=self.device)
        self._prefiller = PagedPrefiller(cfg, params, self.allocator, self.device)
        self._iota = torch.arange(max_len, dtype=torch.int32, device=self.device)

    # ------------------------------------------------------------------
    def submit(
        self, token_ids: List[int], max_new: int = 32, cache_key: Optional[str] = None
    ) -> int:
        """Queue a request. With ``cache_key`` and a ``session_pool``, the
        request reuses any cached KV prefix for that key on admission and
        registers its final KV state back under the key on completion.
        Overlong inputs are truncated here, oldest tokens first, exactly as
        the single-stream service truncates them."""
        ids, max_new = truncate_for_cache([], list(token_ids), self.max_len, max_new)
        rid = self._req_seq
        self._req_seq += 1
        self.queue.append((rid, ids, max_new, cache_key))
        self._submit_times[rid] = time.perf_counter()
        return rid

    @property
    def busy(self) -> bool:
        return any(s is not None for s in self.slots) or bool(self.queue)

    @staticmethod
    def _cache_bytes(caches) -> int:
        """Bytes of the k/v tensors of a cache list (kv_pos excluded)."""
        return sum(c[name].numel() * c[name].element_size() for c in caches for name in ("k", "v"))

    def resident_kv_bytes(self) -> int:
        """KV bytes held between steps: the pages in use for the paged
        server (slots and session entries share the pool); for the
        full-width server, the always-allocated lanes plus every pool entry
        (a paged entry at its page cost)."""
        if self.paged:
            return self.allocator.resident_kv_bytes
        total = self._cache_bytes(self.caches)
        pool = self.session_pool
        if pool is not None:
            for e in pool._entries.values():
                if e.paged and pool.allocator is not None:
                    total += len(e.pages) * pool.allocator.page_bytes
                elif e.caches is not None:
                    total += self._cache_bytes(e.caches)
        return total

    def total_kv_bytes(self) -> int:
        """Worst-case KV budget this server can consume."""
        if self.paged:
            return self.allocator.total_kv_bytes
        total = self._cache_bytes(self.caches)
        pool = self.session_pool
        if pool is None:
            return total
        if pool.allocator is not None:
            return total + pool.allocator.total_kv_bytes
        return total + pool.capacity * (total // max(1, self.n_slots))

    # -- slot admission -------------------------------------------------
    def _insert_slot(
        self, idx: int, rid: int, ids: List[int], max_new: int,
        cache_key: Optional[str] = None,
    ) -> bool:
        """Admit one queued request into free slot ``idx``. Returns False
        when the page pool can't cover it even after reclaiming evictable
        session entries — the caller keeps it queued."""
        n = len(ids)
        # submit() truncates at the queue boundary: tripping this means a
        # caller bypassed the queue
        assert n < self.max_len, (n, self.max_len)
        entry, usable = None, 0
        if self.session_pool is not None and cache_key is not None:
            entry, usable = self.session_pool.match(cache_key, ids)
        if self.paged:
            return self._admit_paged(idx, rid, ids, max_new, entry, usable, cache_key)

        if entry is not None and usable > 0:
            if entry.paged:
                # a pool whose entries are paged (shared with a paged
                # engine on the node): fresh buffers, kv_pos masked to usable
                base = self.session_pool.materialize(entry, usable, self.max_len)
            else:
                # the pool keeps the entry: append into a copy
                base = clone_caches(entry.caches)
                if usable < entry.pos:
                    base = trim_cache_prefix(base, usable)
            logits, one, _ = self._append_suffix(base, ids[usable:], usable)
        else:
            usable = 0
            logits, one, _ = self._bucketed_prefill(ids)
        for big, small in zip(self.caches, one):
            for name in big:
                if isinstance(big[name], dict):    # a gemma pair's local / global
                    for sub in big[name]:
                        self._put_entry(big[name][sub], small[name][sub], idx, sub)
                else:
                    self._put_entry(big[name], small[name], idx, name)
        warm_source = (
            warm_source_of(entry.source) if entry is not None and usable > 0 else "none"
        )
        self._pos[idx] = n
        self._next_tok[idx] = int(torch.argmax(logits[0]))
        now = time.perf_counter()
        self.slots[idx] = SlotState(
            request_id=rid, pos=n, max_new=max_new,
            cache_key=cache_key, token_ids=list(ids), reused_tokens=usable,
            warm_start=warm_source != "none", warm_source=warm_source, prefilled=True,
            ttft_ms=(now - self._submit_times[rid]) * 1e3, last_tok_t=now,
        )
        return True

    def _bucketed_prefill(self, ids: List[int]):
        """From-scratch B = 1 prefill (bucket 16, as JAX)."""
        return bucketed_prefill(self.params, self.cfg, ids, self.max_len, 16, self.device)

    def _append_suffix(self, caches, suffix_ids: List[int], p0: int):
        """Chunk-prefill ``suffix_ids`` into B = 1 ``caches`` (in place) from
        ``p0`` — the reuse path of slot admission, with smaller chunks and
        buckets than the single-stream engine (128 and 16, as JAX)."""
        return chunked_append(self.params, self.cfg, caches, suffix_ids, p0, 128, 16)

    @staticmethod
    def _put_entry(big: torch.Tensor, small: torch.Tensor, idx: int, name: str) -> None:
        """Copy a B = 1 cache into lane ``idx`` of the batch, in place."""
        if name in ("k", "v"):            # (L, B, T, KV, Dh)
            t = min(big.shape[2], small.shape[2])
            big[:, idx, :t] = small[:, 0, :t]
        else:                             # kv_pos (B, T)
            t = min(big.shape[1], small.shape[1])
            big[idx, :t] = small[0, :t]

    def _alloc_pages(self, m: int, exclude: Optional[str] = None) -> Optional[List[int]]:
        """Allocate ``m`` pages, reclaiming page-budgeted LRU session
        entries (never ``exclude`` — the entry being reused) on pressure."""
        pages = self.allocator.alloc(m)
        if pages is None and self.session_pool is not None:
            self.session_pool.reclaim(m, exclude=exclude)
            pages = self.allocator.alloc(m)
        return pages

    def _reclaimable_pages(self, exclude: Optional[str]) -> int:
        """Pages the pool could return to the free list by evicting every
        entry except ``exclude``: only pages whose sole reference is the
        entry (pages shared with a live slot survive eviction)."""
        pool = self.session_pool
        if pool is None:
            return 0
        return sum(
            1
            for k, e in pool._entries.items()
            if k != exclude and e.paged
            for p in e.pages
            if self.allocator.refcount(p) == 1
        )

    def _admit_paged(
        self, idx: int, rid: int, ids: List[int], max_new: int,
        entry: Optional[CacheEntry], usable: int, cache_key: Optional[str],
    ) -> bool:
        """Paged admission only PLANS: pick the best shared prefix, incref
        its pages, allocate fresh pages out to ``n + 1`` positions (the
        first decode token writes at pos ``n``), and queue the uncovered
        prompt tokens as a chunk plan for :meth:`step` to drain.

        Three share candidates, best coverage wins, earlier wins ties: the
        key's own pool entry (coverage may end mid-page: the donor's tail
        page is copied into this lane's first fresh page), the
        cross-session content index (full pages only), and a same-wave
        active lane's prompt (:meth:`_same_wave_match`). Shared pages are
        read-only (``n_skip`` drops any chunk write into them). Coverage is
        capped at ``n - 1`` so the last chunk computes the first-token
        logits. Feasibility is checked first — fresh pages needed against
        free plus genuinely reclaimable — so a blocked request neither
        evicts other tenants' entries for nothing nor churns pages."""
        alloc, pool = self.allocator, self.session_pool
        ps = alloc.page_size
        n = len(ids)
        usable = min(usable, n - 1)
        cross = alloc.match_prefix(ids, n - 1)
        wave = self._same_wave_match(ids)
        kind, cover = ("entry", usable) if usable > 0 else ("none", 0)
        if len(cross) * ps > cover:
            kind, cover = "cross", len(cross) * ps
        if len(wave) * ps > cover:
            kind, cover = "wave", len(wave) * ps
        warm_source = warm_source_of(entry.source) if kind == "entry" else "none"

        skip = cover // ps  # leading read-only full shared pages
        tail_src: Optional[int] = None
        if kind == "entry" and cover % ps:
            tail_src = entry.pages[skip]
        fresh_needed = alloc.pages_for(n + 1) - skip
        if fresh_needed > alloc.n_free + self._reclaimable_pages(cache_key):
            return False
        shared = {
            "entry": lambda: list(entry.pages[:skip]),
            "cross": lambda: list(cross[:skip]),
            "wave": lambda: list(wave[:skip]),
            "none": lambda: [],
        }[kind]()
        if shared:
            # incref BEFORE any reclaim: evicting the donor entry must not
            # release pages we are about to share
            alloc.incref(shared)
        fresh = self._alloc_pages(fresh_needed, exclude=cache_key)
        if fresh is None:
            if shared:
                alloc.decref(shared)
            return False
        pages = shared + fresh
        if tail_src is not None:
            alloc.copy_page(tail_src, fresh[0])
        if kind in ("cross", "wave") and pool is not None:
            pool.shared_hits += 1
            pool.shared_tokens += cover

        self.slot_pages[idx] = pages
        self._table[idx, :] = alloc.table_for(pages, self.max_len)
        self._pos[idx] = n
        self.slots[idx] = SlotState(
            request_id=rid, pos=n, max_new=max_new,
            cache_key=cache_key, token_ids=list(ids), reused_tokens=cover,
            warm_start=warm_source != "none", warm_source=warm_source,
            prefilled=False, pending=list(ids[cover:]), prefill_p0=cover,
            n_skip=skip,
        )
        self._prefill_fifo.append(idx)
        return True

    def _same_wave_match(self, ids: List[int]) -> List[int]:
        """Shared-prefix pages from an ACTIVE lane's prompt: the content
        index sees pages only once a chunk completes, so an admission in
        the same step as its donor matches the other slots' prompt tokens
        directly. Only the donor's full prompt pages count, capped at
        ``n - 1`` reader tokens. Safe under the strict FIFO drain: the
        donor's chunks covering these pages complete before this reader's
        first chunk runs, and the donor's decode writes land at
        ``pos >= lcp``, never inside the shared region."""
        if not self.allocator.share_prefixes:
            return []
        ps = self.allocator.page_size
        best: List[int] = []
        for j, st in enumerate(self.slots):
            if st is None or not self.slot_pages[j]:
                continue
            lcp = longest_common_prefix(st.token_ids, ids)
            full = min(lcp, len(ids) - 1) // ps
            if full > len(best):
                best = list(self.slot_pages[j][:full])
        return best

    def _drain_prefill(self) -> None:
        """Drain up to ``prefill_chunk_tokens`` prompt tokens from the chunk
        plans, strict FIFO admission order. Chunks end on page boundaries
        (except a plan's final one), so every completed chunk leaves final
        pages, which are content-indexed right away for later same-wave
        admissions. A plan's last chunk yields the request's first decode
        token: ttft stops there and the lane decodes this very step."""
        if not self._prefill_fifo:
            return
        alloc = self.allocator
        ps = alloc.page_size
        budget = self.prefill_chunk_tokens
        if budget is not None:
            budget = max(ps, budget)
        spent = 0
        while self._prefill_fifo:
            if budget is not None and spent >= budget:
                break
            idx = self._prefill_fifo[0]
            st = self.slots[idx]
            assert st is not None and not st.prefilled, idx
            left = len(st.pending)
            cap = 256 if budget is None else min(256, budget - spent)
            c = min(left, cap)
            if c < left:
                # end the chunk on a page boundary: completed pages are
                # final and indexable, and the next chunk starts aligned
                aligned = (st.prefill_p0 + c) // ps * ps - st.prefill_p0
                if aligned > 0:
                    c = aligned
            chunk, st.pending = st.pending[:c], st.pending[c:]
            logits = self._prefiller.run_chunk(
                self.slot_pages[idx], chunk, st.prefill_p0, n_skip=st.n_skip
            )
            st.prefill_p0 += c
            spent += c
            covered = min(st.prefill_p0, len(st.token_ids)) // ps
            if covered > 0:
                alloc.register_pages(
                    st.token_ids[: covered * ps], self.slot_pages[idx][:covered]
                )
            if not st.pending:
                self._prefill_fifo.pop(0)
                st.prefilled = True
                self._next_tok[idx] = int(torch.argmax(logits))
                now = time.perf_counter()
                st.ttft_ms = (now - self._submit_times[st.request_id]) * 1e3
                st.last_tok_t = now
                # kv_pos becomes real only now: slot == position for the
                # whole prompt, invalid beyond (layout invariant)
                self._kv_pos[idx] = torch.where(
                    self._iota < st.pos, self._iota, torch.full_like(self._iota, -1)
                )

    def _shared_prefix_run(self, width: int) -> List[int]:
        """Longest run of leading pages IDENTICAL across every decode-ready
        lane's table, bucketed down to a power of two (as JAX, which
        compiles one shared-pass shape per bucket) and capped below
        ``width`` so each lane's suffix pass keeps >= 1 page. Identical
        page ids across >= 2 lanes means refcount >= 2, hence inside every
        holder's read-only shared region, so the run holds positions
        ``[0, run * page_size)`` for every lane all step. Mid-prefill lanes
        are excluded: their decode output is never read, so they must not
        shorten the residents' run."""
        active = [
            self.slot_pages[i]
            for i, s in enumerate(self.slots)
            if s is not None and s.prefilled
        ]
        if len(active) < 2:
            return []
        first = active[0]
        limit = min(min(len(p) for p in active), width - 1)
        run = 0
        while run < limit and all(p[run] == first[run] for p in active[1:]):
            run += 1
        if run == 0:
            return []
        b = 1
        while b * 2 <= run:
            b *= 2
        return first[:b]

    # -- slot completion -> pool write-back -----------------------------
    def _release_to_pool(self, idx: int, st: SlotState) -> None:
        """Register the finished slot's KV in the session pool so the next
        turn of this session is suffix-only. Paged mode MOVES the slot's
        pages into the pool entry (zero-copy; pages past the kept prefix are
        freed); full-width mode copies the slot's lane out of the batch —
        a copy, not a view: the next admission into this slot overwrites
        the lane."""
        prefix = st.token_ids + st.generated
        if not self.paged:
            if any("kv_pos" not in c for c in self.caches):
                return  # a gemma pair's ring caches: not pooled, as in JAX
            one = [
                {"k": c["k"][:, idx : idx + 1].clone(), "v": c["v"][:, idx : idx + 1].clone(),
                 "kv_pos": c["kv_pos"][idx : idx + 1]}
                for c in self.caches
            ]
            self.session_pool.put(
                st.cache_key,
                CacheEntry(token_ids=prefix, caches=trim_cache_prefix(one, len(prefix)),
                           source="serve"),
            )
            return
        pages = self.slot_pages[idx]
        keep = self.allocator.pages_for(len(prefix))
        if keep < len(pages):
            self.allocator.decref(pages[keep:])
        self.slot_pages[idx] = []
        self.session_pool.put(
            st.cache_key,
            CacheEntry(token_ids=prefix, pages=pages[:keep], source="serve"),
        )

    def _finish_slot(self, idx: int, st: SlotState) -> None:
        """Retire a slot: write its KV back to the session pool (or free its
        pages), record the FinishedRequest, and open the slot."""
        if self.session_pool is not None and st.cache_key is not None:
            self._release_to_pool(idx, st)
        elif self.slot_pages[idx]:
            self.allocator.decref(self.slot_pages[idx])
            self.slot_pages[idx] = []
        if self.paged:
            # an open lane keeps riding the batched call against the scratch
            # page until re-admitted; its kv_pos row is junk but unread
            self._table[idx, :] = SCRATCH_PAGE
        gaps = st.gaps_ms
        self.finished.append(
            FinishedRequest(
                st.request_id,
                st.generated,
                self._submit_times.pop(st.request_id),
                time.perf_counter(),
                cache_hit=st.reused_tokens > 0,
                reused_tokens=st.reused_tokens,
                warm_start=st.warm_start,
                warm_source=st.warm_source,
                batch_size=st.batch_size,
                ttft_ms=st.ttft_ms,
                decode_p50_ms=float(np.percentile(gaps, 50)) if gaps else 0.0,
                decode_p99_ms=float(np.percentile(gaps, 99)) if gaps else 0.0,
            )
        )
        self.slots[idx] = None

    def _admit_from_queue(self) -> None:
        """FIFO-fair admission: walk the whole queue in order, admitting
        each feasible request into a free slot and skipping (not blocking
        on) requests the pool can't cover yet; a skipped request keeps its
        queue position."""
        free = [i for i in range(self.n_slots) if self.slots[i] is None]
        if not free or not self.queue:
            return
        admitted_any = False
        remaining: List = []
        for item in self.queue:
            if not free:
                remaining.append(item)
                continue
            rid, ids, max_new, cache_key = item
            if self._insert_slot(free[0], rid, ids, max_new, cache_key):
                free.pop(0)
                admitted_any = True
            else:
                remaining.append(item)
        self.queue = remaining
        if admitted_any or not self.queue:
            return
        if any(s is not None for s in self.slots):
            return  # out of pages: retry once running slots release them
        # nothing active, nothing admitted: the only reclaimable pages may
        # be the head request's own entry (excluded as the reuse donor) —
        # evict it and admit cold rather than failing the node service
        rid, ids, max_new, cache_key = self.queue[0]
        if (
            self.session_pool is not None and cache_key is not None
            and cache_key in self.session_pool
        ):
            self.session_pool.invalidate(cache_key)
            if self._insert_slot(free[0], rid, ids, max_new, cache_key):
                self.queue.pop(0)
                return
        raise RuntimeError(
            f"paged KV pool too small: request of {len(ids)} tokens "
            f"cannot be admitted with {self.allocator.n_free} free "
            f"pages of {self.allocator.page_size} and nothing left "
            "to evict — raise kv_pages or lower max_len"
        )

    def _grow_and_plan(self) -> Optional[DecodePlan]:
        """Grow-on-demand, then plan this step's batched decode (None when
        no lane is decode-ready). Each decode-ready slot needs a page
        covering the position it is about to write; one that cannot get it
        retires with the tokens it has. The table width is the smallest
        power of two covering the longest ready lane (at most log2(MP)
        shapes, as in JAX); lanes that must not decode (mid-prefill, open)
        get position ``w * page_size`` so their writes drop; with the
        kernels selected, the ready lanes' common leading pages become the
        cascade's shared run."""
        ps = self.allocator.page_size
        for idx, st in enumerate(self.slots):
            if st is None or not st.prefilled:
                continue
            if st.pos >= len(self.slot_pages[idx]) * ps:
                fresh = self._alloc_pages(1, exclude=st.cache_key)
                if fresh is None:
                    self._finish_slot(idx, st)
                    continue
                self.slot_pages[idx].append(fresh[0])
                self._table[idx, len(self.slot_pages[idx]) - 1] = fresh[0]
        ready = [i for i, s in enumerate(self.slots) if s is not None and s.prefilled]
        if not ready:
            return None
        mp = self._table.shape[1]
        need = max(len(self.slot_pages[i]) for i in ready)
        w = 1
        while w < max(1, need):
            w *= 2
        w = min(w, mp)
        dec_pos = self._pos.copy()
        for i, s in enumerate(self.slots):
            if s is None or not s.prefilled:
                dec_pos[i] = w * ps
        run = self._shared_prefix_run(w) if self.cfg.attn_impl != "reference" else []
        return DecodePlan(ready=ready, w=w, dec_pos=dec_pos, shared_run=run)

    def decode_inputs(self, plan: DecodePlan) -> Tuple[torch.Tensor, ...]:
        """The step's decode operands on the device, from ONE host-to-device
        copy: ``(table (B, w), tokens (B, 1), pos (B,), shared_pages (S,) or
        None)``."""
        b, w = self.n_slots, plan.w
        host = np.concatenate([
            self._table[:, :w].reshape(-1), self._next_tok, plan.dec_pos,
            np.asarray(plan.shared_run, np.int32),
        ]).astype(np.int32)
        dev = torch.from_numpy(host).to(self.device)
        o = b * w
        table = dev[:o].view(b, w)
        tokens = dev[o : o + b].view(b, 1)
        pos = dev[o + b : o + 2 * b]
        shared = dev[o + 2 * b :] if plan.shared_run else None
        return table, tokens, pos, shared

    def step(self) -> None:
        """One unified scheduler tick: admit queued requests FIFO-fairly,
        drain up to ``prefill_chunk_tokens`` prompt tokens from the chunk
        plans, then decode the decode-ready lanes in one batched call
        (with the shared-prefix cascade when they share leading pages)."""
        self._admit_from_queue()
        # drain BEFORE counting decoders: a plan completing within this
        # step's budget decodes its first token this very step
        self._drain_prefill()
        n_active = sum(s is not None for s in self.slots)
        if n_active == 0:
            return
        for st in self.slots:
            if st is not None:
                st.batch_size = max(st.batch_size, n_active)
        if self.paged:
            plan = self._grow_and_plan()
            if plan is None:
                return  # every occupied lane is mid-prefill
            table, tokens, pos, shared = self.decode_inputs(plan)
            wp = plan.w * self.allocator.page_size
            # the trimmed kv_pos is made contiguous once per step (the
            # kernels take it contiguous), updated in place by the decode,
            # written back
            kv_pos = self._kv_pos[:, :wp].contiguous()
            logits = decode_step_paged(
                self.params, self.cfg, self.allocator.pools, table, kv_pos, tokens, pos,
                shared,
            )
            if kv_pos.data_ptr() != self._kv_pos.data_ptr():
                self._kv_pos[:, :wp] = kv_pos
        else:
            # every lane decodes, an empty one into its own lane at its
            # stale position (write_step clamps; the lane is rewritten
            # whole at its next admission); one upload carries tokens and
            # positions
            b = self.n_slots
            host = np.concatenate([self._next_tok, self._pos]).astype(np.int32)
            dev = torch.from_numpy(host).to(self.device)
            logits, self.caches = decode_step(
                self.params, self.cfg, self.caches, dev[:b].view(b, 1), dev[b:]
            )
        nxt = sample(logits[:, 0]).cpu().numpy()   # the step's one host sync
        now = time.perf_counter()

        for idx, st in enumerate(self.slots):
            if st is None or not st.prefilled:
                continue
            tok = int(self._next_tok[idx])
            st.generated.append(tok)
            st.pos += 1
            self._pos[idx] += 1
            if st.last_tok_t is not None:
                st.gaps_ms.append((now - st.last_tok_t) * 1e3)
            st.last_tok_t = now
            if (
                tok in self.stop_tokens
                or len(st.generated) >= st.max_new
                or st.pos >= self.max_len - 1
            ):
                self._finish_slot(idx, st)
            else:
                self._next_tok[idx] = int(nxt[idx])

    # -- churn -----------------------------------------------------------
    def crash(self) -> None:
        """Process crash: queue, in-flight slots and the session KV pool are
        volatile — drop everything; every page returns to the free list."""
        self.queue.clear()
        self._submit_times.clear()
        for idx in range(self.n_slots):
            self.slots[idx] = None
            if self.slot_pages[idx]:
                self.allocator.decref(self.slot_pages[idx])
                self.slot_pages[idx] = []
        if self.paged:
            self._table[:, :] = SCRATCH_PAGE
        self._prefill_fifo.clear()
        if self.session_pool is not None:
            self.session_pool.clear()
        self.finished.clear()

    def run_to_completion(self, max_steps: int = 10_000) -> List[FinishedRequest]:
        steps = 0
        while self.busy and steps < max_steps:
            self.step()
            steps += 1
        return self.finished

    # -- migration warm-start -------------------------------------------
    def prime(self, cache_key: str, token_ids: List[int]) -> bool:
        """Pre-warm the shared session pool with the KV state of
        ``token_ids`` (the batched twin of ``InferenceEngine.prime``): in
        paged mode chunk-prefilled straight into fresh pages, in full-width
        mode through a dense lane. A later ``submit(..., cache_key=...)``
        admits suffix-only."""
        return self._prime(cache_key, token_ids, None, 0, "prime")

    def _prime_paged_fill(
        self, token_ids: List[int], entry: Optional[CacheEntry], usable: int,
        shipped: Optional[List[bytes]] = None, ship_have: int = 0,
    ) -> Optional[List[int]]:
        return prime_fill_pages(
            self.session_pool, self._prefiller, token_ids, entry, usable,
            shipped=shipped, ship_have=ship_have,
        )

    def install_shipped_pages(
        self,
        cache_key: str,
        token_ids: List[int],
        payloads: List[bytes],
        have_pages: int,
    ) -> bool:
        """Install digest-verified shipped KV pages into the shared session
        pool (the batched twin of ``InferenceEngine.install_shipped_pages``).
        Paged servers only: a full-width server has no page pool to import
        into, and the shipper falls back to token recompute."""
        if not self.paged:
            return False
        return self._prime(cache_key, token_ids, payloads, have_pages, "ship")

    def _prime(
        self, cache_key: str, token_ids: List[int],
        shipped: Optional[List[bytes]], have_pages: int, source: str,
    ) -> bool:
        if self.session_pool is None:
            return False
        paged_fill = None
        if self.paged:
            paged_fill = lambda ids, entry, usable: self._prime_paged_fill(  # noqa: E731
                ids, entry, usable, shipped, have_pages
            )
        warm, _ = prime_session_pool(
            self.session_pool, cache_key, list(token_ids), self.max_len, self.max_len - 2,
            self._append_suffix, self._bucketed_prefill, paged_fill=paged_fill, source=source,
        )
        return warm


@dataclass
class _PendingBatched:
    """Per-request bookkeeping between BatchedLLMService.submit and the
    pump observing its FinishedRequest (sim-clock ms)."""

    on_done: Callable[[ServiceResult], None]
    submitted_ms: float
    n_input: int
    admitted_ms: Optional[float] = None


class BatchedLLMService:
    """The :class:`BatchedServer` mounted as a node's LLM Service — the
    counterpart of ``repro.serving.scheduler.BatchedLLMService``. It
    implements ``repro_torch.core.manager.LLMServiceProtocol`` with
    ``capabilities().batched`` set: concurrent sessions on the node share
    the server's continuous decode batch and session KV pool.

    Sim-clock model: each :meth:`submit` enqueues into the server and
    ensures a *pump* event chain runs on the network's clock
    (``net.clock.now_ms``, ``net.schedule``). Every pump runs exactly one
    ``server.step()`` (real work, wall-measured, ending in the step's host
    sync) and lays that duration onto the sim clock, so requests admitted
    together share each step's cost. Per request, ``queue_ms`` is
    submit -> admission and ``inference_ms`` admission -> completion.
    ``completion()`` is the blocking shim."""

    def __init__(
        self,
        model: str,
        server: BatchedServer,
        tokenizer: ByteLevelBPE,
        tokenize_scale: float = 1.0,
        ship_prefill_ms_per_token: float = 0.0,
    ) -> None:
        self.model = model
        self.server = server
        self.tokenizer = tokenizer
        # clock factor of the node's CPU class for tokenization time, read
        # by the context manager that mounts this service
        self.tokenize_scale = tokenize_scale
        # measured prefill constant for the KV-ship cost model (0 = this
        # node does not take part in page shipping)
        self.ship_prefill_ms_per_token = ship_prefill_ms_per_token
        self._pending: Dict[int, _PendingBatched] = {}
        self._pump_scheduled = False
        self._busy_until = 0.0
        self._seen_finished = 0
        self._clock_owner: Optional[object] = None
        # bumped by crash(): pump events scheduled before it become no-ops
        self._pump_epoch = 0

    @classmethod
    def create(
        cls,
        model: str,
        cfg: ModelConfig,
        *,
        seed: int = 0,
        tokenizer_seed: int = 0,
        n_slots: int = 4,
        max_len: int = 512,
        session_cache_capacity: int = 8,
        paged: bool = False,
        page_size: int = 16,
        kv_pages: Optional[int] = None,
        share_prefixes: bool = True,
        prefill_chunk_tokens: Optional[int] = 64,
        device: DeviceLike = None,
        params: Optional[Dict] = None,
    ) -> "BatchedLLMService":
        """A batched service on ``device`` (default ``"cuda"``; raises
        without a GPU unless ``device="cpu"``). Weights are drawn from
        ``seed`` unless ``params`` (e.g. bridged JAX weights) are given.
        ``paged=False`` (the default, as in JAX) is the full-width server;
        ``paged=True`` falls back to it, as JAX's does, for a model whose
        caches cannot be appended to (gemma2's ring caches)."""
        dev = resolve_device(device)
        if params is None:
            params = init_params(cfg, seed, dev)
        pool = (
            SessionCachePool(capacity=session_cache_capacity)
            if session_cache_capacity > 0 and supports_append(cfg)
            else None
        )
        server = BatchedServer(
            cfg, params, n_slots=n_slots, max_len=max_len, session_pool=pool,
            paged=paged and supports_append(cfg), page_size=page_size, kv_pages=kv_pages,
            share_prefixes=share_prefixes, prefill_chunk_tokens=prefill_chunk_tokens,
            device=dev,
        )
        tok = get_tokenizer(cfg.vocab_size, seed=tokenizer_seed, name=model)
        return cls(model=model, server=server, tokenizer=tok)

    # -- LLMServiceProtocol ---------------------------------------------
    def capabilities(self) -> ServiceCapabilities:
        return ServiceCapabilities(
            prime=self.server.session_pool is not None,
            kv_reuse=self.server.session_pool is not None,
            batched=True,
            n_slots=self.server.n_slots,
        )

    def prime(self, cache_key: str, token_ids: List[int]) -> bool:
        return self.server.prime(cache_key, list(token_ids))

    # -- KV-page shipping hooks -----------------------------------------
    def kv_ship_profile(self) -> Optional[NodeShipProfile]:
        """Shipping constants for the cost model; None for a full-width
        server, without a session pool or without a measured prefill
        constant."""
        srv = self.server
        if not srv.paged or srv.session_pool is None or self.ship_prefill_ms_per_token <= 0:
            return None
        return NodeShipProfile(
            page_size=srv.allocator.page_size,
            page_wire_bytes=srv.allocator.page_bytes,
            prefill_ms_per_token=self.ship_prefill_ms_per_token,
        )

    def export_kv_pages(self, cache_key: str) -> Optional[PageShipment]:
        return export_entry_pages(self.server.session_pool, cache_key)

    def install_kv_pages(
        self, cache_key: str, token_ids: List[int], payloads: List[bytes], have_pages: int,
    ) -> bool:
        return self.server.install_shipped_pages(
            cache_key, list(token_ids), payloads, have_pages
        )

    def resident_ship_pages(self, cache_key: str, token_ids: List[int]) -> int:
        return resident_entry_pages(self.server.session_pool, cache_key, token_ids)

    def resident_keys(self) -> Dict[str, int]:
        """Cache key -> resident KV token count (fleet telemetry). Active
        slots count too: their KV is on the device and lands in the pool
        when they finish."""
        pool = self.server.session_pool
        resident = pool.resident_keys() if pool is not None else {}
        for st in self.server.slots:
            if st is not None and st.cache_key is not None:
                resident[st.cache_key] = max(resident.get(st.cache_key, 0), st.pos)
        return resident

    def crash(self) -> None:
        """Process crash: drop pending bookkeeping and the server's queue,
        slots and session pool; pump events already scheduled become
        no-ops (the manager has failed the in-flight turns)."""
        self._pump_epoch += 1
        self._pending.clear()
        self._pump_scheduled = False
        self._busy_until = 0.0
        self.server.crash()
        self._seen_finished = 0

    def submit(
        self,
        context_ids: List[int],
        prompt_ids: List[int],
        max_new_tokens: int,
        cache_key: Optional[str] = None,
        *,
        net,
        on_done: Callable[[ServiceResult], None],
    ) -> None:
        if self._clock_owner is not net:
            if self._pending:
                raise RuntimeError("batched service is bound to a live cluster")
            self._clock_owner = net
            self._busy_until = 0.0
            self._pump_scheduled = False
        ids, max_new = truncate_for_cache(
            context_ids, prompt_ids, self.server.max_len, max_new_tokens
        )
        rid = self.server.submit(ids, max_new=max_new, cache_key=cache_key)
        self._pending[rid] = _PendingBatched(
            on_done=on_done, submitted_ms=net.clock.now_ms, n_input=len(ids)
        )
        self._ensure_pump(net)

    def completion(
        self,
        context_ids: List[int],
        prompt_ids: List[int],
        max_new_tokens: int,
        cache_key: Optional[str] = None,
    ) -> ServiceResult:
        """Blocking shim: run the request (and anything already queued) to
        completion on the server, contention-free accounting."""
        if self._pending:
            raise RuntimeError(
                "blocking completion() cannot interleave with in-flight submit() "
                "requests — drive the event loop instead"
            )
        ids, max_new = truncate_for_cache(
            context_ids, prompt_ids, self.server.max_len, max_new_tokens
        )
        t0 = time.perf_counter()
        rid = self.server.submit(ids, max_new=max_new, cache_key=cache_key)
        done: Dict[int, FinishedRequest] = {}
        while rid not in done:
            self.server.step()
            for f in self.server.finished[self._seen_finished:]:
                done[f.request_id] = f
            self._seen_finished = len(self.server.finished)
        self._drain_consumed()
        return self._result_from(
            done[rid], n_input=len(ids),
            inference_ms=(time.perf_counter() - t0) * 1e3, queue_ms=0.0,
        )

    def _drain_consumed(self) -> None:
        """Drop finished entries already turned into results: a mounted
        server lives as long as its node."""
        if self._seen_finished == len(self.server.finished):
            self.server.finished.clear()
            self._seen_finished = 0

    # -- the pump event chain -------------------------------------------
    def _ensure_pump(self, net) -> None:
        if self._pump_scheduled:
            return
        self._pump_scheduled = True
        net.schedule(
            max(net.clock.now_ms, self._busy_until),
            lambda e=self._pump_epoch: self._pump(net, e),
        )

    def _pump(self, net, epoch: Optional[int] = None) -> None:
        """One scheduler tick on the sim clock: admissions are recorded at
        the tick's start, the step's wall time becomes the tick's duration,
        and completions resolve at its end."""
        if epoch is not None and epoch != self._pump_epoch:
            return  # scheduled before a crash — the server was reset
        self._pump_scheduled = False
        if not self.server.busy:
            return
        t = net.clock.now_ms
        queued_before = {q[0] for q in self.server.queue}
        w0 = time.perf_counter()
        self.server.step()
        end = t + (time.perf_counter() - w0) * 1e3
        self._busy_until = end
        for rid in queued_before - {q[0] for q in self.server.queue}:
            if rid in self._pending:
                self._pending[rid].admitted_ms = t
        for f in self.server.finished[self._seen_finished:]:
            p = self._pending.pop(f.request_id, None)
            if p is None:
                continue  # submitted via the blocking shim
            admitted = p.admitted_ms if p.admitted_ms is not None else t
            result = self._result_from(
                f, n_input=p.n_input, inference_ms=end - admitted,
                queue_ms=admitted - p.submitted_ms,
            )
            net.schedule(end, lambda r=result, cb=p.on_done: cb(r))
        self._seen_finished = len(self.server.finished)
        self._drain_consumed()
        if self.server.busy:
            self._pump_scheduled = True
            net.schedule(end, lambda e=self._pump_epoch: self._pump(net, e))

    def _result_from(
        self, f: FinishedRequest, n_input: int, inference_ms: float, queue_ms: float,
    ) -> ServiceResult:
        stop = self.server.stop_tokens
        text = self.tokenizer.decode([t for t in f.token_ids if t not in stop])
        return ServiceResult(
            text=text,
            token_ids=list(f.token_ids),
            inference_ms=inference_ms,
            cache_hit=f.cache_hit,
            reused_tokens=f.reused_tokens,
            prefill_tokens=n_input - f.reused_tokens,
            warm_start=f.warm_start,
            warm_source=f.warm_source,
            queue_ms=queue_ms,
            batch_size=f.batch_size,
            ttft_ms=f.ttft_ms,
            decode_p50_ms=f.decode_p50_ms,
            decode_p99_ms=f.decode_p99_ms,
        )
