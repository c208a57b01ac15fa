"""PyTorch inference engine — the LLM Service behind the Context Manager
(the counterpart of ``repro.serving.engine``).

The completion entry point takes a pre-tokenized context plus prompt token
ids (the paper's llama.cpp extension, §4.1). Two routes, as in JAX:

- **paged** (a session pool bound to a page allocator, ``page_size`` and
  ``kv_pages`` > 0, and a ``cache_key``): the ``context_ids + prompt_ids``
  are matched against the session pool and the cross-session content
  index, the uncovered suffix is chunk-prefilled straight into KV pages
  (K3), decode runs through the page table (K1), and the pages move into
  the pool entry afterwards;
- **dense** (the default ``page_size=0``, every keyless request, every
  turn of a ``kv_reuse=False`` service, and a paged request the page pool
  cannot take — counted in ``paged_fallbacks``): a full prefill (K4) into
  a ``max_len``-width B = 1 cache, or on a session hit a chunk append of
  the suffix (K4) into a copy of the stored cache, then decode against it
  (K5); a keyed turn stores the cache in the pool afterwards (a paged pool
  writes it into pages).

An SSM or hybrid model (Mamba2, Zamba2) takes the dense route only, as in
JAX: its state cannot be extended in place, so it gets no session pool,
and every turn is a bucketed full prefill (each mamba layer's SSD through
K6, Zamba2's shared attention through K4) and then decode (K5 for the
shared block).

On a GPU every attention step and every SSD chunk runs a hand-written CUDA
kernel (``repro_torch.kernels``).

The migration warm-start hooks make a torch node a DisCEdge node: when a
replicated tokenized context lands here, ``prime`` chunk-prefills it into
pages, and ``install_kv_pages`` imports the digest-verified KV pages
another node shipped (``export_kv_pages`` is the sending side; the wire
format is the JAX package's, so JAX and torch nodes ship to each other).

JAX's arrays are immutable; the port computes in place. So a cache the
session pool keeps is never handed to compute: a hit appends into a copy
(``clone_caches``), and a paged entry is materialised into fresh buffers.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.manager import ServiceCapabilities, ServiceResult
from ..device import DeviceLike, resolve_device, synchronize
from ..models import (
    ModelConfig,
    decode_step,
    decode_step_paged,
    init_params,
    prefill,
    prefill_append,
    supports_append,
)
from ..models.cache import clone_caches, trim_cache_prefix
from ..store.kv_ship import NodeShipProfile, PageShipment
from ..tokenizer import EOS, IM_END, ByteLevelBPE, get_tokenizer
from .chunked_prefill import PagedPrefiller, prime_fill_pages
from .paged_kv import PagedKVAllocator
from .sampling import sample
from .session_cache import (
    CacheEntry,
    SessionCachePool,
    longest_common_prefix,
    warm_source_of,
)


def _bucket(n: int, step: int) -> int:
    return max(step, ((n + step - 1) // step) * step)


def truncate_for_cache(
    context_ids: List[int],
    prompt_ids: List[int],
    max_len: int,
    max_new_tokens: int,
) -> Tuple[List[int], int]:
    """Context-overflow guard: keep the prompt, drop the *oldest* context
    tokens, and reserve a modest generation budget. Returns
    ``(input_ids, max_new)`` sized to fit a ``max_len`` cache."""
    context_ids, prompt_ids = list(context_ids), list(prompt_ids)
    reserve = max(1, min(max_new_tokens, 16))
    max_input = max(1, max_len - 1 - reserve)
    total = len(context_ids) + len(prompt_ids)
    if total > max_input:
        drop = total - max_input
        if drop < len(context_ids):
            context_ids = context_ids[drop:]
        else:
            context_ids = []
            prompt_ids = prompt_ids[-max_input:]
    ids = context_ids + prompt_ids
    budget = max(1, max_len - len(ids) - 1)
    return ids, min(max_new_tokens, budget)


def bucketed_prefill(
    params: Dict, cfg: ModelConfig, ids: List[int], max_len: int, bucket: int,
    device: torch.device,
):
    """Full B = 1 prefill of ``ids`` into a fresh ``max_len``-slot cache at
    the length rounded up to ``bucket`` (capped at ``max_len``) —
    ``true_len`` masks the padding, as the JAX engines bucket to bound
    their compiles. Returns (logits, caches, next_pos)."""
    n = len(ids)
    s = min(_bucket(n, bucket), max_len)
    toks = np.zeros((1, s), np.int32)
    toks[0, :n] = np.asarray(ids, np.int64) % cfg.vocab_size
    return prefill(
        params, cfg, torch.from_numpy(toks).to(device), max_len=max_len,
        true_len=torch.tensor([n], dtype=torch.int32, device=device),
    )


def chunked_append(
    params: Dict,
    cfg: ModelConfig,
    caches: List[Dict],
    suffix_ids: List[int],
    p0: int,
    chunk: int,
    bucket: int,
):
    """Chunked incremental prefill of ``suffix_ids`` into existing B = 1
    full ``caches`` (in place) from absolute offset ``p0`` — the one loop
    shared by the single-stream engine, the warm-start prime and the
    full-width server's slot admission (``repro.serving.engine.
    chunked_append``). Chunks are right-padded to ``bucket`` multiples and
    capped at ``chunk`` slots, as in JAX. Returns (logits, caches,
    next_pos)."""
    dev = caches[0]["k"].device
    logits, pos = None, torch.tensor([p0], dtype=torch.int32, device=dev)
    i, m = 0, len(suffix_ids)
    while i < m:
        rem = m - i
        s = min(chunk, _bucket(rem, bucket))
        c = min(rem, s)
        toks = np.zeros((1, s), np.int32)
        toks[0, :c] = np.asarray(suffix_ids[i : i + c], np.int64) % cfg.vocab_size
        logits, caches, pos = prefill_append(
            params, cfg, caches, torch.from_numpy(toks).to(dev), p0 + i,
            torch.tensor([c], dtype=torch.int32, device=dev),
        )
        i += c
    return logits, caches, pos


def prime_session_pool(
    pool: Optional[SessionCachePool],
    cache_key: str,
    token_ids: List[int],
    max_len: int,
    max_input: int,
    append_fn: Callable,    # (base_caches, suffix_ids, p0) -> (logits, caches, pos)
    prefill_fn: Callable,   # (ids) -> (logits, caches, pos)
    paged_fill: Optional[Callable] = None,  # (ids, entry|None, usable) -> pages|None
    source: str = "prime",  # provenance of a FRESH install ("prime" = token
                            # recompute, "ship" = shipped KV pages)
) -> Tuple[bool, bool]:
    """Migration warm-start core shared by the single-stream engine and the
    batched server (``repro.serving.engine.prime_session_pool``). Returns
    ``(warm, stored)``: ``warm`` — the pool now holds KV for the full
    sequence; ``stored`` — prefill or install work ran.

    Guards, in order: nothing to do without a pool or tokens; a context
    longer than ``max_input`` is truncated on the serving path and could
    never prefix-match; a fresh prime into a full pool would be dropped by
    the low-priority put. A diverged entry is invalidated; an entry
    covering everything is a no-op; otherwise only the delta is filled.
    Extending an entry keeps its provenance and its LRU position.

    A paged pool with ``paged_fill`` fills pages straight (chunked paged
    prefill or shipped pages); otherwise the KV goes through a dense lane —
    a full prefill, or a chunk append onto a copy of the entry's cache (or
    the gathered pages of another session's matching prefix) — and the
    pool's put stores it (into pages when an allocator is bound)."""
    if pool is None or not token_ids:
        return False, False
    n = len(token_ids)
    if n > max_input:
        return False, False
    entry = pool.peek(cache_key)
    if entry is None and len(pool) >= pool.capacity:
        return False, False
    usable = 0
    if entry is not None:
        lcp = longest_common_prefix(entry.token_ids, token_ids)
        if lcp < entry.pos and lcp < n:
            pool.invalidate(cache_key)  # diverged: stale/edited history
        elif entry.pos >= n:
            return True, False          # already warm (covers everything)
        else:
            usable = lcp                # == entry.pos: extend the delta
    if (
        paged_fill is not None and pool.allocator is not None
        and (usable == 0 or entry.paged)
    ):
        pages = paged_fill(token_ids, entry if usable > 0 else None, usable)
        if pages is None:
            return False, False
        pool.put(
            cache_key,
            CacheEntry(
                token_ids=list(token_ids), pages=pages,
                source=entry.source if usable > 0 else source,
            ),
            low_priority=True,
        )
        pool.primes += 1
        return True, True
    # the dense lane: another session's resident pages matching this
    # context shrink the prefill and the page budget the put will need
    shared_pages: List[int] = []
    stok = 0
    if pool.allocator is not None:
        shared_pages = pool.allocator.match_prefix(token_ids, n)
        stok = len(shared_pages) * pool.allocator.page_size
        if pool.allocator.n_free < pool.allocator.pages_for(n) - len(shared_pages):
            return False, False
    if usable > 0:
        base = (
            pool.materialize(entry, usable, max_len) if entry.paged
            else clone_caches(entry.caches)
        )
        _, caches, _ = append_fn(base, token_ids[usable:], usable)
    elif stok > 0:
        base = pool.allocator.gather(shared_pages, stok, max_len)
        _, caches, _ = append_fn(base, token_ids[stok:], stok)
        pool.shared_hits += 1
        pool.shared_tokens += stok
    else:
        _, caches, _ = prefill_fn(token_ids)
    caches = trim_cache_prefix(caches, n)
    # the prime's compute finishes here, off the hot path: left queued, it
    # would contend with the next serving turn's measured work
    synchronize(caches[0]["k"].device)
    pool.put(
        cache_key,
        CacheEntry(
            token_ids=list(token_ids), caches=caches,
            source=entry.source if usable > 0 else source,
        ),
        low_priority=True,
    )
    pool.primes += 1
    return True, True


@dataclass
class GenerateResult:
    """Outcome of one generation, with KV-reuse accounting."""

    token_ids: List[int]
    cache_hit: bool = False
    reused_tokens: int = 0       # prefix tokens served from the session pool
    prefill_tokens: int = 0      # tokens actually prefilled this turn
    inference_ms: float = 0.0    # hot path: prefill + decode (pool update excluded)
    cache_update_ms: float = 0.0  # session-pool update, off the hot path
    warm_start: bool = False
    warm_source: str = "none"
    ttft_ms: float = 0.0         # start -> first generated token determined
    decode_p50_ms: float = 0.0   # per-token decode latency percentiles
    decode_p99_ms: float = 0.0   # (amortized over each host-sync window)


@dataclass
class InferenceEngine:
    cfg: ModelConfig
    params: Dict
    device: torch.device
    max_len: int = 1024          # cache slots (context + generation budget)
    bucket: int = 64             # dense full-prefill / append bucket
    append_chunk: int = 256      # max prefill chunk
    sync_every: int = 8          # decode steps between host syncs / stop scans
    stop_tokens: Tuple[int, ...] = (EOS, IM_END)
    session_pool: Optional[SessionCachePool] = None
    _prefiller: Optional[PagedPrefiller] = field(default=None, repr=False)
    # migration warm-start accounting (prime runs off the serving hot path)
    prime_count: int = 0
    prime_ms: float = 0.0
    # keyed generations that had to leave the paged route (a dense entry in
    # a mixed-topology pool, or page exhaustion at admission)
    paged_fallbacks: int = 0

    @classmethod
    def create(
        cls,
        cfg: ModelConfig,
        seed: int = 0,
        max_len: int = 1024,
        bucket: int = 64,
        session_cache_capacity: int = 4,
        page_size: int = 0,
        kv_pages: int = 0,
        share_prefixes: bool = True,
        device: DeviceLike = None,
        params: Optional[Dict] = None,
    ) -> "InferenceEngine":
        """An engine on ``device`` (default ``"cuda"``; raises without a GPU
        unless ``device="cpu"``). Weights are drawn from ``seed`` with a
        ``torch.Generator`` unless ``params`` (e.g. bridged JAX weights,
        ``models.params_from_numpy``) are given. With ``page_size`` and
        ``kv_pages`` > 0 the session pool stores its entries paged in one
        :class:`PagedKVAllocator` and keyed turns take the paged route
        (``share_prefixes`` False turns its cross-session page sharing off);
        otherwise (the default, as in JAX) the pool holds dense caches and
        every turn takes the dense route. A model whose state cannot be
        extended in place (``supports_append`` False: the SSM and hybrid
        models) gets no pool: every turn is a full prefill, padded to a
        ``bucket`` multiple, then decode. Its SSD needs that length to be a
        multiple of ``cfg.ssm_chunk``, as in JAX: the full-width configs
        (chunk 128) need ``bucket=128``; the default 64 raises on a bucket
        that is an odd multiple of 64."""
        dev = resolve_device(device)
        if params is None:
            params = init_params(cfg, seed, dev)
        pool = (
            SessionCachePool(capacity=session_cache_capacity)
            if session_cache_capacity > 0 and supports_append(cfg)
            else None
        )
        if pool is not None and page_size > 0 and kv_pages > 0:
            if max_len % page_size:
                raise ValueError(f"max_len {max_len} is not a multiple of page_size {page_size}")
            pool.allocator = PagedKVAllocator(
                cfg, page_size=page_size, n_pages=kv_pages, device=dev,
                share_prefixes=share_prefixes,
            )
            # pages are the memory bound: the entry cap must never evict
            # before the page budget does (every entry holds >= 1 page)
            pool.capacity = max(pool.capacity, kv_pages)
        return cls(
            cfg=cfg, params=params, device=dev, max_len=max_len, bucket=bucket, session_pool=pool,
        )

    def _paged_prefiller(self) -> PagedPrefiller:
        if self._prefiller is None:
            self._prefiller = PagedPrefiller(
                self.cfg, self.params, self.session_pool.allocator, self.device
            )
        return self._prefiller

    # -- dense prefill paths -------------------------------------------------
    def _full_prefill(self, input_ids: List[int]):
        """Full prefill into a fresh ``max_len``-width B = 1 cache (bucket
        ``self.bucket``)."""
        return bucketed_prefill(
            self.params, self.cfg, input_ids, self.max_len, self.bucket, self.device
        )

    def _append_prefill(self, caches, suffix_ids: List[int], p0: int):
        """Chunked incremental prefill of ``suffix_ids`` from ``p0`` into
        ``caches`` (in place: the caller passes a cache it owns)."""
        return chunked_append(
            self.params, self.cfg, caches, suffix_ids, p0, self.append_chunk, self.bucket,
        )

    def _trim_for_pool(self, caches, n_valid: int):
        """Mask kv_pos beyond the kept prefix (decode may have run past a
        stop token between host syncs)."""
        return trim_cache_prefix(caches, n_valid)

    # -- migration warm-start ----------------------------------------------
    def prime(self, cache_key: str, token_ids: List[int]) -> bool:
        """Pre-warm the session pool for ``cache_key`` with the KV state of
        ``token_ids`` — the migration warm-start path, called off the
        serving hot path when a replicated tokenized context lands on this
        node: the roaming client's first turn here then prefills only its
        new tokens. The overflow bound matches ``TorchLLMService.
        completion``'s truncation (generation reserve 16). Returns True
        when the pool now holds KV for the full sequence."""
        return self._prime(cache_key, token_ids, None, 0, "prime")

    def install_shipped_pages(
        self,
        cache_key: str,
        token_ids: List[int],
        payloads: List[bytes],
        have_pages: int,
    ) -> bool:
        """Install digest-verified shipped KV pages: ``payloads`` hold the
        full pages ``[have_pages, have_pages + len(payloads))`` of
        ``token_ids``'s KV, exported by the origin's allocator. They are
        imported into fresh pages; only the partial tail page (and any
        coverage gap) is prefilled. The entry's provenance is ``"ship"``,
        so the next turn's warm start reports ``"pages"``. False when the
        pages can't be taken (a dense pool, page exhaustion) — the shipper
        then recomputes from tokens."""
        pool = self.session_pool
        if pool is None or pool.allocator is None:
            return False
        return self._prime(cache_key, token_ids, payloads, have_pages, "ship")

    def _prime(
        self, cache_key: str, token_ids: List[int],
        shipped: Optional[List[bytes]], have_pages: int, source: str,
    ) -> bool:
        pool = self.session_pool
        t0 = time.perf_counter()
        paged_fill = None
        if pool is not None and pool.allocator is not None:
            paged_fill = lambda ids, entry, usable: prime_fill_pages(  # noqa: E731
                pool, self._paged_prefiller(), ids, entry, usable,
                shipped=shipped, ship_have=have_pages,
            )
        warm, stored = prime_session_pool(
            pool, cache_key, list(token_ids), self.max_len, self.max_len - 1 - 16,
            self._append_prefill, self._full_prefill, paged_fill=paged_fill, source=source,
        )
        if stored:
            self.prime_count += 1
            self.prime_ms += (time.perf_counter() - t0) * 1e3
        return warm

    # -- public API ------------------------------------------------------------
    def generate_ex(
        self,
        input_ids: List[int],
        max_new_tokens: int = 128,
        temperature: float = 0.0,
        cache_key: Optional[str] = None,
    ) -> GenerateResult:
        """Single-sequence generation with optional session-level KV reuse
        when ``cache_key`` is given. With a paged session pool, keyed turns
        run fully paged (:meth:`_generate_paged`); keyless turns, turns of
        a dense pool and the paged misfits (a dense entry in a
        mixed-topology pool, page exhaustion — counted in
        ``paged_fallbacks``) take the dense route
        (:meth:`_generate_dense`)."""
        input_ids = list(input_ids)
        n = len(input_ids)
        assert n + max_new_tokens <= self.max_len, (n, max_new_tokens, self.max_len)
        pool = self.session_pool if cache_key is not None else None
        if pool is not None and pool.allocator is not None:
            res = self._generate_paged(input_ids, max_new_tokens, temperature, cache_key)
            if res is not None:
                return res
            self.paged_fallbacks += 1
        return self._generate_dense(input_ids, max_new_tokens, temperature, cache_key)

    def generate(
        self,
        input_ids: List[int],
        max_new_tokens: int = 128,
        temperature: float = 0.0,
        cache_key: Optional[str] = None,
    ) -> List[int]:
        """The generated token ids of :meth:`generate_ex`."""
        return self.generate_ex(
            input_ids, max_new_tokens=max_new_tokens,
            temperature=temperature, cache_key=cache_key,
        ).token_ids

    def warmup(self, lengths: Tuple[int, ...] = (64,)) -> None:
        """One short keyless generation per entry of ``lengths`` (each at
        most 16 tokens long, as in JAX)."""
        for s in lengths:
            self.generate(list(range(min(s, 16))), max_new_tokens=2)

    def _generate_dense(
        self,
        input_ids: List[int],
        max_new_tokens: int,
        temperature: float,
        cache_key: Optional[str],
    ) -> GenerateResult:
        """The dense-transient route: a full prefill into a ``max_len``-width
        B = 1 cache — or, on a session hit, a chunk append of the suffix into
        a copy of the stored cache (a paged entry, or another session's
        matching pages, materialised) — then decode against it with one
        host sync per ``sync_every`` window, and a keyed turn stores the
        cache trimmed to what it kept (a paged pool pages it on the way in)."""
        n = len(input_ids)
        pool = self.session_pool if cache_key is not None else None
        dev = self.device
        t0 = time.perf_counter()

        entry, usable = (None, 0)
        if pool is not None:
            entry, usable = pool.match(cache_key, input_ids)
        shared_pages: List[int] = []
        stok = 0
        if pool is not None and pool.allocator is not None:
            shared_pages, stok = pool.match_shared_prefix(input_ids)
        if stok > usable:
            # another session's pages cover more than this key's own entry:
            # gather them into a fresh dense lane and prefill the remainder
            base = pool.allocator.gather(shared_pages, stok, self.max_len)
            logits, caches, pos = self._append_prefill(base, input_ids[stok:], stok)
            reused, warm_source = stok, "none"
            pool.shared_hits += 1
            pool.shared_tokens += stok
        elif entry is not None and usable > 0:
            if entry.paged:
                # fresh buffers with kv_pos masked to `usable` (a resend too)
                base = pool.materialize(entry, usable, self.max_len)
            else:
                # the pool keeps the entry: append into a copy
                base = clone_caches(entry.caches)
                if usable < entry.pos:
                    # a resend: the ids stop inside the cached prefix
                    base = self._trim_for_pool(base, usable)
            logits, caches, pos = self._append_prefill(base, input_ids[usable:], usable)
            reused = usable
            warm_source = warm_source_of(entry.source)
        else:
            logits, caches, pos = self._full_prefill(input_ids)
            reused, warm_source = 0, "none"

        tok = sample(logits, temperature=temperature)
        synchronize(dev)
        ttft_ms = (time.perf_counter() - t0) * 1e3

        def step(tok):
            nonlocal pos
            logits, _ = decode_step(self.params, self.cfg, caches, tok[:, None], pos)
            pos = pos + 1
            return logits

        out, gaps = self._decode(tok, max_new_tokens, temperature, step)
        inference_ms = (time.perf_counter() - t0) * 1e3

        # session-pool update, off the hot path (the paper's asynchronous
        # context update, §4.2.1): every emitted token was decoded, so the
        # stored prefix is input_ids + out; kv_pos past it is trimmed
        cache_update_ms = 0.0
        if pool is not None:
            t1 = time.perf_counter()
            prefix = input_ids + out
            pool.put(
                cache_key,
                CacheEntry(
                    token_ids=prefix, caches=self._trim_for_pool(caches, len(prefix)),
                    source="serve",
                ),
            )
            cache_update_ms = (time.perf_counter() - t1) * 1e3

        return _generate_result(
            out, gaps, n, reused, warm_source, ttft_ms, inference_ms, cache_update_ms,
        )

    def _decode(
        self,
        tok: torch.Tensor,
        max_new_tokens: int,
        temperature: float,
        step: Callable[[torch.Tensor], torch.Tensor],
        window: Optional[Callable[[int], Tuple[int, bool]]] = None,
    ) -> Tuple[List[int], List[float]]:
        """Decode from the first sampled token ``tok`` with batched host
        sync: tokens stay on the device; every ``sync_every`` steps one
        transfer pulls the window and scans it for stop tokens; steps
        decoded past a stop are discarded. ``step(tok)`` runs one decode
        step and returns its logits (1, 1, V). ``window(w)``, when given,
        readies the next window of at most ``w`` steps and returns (steps,
        last window). Returns (token ids, per-token gaps in ms)."""
        out: List[int] = []
        gaps: List[float] = []
        remaining = max_new_tokens
        while remaining > 0:
            w, last = min(self.sync_every, remaining), False
            if window is not None:
                w, last = window(w)
                if w <= 0:
                    break
            t_w = time.perf_counter()
            toks = []
            for _ in range(w):
                toks.append(tok)
                tok = sample(step(tok)[:, 0], temperature=temperature)
            remaining -= w
            host = torch.stack(toks)[:, 0].cpu().numpy()   # single device sync
            gap = (time.perf_counter() - t_w) * 1e3 / w
            for t in host:
                out.append(int(t))
                gaps.append(gap)
                if int(t) in self.stop_tokens:
                    return out, gaps
            if last:
                break
        return out, gaps

    def _generate_paged(
        self,
        input_ids: List[int],
        max_new_tokens: int,
        temperature: float,
        cache_key: str,
    ) -> Optional[GenerateResult]:
        """Keyed generation straight on the page pool: admission shares the
        session entry's full pages (its partial tail page is copied into a
        fresh exclusively-held page) or a longer cross-session content-index
        run, allocates fresh pages out to ``n + 1``, chunk-prefills the
        suffix into them, then decodes through the page table at a
        power-of-two table width that grows page by page ahead of each
        host-sync window. The token, its position and ``kv_pos`` stay on the
        device; the host syncs once per ``sync_every`` window. Returns None
        (nothing allocated or counted) when the pool can't serve this
        request — a dense entry matched, or the pages aren't there — and the
        caller falls back to the dense route."""
        pool = self.session_pool
        alloc = pool.allocator
        ps = alloc.page_size
        dev = self.device
        n = len(input_ids)
        t0 = time.perf_counter()

        entry, usable = pool.match(cache_key, input_ids)
        if entry is not None and not entry.paged:
            return None  # mixed-topology pool: a dense entry matched
        usable = min(usable, n - 1)
        cross = alloc.match_prefix(input_ids, n - 1)
        kind, cover = ("entry", usable) if usable > 0 else ("none", 0)
        if len(cross) * ps > cover:
            kind, cover = "cross", len(cross) * ps
        warm_source = warm_source_of(entry.source) if kind == "entry" else "none"
        skip = cover // ps
        tail_src: Optional[int] = None
        if kind == "entry" and cover % ps:
            tail_src = entry.pages[skip]
        shared = (
            list(entry.pages[:skip]) if kind == "entry"
            else list(cross[:skip]) if kind == "cross"
            else []
        )
        if shared:
            # incref before reclaim: eviction must not free the donor pages
            alloc.incref(shared)
        fresh = self._alloc_paged(alloc.pages_for(n + 1) - skip, exclude=cache_key)
        if fresh is None:
            if shared:
                alloc.decref(shared)
            return None
        pages = shared + fresh
        if tail_src is not None:
            alloc.copy_page(tail_src, fresh[0])
        if kind == "cross":
            pool.shared_hits += 1
            pool.shared_tokens += cover

        logits = self._paged_prefiller().prefill_ids(
            pages, input_ids, cover, n_skip=skip, chunk=self.append_chunk
        )
        tok = sample(logits[None, :], temperature=temperature)
        synchronize(dev)
        ttft_ms = (time.perf_counter() - t0) * 1e3

        iota = torch.arange(self.max_len, dtype=torch.int32, device=dev)
        kv_full = torch.where(iota < n, iota, torch.full_like(iota, -1))[None, :]
        pos = torch.full((1,), n, dtype=torch.int32, device=dev)
        pos_abs = n
        table = kv_view = None

        def window(wsteps: int):
            nonlocal pages, table, kv_view
            last = False
            need = alloc.pages_for(pos_abs + wsteps)
            if need > len(pages):
                more = self._alloc_paged(need - len(pages), exclude=cache_key)
                if more is None:
                    # a window the pool can't back is truncated: generation
                    # stops early, never with a silently dropped write
                    last = True
                    wsteps = min(wsteps, len(pages) * ps - pos_abs)
                    if wsteps <= 0:
                        return 0, True
                else:
                    pages = pages + more
            w = 1
            while w < len(pages):
                w *= 2
            wp = min(w, self.max_len // ps) * ps
            table = torch.from_numpy(alloc.table_for(pages, wp)).to(dev)[None, :]
            kv_view = kv_full[:, :wp]
            return wsteps, last

        def step(tok):
            nonlocal pos, pos_abs
            logits = decode_step_paged(
                self.params, self.cfg, alloc.pools, table, kv_view, tok[:, None], pos,
            )
            pos = pos + 1
            pos_abs += 1
            return logits

        out, gaps = self._decode(tok, max_new_tokens, temperature, step, window)
        inference_ms = (time.perf_counter() - t0) * 1e3

        # write-back MOVES the pages into the pool entry (zero-copy); pages
        # past the kept prefix are freed
        t1 = time.perf_counter()
        prefix = input_ids + out
        keep = alloc.pages_for(len(prefix))
        if keep < len(pages):
            alloc.decref(pages[keep:])
        pool.put(cache_key, CacheEntry(token_ids=prefix, pages=pages[:keep], source="serve"))
        cache_update_ms = (time.perf_counter() - t1) * 1e3

        return _generate_result(
            out, gaps, n, cover, warm_source, ttft_ms, inference_ms, cache_update_ms,
        )

    def _alloc_paged(self, m: int, exclude: Optional[str] = None) -> Optional[List[int]]:
        """Allocate ``m`` pages, reclaiming page-budgeted LRU session
        entries (never ``exclude``) on pressure."""
        alloc = self.session_pool.allocator
        pages = alloc.alloc(m)
        if pages is None:
            self.session_pool.reclaim(m, exclude=exclude)
            pages = alloc.alloc(m)
        return pages


def _generate_result(
    out: List[int], gaps: List[float], n: int, reused: int, warm_source: str,
    ttft_ms: float, inference_ms: float, cache_update_ms: float,
) -> GenerateResult:
    """One turn's :class:`GenerateResult`, the same accounting on both
    routes: a hit is a turn that reused any KV."""
    return GenerateResult(
        token_ids=out,
        cache_hit=reused > 0,
        reused_tokens=reused,
        prefill_tokens=n - reused,
        inference_ms=inference_ms,
        cache_update_ms=cache_update_ms,
        warm_start=warm_source != "none",
        warm_source=warm_source,
        ttft_ms=ttft_ms,
        decode_p50_ms=float(np.percentile(gaps, 50)) if gaps else 0.0,
        decode_p99_ms=float(np.percentile(gaps, 99)) if gaps else 0.0,
    )


def export_entry_pages(
    pool: Optional[SessionCachePool], cache_key: str
) -> Optional[PageShipment]:
    """The full pages of ``cache_key``'s paged session entry as a
    :class:`PageShipment` (native-dtype bytes: the round trip is
    bit-exact), or None (no entry, or not one full page yet)."""
    entry = pool.peek(cache_key) if pool is not None else None
    if entry is None or not entry.paged:
        return None
    alloc = pool.allocator
    full = entry.pos // alloc.page_size
    if full <= 0:
        return None
    return PageShipment(
        token_ids=list(entry.token_ids[: entry.pos]),
        payloads=[alloc.export_page_bytes(p) for p in entry.pages[:full]],
    )


def resident_entry_pages(
    pool: Optional[SessionCachePool], cache_key: str, token_ids: List[int]
) -> int:
    """Full prefix pages of ``token_ids`` that ``cache_key``'s entry already
    holds — shipped deltas skip them."""
    entry = pool.peek(cache_key) if pool is not None else None
    if entry is None or not entry.paged or pool.allocator is None:
        return 0
    lcp = longest_common_prefix(entry.token_ids[: entry.pos], list(token_ids))
    return lcp // pool.allocator.page_size


@dataclass
class TorchLLMService:
    """LLM Service (paper §3.2) backed by the PyTorch engine — the
    counterpart of ``repro.serving.engine.JaxLLMService``. Accepts the
    pre-tokenized context next to the prompt ids plus the session's
    ``cache_key``; hit turns prefill only the uncovered suffix. With
    ``kv_reuse=False`` (the paper's own llama.cpp behaviour) every turn
    prefills its whole context on the dense route. Context that would
    overflow the engine is truncated from the oldest tokens. It implements
    ``repro_torch.core.manager.LLMServiceProtocol`` and, by duck typing,
    JAX's ``repro.core.manager.LLMServiceProtocol``, so a port
    ``EdgeNode`` or a JAX one can mount it."""

    model: str
    engine: InferenceEngine
    tokenizer: ByteLevelBPE
    kv_reuse: bool = True
    # measured prefill cost for the KV-ship cost model (ms per token on
    # this node's card); 0 keeps this node out of page shipping
    ship_prefill_ms_per_token: float = 0.0
    _busy_until: float = field(default=0.0, repr=False, compare=False)
    _clock_owner: Optional[object] = field(default=None, repr=False, compare=False)

    @classmethod
    def create(
        cls,
        model: str,
        cfg: ModelConfig,
        *,
        seed: int = 0,
        tokenizer_seed: int = 0,
        max_len: int = 2048,
        kv_reuse: bool = True,
        session_cache_capacity: int = 4,
        page_size: int = 0,
        kv_pages: int = 0,
        share_prefixes: bool = True,
        device: DeviceLike = None,
        params: Optional[Dict] = None,
    ) -> "TorchLLMService":
        engine = InferenceEngine.create(
            cfg, seed=seed, max_len=max_len,
            session_cache_capacity=session_cache_capacity if kv_reuse else 0,
            page_size=page_size, kv_pages=kv_pages, share_prefixes=share_prefixes,
            device=device, params=params,
        )
        tok = get_tokenizer(cfg.vocab_size, seed=tokenizer_seed, name=model)
        return cls(model=model, engine=engine, tokenizer=tok, kv_reuse=kv_reuse)

    def capabilities(self) -> ServiceCapabilities:
        return ServiceCapabilities(
            prime=self.kv_reuse, kv_reuse=self.kv_reuse, batched=False, n_slots=1,
        )

    def prime(self, cache_key: str, token_ids: List[int]) -> bool:
        """Migration warm-start entry point (the EdgeNode's replication
        arrival hook, off the serving hot path): prefill the replicated
        tokenized context into the session pool so the roaming client's
        next turn here is suffix-only."""
        if not self.kv_reuse:
            return False
        return self.engine.prime(cache_key, list(token_ids))

    # -- KV-page shipping hooks (driven by a KVShipper: the port's or JAX's) --
    def kv_ship_profile(self) -> Optional[NodeShipProfile]:
        """This node's shipping constants, or None when it can't ship (reuse
        off, a dense pool, or no measured prefill constant)."""
        pool = self.engine.session_pool
        if (
            not self.kv_reuse or pool is None or pool.allocator is None
            or self.ship_prefill_ms_per_token <= 0
        ):
            return None
        return NodeShipProfile(
            page_size=pool.allocator.page_size,
            page_wire_bytes=pool.allocator.page_bytes,
            prefill_ms_per_token=self.ship_prefill_ms_per_token,
        )

    def export_kv_pages(self, cache_key: str) -> Optional[PageShipment]:
        return export_entry_pages(self.engine.session_pool, cache_key)

    def install_kv_pages(
        self, cache_key: str, token_ids: List[int], payloads: List[bytes], have_pages: int
    ) -> bool:
        """Install digest-verified shipped pages into the session pool (the
        KVShipper's installer hook)."""
        if not self.kv_reuse:
            return False
        return self.engine.install_shipped_pages(
            cache_key, list(token_ids), payloads, have_pages
        )

    def resident_ship_pages(self, cache_key: str, token_ids: List[int]) -> int:
        return resident_entry_pages(self.engine.session_pool, cache_key, token_ids)

    def resident_keys(self) -> Dict[str, int]:
        """Cache key -> resident KV token count (fleet telemetry)."""
        pool = self.engine.session_pool
        return pool.resident_keys() if pool is not None else {}

    def crash(self) -> None:
        """Process crash: the session KV pool is device memory — gone."""
        if self.engine.session_pool is not None:
            self.engine.session_pool.clear()
        self._busy_until = 0.0
        self._clock_owner = None

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
        """Async serving entrypoint (single stream): the work runs eagerly
        here and its measured ``inference_ms`` is laid onto the network's
        sim clock behind whatever is already queued on this engine."""
        if self._clock_owner is not net:
            self._clock_owner = net
            self._busy_until = 0.0
        result = self.completion(context_ids, prompt_ids, max_new_tokens, cache_key=cache_key)
        now = net.clock.now_ms
        start = max(now, self._busy_until)
        result.queue_ms = start - now
        self._busy_until = start + result.inference_ms
        net.schedule(self._busy_until, lambda: on_done(result))

    def completion(
        self,
        context_ids: List[int],
        prompt_ids: List[int],
        max_new_tokens: int,
        cache_key: Optional[str] = None,
    ) -> ServiceResult:
        ids, max_new = truncate_for_cache(
            context_ids, prompt_ids, self.engine.max_len, max_new_tokens
        )
        res = self.engine.generate_ex(
            ids, max_new_tokens=max_new, cache_key=cache_key if self.kv_reuse else None,
        )
        gen = res.token_ids
        text = self.tokenizer.decode([t for t in gen if t not in self.engine.stop_tokens])
        return ServiceResult(
            text=text,
            token_ids=gen,
            inference_ms=res.inference_ms,
            cache_hit=res.cache_hit,
            reused_tokens=res.reused_tokens,
            prefill_tokens=res.prefill_tokens,
            cache_update_ms=res.cache_update_ms,
            warm_start=res.warm_start,
            warm_source=res.warm_source,
            ttft_ms=res.ttft_ms,
            decode_p50_ms=res.decode_p50_ms,
            decode_p99_ms=res.decode_p99_ms,
        )
