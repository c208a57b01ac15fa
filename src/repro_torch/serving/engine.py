"""PyTorch inference engine — the LLM Service behind the Context Manager,
on the paged route (the counterpart of ``repro.serving.engine``).

The completion entry point takes a pre-tokenized context plus prompt token
ids (the paper's llama.cpp extension, §4.1). A keyed request
(``cache_key``, the session's context key) runs fully paged: its
``context_ids + prompt_ids`` are matched against the session pool and the
cross-session content index, the uncovered suffix is chunk-prefilled
straight into KV pages, decode runs through the page table, and the pages
move into the pool entry afterwards. On a GPU both attention steps run the
hand-written CUDA kernels (``repro_torch.kernels``).

The migration warm-start hooks make a torch node a DisCEdge node: when a
replicated tokenized context lands here, ``prime`` chunk-prefills it into
pages, and ``install_kv_pages`` imports the digest-verified KV pages
another node shipped (``export_kv_pages`` is the sending side; the wire
format is the JAX package's, so JAX and torch nodes ship to each other).

Routes this slice does not carry raise ``NotImplementedError`` naming the
ROADMAP item: keyless or ``kv_reuse=False`` requests (the dense route,
Queue 1 item 6). Where the JAX engine falls back to the dense route on
page exhaustion at admission, this one raises :class:`PagePoolExhausted`.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device, synchronize
from ..models import ModelConfig, decode_step_paged, init_params, supports_append
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

DENSE_ROUTE = (
    "the dense route (keyless or kv_reuse=False requests) is not ported yet "
    "(ROADMAP, Queue 1 item 6)"
)


class PagePoolExhausted(RuntimeError):
    """Admission could not get the pages a keyed request needs, even after
    reclaiming other sessions' entries."""


# ---------------------------------------------------------------------------
# Service contract — copies of repro.core.manager's dataclasses, so a JAX
# EdgeNode can mount a TorchLLMService by duck typing
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ServiceCapabilities:
    """What an LLM Service can do (``repro.core.manager.ServiceCapabilities``)."""

    prime: bool = False
    kv_reuse: bool = False
    batched: bool = False
    n_slots: int = 1


@dataclass
class ServiceResult:
    """One completion's result (``repro.core.manager.ServiceResult``)."""

    text: str
    token_ids: List[int]
    inference_ms: float
    cache_hit: bool = False
    reused_tokens: int = 0
    prefill_tokens: int = 0
    cache_update_ms: float = 0.0
    warm_start: bool = False
    warm_source: str = "none"
    queue_ms: float = 0.0
    batch_size: int = 1
    ttft_ms: float = 0.0
    decode_p50_ms: float = 0.0
    decode_p99_ms: float = 0.0


# ---------------------------------------------------------------------------
# KV-page shipping contract — copies of repro.store.kv_ship's dataclasses, so
# a JAX KVShipper can drive a torch node's hooks by duck typing
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class NodeShipProfile:
    """One node's shipping constants (``repro.store.kv_ship.NodeShipProfile``):
    a page's size on the wire and the node's measured prefill cost."""

    page_size: int
    page_wire_bytes: int
    prefill_ms_per_token: float
    state_is_o1: bool = False


@dataclass
class PageShipment:
    """A sender-side export (``repro.store.kv_ship.PageShipment``): the
    token ids whose KV the pages hold and one payload per resident full
    page, index-aligned from page 0."""

    token_ids: List[int]
    payloads: List[bytes]


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


def prime_session_pool(
    pool: Optional[SessionCachePool],
    cache_key: str,
    token_ids: List[int],
    max_input: int,
    paged_fill: Callable,   # (ids, entry|None, usable) -> pages|None
    source: str = "prime",  # provenance of a FRESH install ("prime" = token
                            # recompute, "ship" = shipped KV pages)
) -> Tuple[bool, bool]:
    """Migration warm-start core shared by the single-stream engine and the
    batched server (``repro.serving.engine.prime_session_pool``, paged
    branch). Returns ``(warm, stored)``: ``warm`` — the pool now holds KV
    for the full sequence; ``stored`` — prefill or install work ran.

    Guards, in order: nothing to do without a pool or tokens; a context
    longer than ``max_input`` is truncated on the serving path and could
    never prefix-match; a fresh prime into a full pool would be dropped by
    the low-priority put. A diverged entry is invalidated; an entry
    covering everything is a no-op; otherwise only the delta is filled.
    Extending an entry keeps its provenance and its LRU position."""
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
    if pool.allocator is None or (usable > 0 and not entry.paged):
        # JAX primes such pools through a dense lane
        raise NotImplementedError(
            "priming a dense session pool is the dense route, not ported yet "
            "(ROADMAP, Queue 1 item 6)"
        )
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


@dataclass
class GenerateResult:
    """Outcome of one generation, with KV-reuse accounting."""

    token_ids: List[int]
    cache_hit: bool = False
    reused_tokens: int = 0       # prefix tokens served from resident pages
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
    max_len: int = 1024          # table slots (context + generation budget)
    append_chunk: int = 256      # max prefill chunk
    sync_every: int = 8          # decode steps between host syncs / stop scans
    stop_tokens: Tuple[int, ...] = (EOS, IM_END)
    session_pool: Optional[SessionCachePool] = None
    _prefiller: Optional[PagedPrefiller] = field(default=None, repr=False)
    # migration warm-start accounting (prime runs off the serving hot path)
    prime_count: int = 0
    prime_ms: float = 0.0

    @classmethod
    def create(
        cls,
        cfg: ModelConfig,
        seed: int = 0,
        max_len: int = 1024,
        session_cache_capacity: int = 4,
        page_size: int = 16,
        kv_pages: int = 0,
        device: DeviceLike = None,
        params: Optional[Dict] = None,
    ) -> "InferenceEngine":
        """A paged engine on ``device`` (default ``"cuda"``; raises without
        a GPU unless ``device="cpu"``). Weights are drawn from ``seed`` with
        a ``torch.Generator`` unless ``params`` (e.g. bridged JAX weights,
        ``models.params_from_numpy``) are given. The session pool stores its
        entries paged in one :class:`PagedKVAllocator` of ``kv_pages``
        pages of ``page_size`` tokens."""
        dev = resolve_device(device)
        if page_size <= 0 or kv_pages <= 0:
            raise NotImplementedError(
                "only the paged route is ported: pass page_size > 0 and "
                f"kv_pages > 0 ({DENSE_ROUTE})"
            )
        if max_len % page_size:
            raise ValueError(f"max_len {max_len} is not a multiple of page_size {page_size}")
        if params is None:
            params = init_params(cfg, seed, dev)
        pool = (
            SessionCachePool(capacity=session_cache_capacity)
            if session_cache_capacity > 0 and supports_append(cfg)
            else None
        )
        if pool is not None:
            pool.allocator = PagedKVAllocator(
                cfg, page_size=page_size, n_pages=kv_pages, device=dev
            )
            # pages are the memory bound: the entry cap must never evict
            # before the page budget does (every entry holds >= 1 page)
            pool.capacity = max(pool.capacity, kv_pages)
        return cls(cfg=cfg, params=params, device=dev, max_len=max_len, session_pool=pool)

    def _paged_prefiller(self) -> PagedPrefiller:
        if self._prefiller is None:
            self._prefiller = PagedPrefiller(
                self.cfg, self.params, self.session_pool.allocator, self.device
            )
        return self._prefiller

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
        pages can't be taken — the shipper then recomputes from tokens."""
        return self._prime(cache_key, token_ids, payloads, have_pages, "ship")

    def _prime(
        self, cache_key: str, token_ids: List[int],
        shipped: Optional[List[bytes]], have_pages: int, source: str,
    ) -> bool:
        pool = self.session_pool
        if pool is None:
            return False
        t0 = time.perf_counter()
        warm, stored = prime_session_pool(
            pool, cache_key, list(token_ids), self.max_len - 1 - 16,
            lambda ids, entry, usable: prime_fill_pages(
                pool, self._paged_prefiller(), ids, entry, usable,
                shipped=shipped, ship_have=have_pages,
            ),
            source=source,
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
        """Single-sequence keyed generation on the page pool, with
        session-level KV reuse (see :meth:`_generate_paged`)."""
        input_ids = list(input_ids)
        n = len(input_ids)
        assert n + max_new_tokens <= self.max_len, (n, max_new_tokens, self.max_len)
        if cache_key is None or self.session_pool is None:
            raise NotImplementedError(DENSE_ROUTE)
        return self._generate_paged(input_ids, max_new_tokens, temperature, cache_key)

    def _generate_paged(
        self,
        input_ids: List[int],
        max_new_tokens: int,
        temperature: float,
        cache_key: str,
    ) -> GenerateResult:
        """Keyed generation straight on the page pool: admission shares the
        session entry's full pages (its partial tail page is copied into a
        fresh exclusively-held page) or a longer cross-session content-index
        run, allocates fresh pages out to ``n + 1``, chunk-prefills the
        suffix into them, then decodes through the page table at a
        power-of-two table width that grows page by page ahead of each
        host-sync window. The token, its position and ``kv_pos`` stay on the
        device; the host syncs once per ``sync_every`` window."""
        pool = self.session_pool
        alloc = pool.allocator
        ps = alloc.page_size
        dev = self.device
        n = len(input_ids)
        t0 = time.perf_counter()

        entry, usable = pool.match(cache_key, input_ids)
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
            raise PagePoolExhausted(
                f"{alloc.pages_for(n + 1) - skip} pages needed for a {n}-token "
                f"request, {alloc.n_free} free of {alloc.n_pages - 1}"
            )
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
        out: List[int] = []
        gaps: List[float] = []
        pos_abs = n
        remaining = max_new_tokens
        stopped = early = False
        while remaining > 0 and not stopped and not early:
            wsteps = min(self.sync_every, remaining)
            need = alloc.pages_for(pos_abs + wsteps)
            if need > len(pages):
                more = self._alloc_paged(need - len(pages), exclude=cache_key)
                if more is None:
                    # a window the pool can't back is truncated: generation
                    # stops early, never with a silently dropped write
                    early = True
                    wsteps = min(wsteps, len(pages) * ps - pos_abs)
                    if wsteps <= 0:
                        break
                else:
                    pages = pages + more
            w = 1
            while w < len(pages):
                w *= 2
            w = min(w, self.max_len // ps)
            wp = w * ps
            table = torch.from_numpy(alloc.table_for(pages, wp)).to(dev)[None, :]
            kv_view = kv_full[:, :wp]
            t_w = time.perf_counter()
            window = []
            for _ in range(wsteps):
                window.append(tok)
                logits = decode_step_paged(
                    self.params, self.cfg, alloc.pools, table, kv_view, tok[:, None], pos,
                )
                pos = pos + 1
                pos_abs += 1
                tok = sample(logits[:, 0], temperature=temperature)
            remaining -= wsteps
            host = torch.stack(window)[:, 0].cpu().numpy()   # single device sync
            gap = (time.perf_counter() - t_w) * 1e3 / wsteps
            for t in host:
                out.append(int(t))
                gaps.append(gap)
                if int(t) in self.stop_tokens:
                    stopped = True
                    break
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

        return GenerateResult(
            token_ids=out,
            cache_hit=cover > 0,
            reused_tokens=cover,
            prefill_tokens=n - cover,
            inference_ms=inference_ms,
            cache_update_ms=cache_update_ms,
            warm_start=warm_source != "none",
            warm_source=warm_source,
            ttft_ms=ttft_ms,
            decode_p50_ms=float(np.percentile(gaps, 50)) if gaps else 0.0,
            decode_p99_ms=float(np.percentile(gaps, 99)) if gaps else 0.0,
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
    if entry is None or not entry.paged:
        return 0
    lcp = longest_common_prefix(entry.token_ids[: entry.pos], list(token_ids))
    return lcp // pool.allocator.page_size


@dataclass
class TorchLLMService:
    """LLM Service (paper §3.2) backed by the PyTorch engine — the
    counterpart of ``repro.serving.engine.JaxLLMService``. Accepts the
    pre-tokenized context next to the prompt ids plus the session's
    ``cache_key``; hit turns prefill only the uncovered suffix. Context that
    would overflow the engine is truncated from the oldest tokens. It
    duck-types ``repro.core.manager.LLMServiceProtocol``, so a JAX
    ``EdgeNode`` can mount it."""

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
        page_size: int = 16,
        kv_pages: int = 0,
        device: DeviceLike = None,
        params: Optional[Dict] = None,
    ) -> "TorchLLMService":
        engine = InferenceEngine.create(
            cfg, seed=seed, max_len=max_len,
            session_cache_capacity=session_cache_capacity if kv_reuse else 0,
            page_size=page_size, kv_pages=kv_pages, device=device, params=params,
        )
        tok = get_tokenizer(cfg.vocab_size, seed=tokenizer_seed, name=model)
        return cls(model=model, engine=engine, tokenizer=tok, kv_reuse=kv_reuse)

    def capabilities(self) -> ServiceCapabilities:
        return ServiceCapabilities(
            prime=self.engine.session_pool is not None, kv_reuse=self.kv_reuse,
            batched=False, n_slots=1,
        )

    def prime(self, cache_key: str, token_ids: List[int]) -> bool:
        """Migration warm-start entry point (the EdgeNode's replication
        arrival hook, off the serving hot path): prefill the replicated
        tokenized context into the session pool so the roaming client's
        next turn here is suffix-only."""
        if not self.kv_reuse:
            return False
        return self.engine.prime(cache_key, list(token_ids))

    # -- KV-page shipping hooks (driven by repro.store.kv_ship.KVShipper) --
    def kv_ship_profile(self) -> Optional[NodeShipProfile]:
        """This node's shipping constants, or None when it can't ship (reuse
        off, or no measured prefill constant)."""
        pool = self.engine.session_pool
        if not self.kv_reuse or pool is None or self.ship_prefill_ms_per_token <= 0:
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
