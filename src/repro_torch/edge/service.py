"""LLM Service implementations (paper §3.2) — the port's copy of
``repro.edge.service``.

The service is runtime/hardware agnostic: anything that accepts a
pre-tokenized ``context`` parameter plus prompt tokens qualifies. Three
implementations (see :class:`repro_torch.core.manager.LLMServiceProtocol`
for the capability-declaring interface):

- :class:`EchoLLMService` (here) — deterministic analytic-cost fake for
  systems tests and network benchmarks (no device work, reproducible
  timings from a calibrated cost model of prefill/decode, plus an ``n_slots``
  contention model so concurrent tenants queue like they would on a real
  engine). Its generated ids come from the same ``np.random`` draws as
  JAX's, so the two packages' echo transcripts are equal.
- :class:`TorchLLMService` (repro_torch.serving.engine) — the PyTorch
  inference engine, single-stream, on the card (hand-written CUDA kernels)
  or, when asked, on the CPU.
- :class:`BatchedLLMService` (repro_torch.serving.scheduler) — the continuous-
  batching :class:`~repro_torch.serving.scheduler.BatchedServer` mounted as a
  node's LLM Service: concurrent sessions share its decode batch and
  session KV pool.

This mirrors the paper's llama.cpp modification: the ``/completion`` API is
extended with a "context" parameter so the engine skips re-tokenizing stored
history and only processes the new prompt tokens.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np

from ..core.manager import ServiceCapabilities, ServiceResult
from ..store.kv_ship import NodeShipProfile, PageShipment, page_digests
from ..store.network import Network
from ..tokenizer import ByteLevelBPE, IM_END, get_tokenizer

# warm-start provenance of a virtual KV prefix, mirroring
# repro_torch.serving.session_cache.WARM_SOURCES (not imported: the edge
# layer stays free of torch)
_WARM_SOURCES = {"prime": "tokens", "ship": "pages"}


def _lcp(a: List[int], b: List[int]) -> int:
    """Longest common prefix — mirrors repro_torch.serving.session_cache
    (not imported: the echo service stays free of the serving stack)."""
    n = min(len(a), len(b))
    for i in range(n):
        if a[i] != b[i]:
            return i
    return n


@dataclass
class EchoLLMService:
    """Deterministic fake inference engine with an analytic cost model.

    Cost model (per request):
        prefill_ms = prefill_ms_per_token * n_prefilled
        decode_ms  = decode_ms_per_token  * n_generated
    The generated text is a deterministic function of the input tokens, so
    consistency tests can assert that responses depend on the full context.

    ``cache_key`` is honored the same way the torch service honors it: the
    service remembers, per key, the token prefix whose (virtual) KV state it
    holds, prefix-matches each request against it, and reports
    cache_hit/reused_tokens/prefill_tokens with identical semantics —
    including ``prime`` support for the migration warm-start hook
    (docs/architecture.md). With ``kv_reuse=False`` (the default, matching
    the seed behaviour) the analytic cost still charges the full input as
    prefill and no reuse is reported, mirroring a TorchLLMService built with
    ``kv_reuse=False``.

    On the submit/await path the service models **slot contention**:
    ``n_slots`` independent inference streams, each serving one request at
    a time. A request arriving while every stream is busy waits for the
    earliest stream to free up; the wait is charged to
    ``ServiceResult.queue_ms`` (→ ``Timing.queue_ms``), the analytic
    inference cost is unchanged. The KV-prefix bookkeeping updates in
    submit order — a deliberate simplification of the analytic twin (the
    per-session turn counter already serializes any one session's turns).
    """

    model: str
    vocab_size: int = 151936
    tokenizer_seed: int = 0
    prefill_ms_per_token: float = 0.9   # ~TX2-class commodity hardware
    decode_ms_per_token: float = 45.0
    # tokenize clock factor vs this host (paper: 4-50 ms/turn on TX2,
    # <1 ms on M2 — see ContextManager.tokenize_scale)
    tokenize_scale: float = 1.0
    n_generate: int = 24
    kv_reuse: bool = False
    n_slots: int = 1
    # KV-page shipping (repro_torch.store.kv_ship): virtual bytes of KV one token
    # occupies on the wire (0 disables shipping for this node) and the page
    # granularity of the virtual page pool. kv_bytes_per_token * ship_page_
    # size is the per-page wire size the cost model bills.
    kv_bytes_per_token: float = 0.0
    ship_page_size: int = 16
    # Bounded virtual session pool (None: unbounded — the pre-fleet
    # behaviour). At fleet scale the KV pool is the scarce resource: an
    # LRU bound makes placement matter — a node serving too many sessions
    # evicts, so scattering one session across nodes loses its KV
    # residency. Same LRU semantics as SessionCachePool: serve installs at
    # MRU, a fresh prime installs at the LRU end (next victim), a hit
    # promotes to MRU, an extension keeps its position.
    session_capacity: Optional[int] = None

    def __post_init__(self) -> None:
        self.tokenizer: ByteLevelBPE = get_tokenizer(
            self.vocab_size, seed=self.tokenizer_seed, name=self.model
        )
        # cache_key -> token prefix whose KV the analytic engine "holds",
        # and how that prefix got here ("serve" | "prime"); ordered LRU
        # (leftmost = next eviction victim)
        self._kv_prefix: "OrderedDict[str, List[int]]" = OrderedDict()
        self._kv_source: Dict[str, str] = {}
        self.evictions = 0
        # sim-time each inference stream frees up, valid for _clock_owner's
        # clock (a service reused across clusters restarts at idle)
        self._slot_free_at: List[float] = [0.0] * self.n_slots
        self._clock_owner: Optional[Network] = None

    # -- capability declaration (LLMServiceProtocol) --------------------
    def capabilities(self) -> ServiceCapabilities:
        return ServiceCapabilities(
            prime=self.kv_reuse,
            kv_reuse=self.kv_reuse,
            batched=False,
            n_slots=self.n_slots,
        )

    def resident_keys(self) -> Dict[str, int]:
        """Cache key -> resident (virtual) KV token count — the fleet
        telemetry surface, same shape as SessionCachePool.resident_keys."""
        return {k: len(v) for k, v in self._kv_prefix.items()}

    def _evict_over_capacity(self) -> None:
        while (
            self.session_capacity is not None
            and len(self._kv_prefix) > self.session_capacity
        ):
            victim, _ = self._kv_prefix.popitem(last=False)
            self._kv_source.pop(victim, None)
            self.evictions += 1

    def prime(self, cache_key: str, token_ids: List[int]) -> bool:
        """Migration warm-start (analytic twin of InferenceEngine.prime).
        Extending a prefix the node already holds keeps its provenance: a
        "serve" prefix delta-extended by a replicated write is still the
        node's own hot session, and relabeling it "prime" would miscount
        the next local hit as a migration warm start."""
        if not self.kv_reuse or not token_ids:
            return False
        ids = list(token_ids)
        prev = self._kv_prefix.get(cache_key)
        if prev is not None:
            lcp = _lcp(prev, ids)
            if lcp == len(ids) and len(prev) >= len(ids):
                return True  # prefix already covered (stale re-delivery): no-op
            if lcp == len(prev):
                self._kv_prefix[cache_key] = ids  # delta-extend, keep source
                return True
        # fresh install (or divergence: stale/edited history replaces it);
        # best-effort storage like SessionCachePool.put(low_priority=True) —
        # a prime must never displace the node's own hot serve entries, so
        # it parks at the LRU end and is the next eviction victim
        self._kv_prefix[cache_key] = ids
        self._kv_prefix.move_to_end(cache_key, last=False)
        self._kv_source[cache_key] = "prime"
        self._evict_over_capacity()
        return True

    # -- KV-page shipping hooks (repro_torch.store.kv_ship) -------------------
    def kv_ship_profile(self) -> Optional[NodeShipProfile]:
        """This node's shipping constants for the cost model; None when it
        can't ship (reuse off or no per-token KV size configured)."""
        if not self.kv_reuse or self.kv_bytes_per_token <= 0:
            return None
        return NodeShipProfile(
            page_size=self.ship_page_size,
            page_wire_bytes=int(self.kv_bytes_per_token * self.ship_page_size),
            prefill_ms_per_token=self.prefill_ms_per_token,
        )

    def _page_payload(self, digest: bytes) -> bytes:
        """Deterministic pseudo-bytes standing in for one serialized KV
        page: derived from the page's chained content digest, so two nodes
        holding the same token prefix export byte-identical payloads (the
        analytic twin of the engine's bit-exact native-dtype export)."""
        n = max(1, int(self.kv_bytes_per_token * self.ship_page_size))
        reps = -(-n // len(digest))
        return (digest * reps)[:n]

    def export_kv_pages(self, cache_key: str) -> Optional[PageShipment]:
        """Serialize the resident full pages of ``cache_key``'s virtual KV
        prefix, or None when the key isn't resident."""
        prev = self._kv_prefix.get(cache_key)
        if prev is None or self.kv_bytes_per_token <= 0:
            return None
        digs = page_digests(prev, self.ship_page_size)
        if not digs:
            return None
        return PageShipment(
            token_ids=list(prev),
            payloads=[self._page_payload(d) for d in digs],
        )

    def install_kv_pages(
        self,
        cache_key: str,
        token_ids: List[int],
        payloads: List[bytes],
        have_pages: int,
    ) -> bool:
        """Install digest-verified shipped pages as this node's virtual KV
        prefix for ``cache_key``. Each payload is re-checked against the
        page content it claims to hold (the analytic twin of the engine
        importing page bytes); any mismatch refuses the install and the
        shipper falls back to token recompute. Install semantics mirror
        ``prime``: delta-extension keeps provenance, a fresh install parks
        at the LRU end with source ``"ship"``."""
        if not self.kv_reuse or self.kv_bytes_per_token <= 0:
            return False
        ids = list(token_ids)
        digs = page_digests(ids, self.ship_page_size)
        want = min(len(digs), have_pages + len(payloads))
        for i in range(have_pages, want):
            if payloads[i - have_pages] != self._page_payload(digs[i]):
                return False
        prev = self._kv_prefix.get(cache_key)
        if prev is not None:
            lcp = _lcp(prev, ids)
            if lcp == len(ids) and len(prev) >= len(ids):
                return True   # already covered: no-op
            if lcp == len(prev):
                self._kv_prefix[cache_key] = ids   # delta-extend, keep source
                return True
        self._kv_prefix[cache_key] = ids
        self._kv_prefix.move_to_end(cache_key, last=False)
        self._kv_source[cache_key] = "ship"
        self._evict_over_capacity()
        return True

    def resident_ship_pages(self, cache_key: str, token_ids: List[int]) -> int:
        """Full prefix pages of ``token_ids`` this node already holds for
        ``cache_key`` — shipped deltas skip them."""
        prev = self._kv_prefix.get(cache_key)
        if prev is None:
            return 0
        return _lcp(prev, list(token_ids)) // self.ship_page_size

    def crash(self) -> None:
        """Process crash: the (virtual) session KV pool is volatile — lose
        every remembered prefix and free all inference streams (their
        requests were failed by the manager)."""
        self._kv_prefix.clear()
        self._kv_source.clear()
        self._slot_free_at = [0.0] * self.n_slots
        self._clock_owner = None  # re-anchor to the clock on next submit

    # -- async serving entrypoint ---------------------------------------
    def submit(
        self,
        context_ids: List[int],
        prompt_ids: List[int],
        max_new_tokens: int,
        cache_key: Optional[str] = None,
        *,
        net: Network,
        on_done: Callable[[ServiceResult], None],
    ) -> None:
        """Queue the request on the earliest-free inference stream and
        schedule its completion at ``start + inference_ms`` on the sim
        clock; ``queue_ms`` is the slot wait."""
        if self._clock_owner is not net:
            self._clock_owner = net
            self._slot_free_at = [0.0] * self.n_slots
        result = self.completion(
            context_ids, prompt_ids, max_new_tokens, cache_key=cache_key
        )
        now = net.clock.now_ms
        slot = min(range(self.n_slots), key=self._slot_free_at.__getitem__)
        start = max(now, self._slot_free_at[slot])
        result.queue_ms = start - now
        finish = start + result.inference_ms
        self._slot_free_at[slot] = finish
        net.schedule(finish, lambda: on_done(result))

    # -- blocking/legacy entrypoint -------------------------------------
    def completion(
        self,
        context_ids: List[int],
        prompt_ids: List[int],
        max_new_tokens: int,
        cache_key: Optional[str] = None,
    ) -> ServiceResult:
        all_ids = list(context_ids) + list(prompt_ids)
        n = len(all_ids)
        # Session-KV accounting, same semantics as the torch engine's pool:
        # reuse the matching head of the remembered prefix (at least one
        # token recomputed), invalidate on divergence, full prefill on miss.
        hit, reused, warm_source = False, 0, "none"
        if self.kv_reuse and cache_key is not None:
            prev = self._kv_prefix.get(cache_key)
            if prev is not None:
                lcp = _lcp(prev, all_ids)
                if lcp < len(prev) and lcp < n:
                    del self._kv_prefix[cache_key]   # diverged: stale/edited
                    self._kv_source.pop(cache_key, None)
                else:
                    usable = min(len(prev), n - 1)
                    if usable > 0:
                        hit, reused = True, usable
                        warm_source = _WARM_SOURCES.get(
                            self._kv_source.get(cache_key, ""), "none"
                        )
                        self._kv_prefix.move_to_end(cache_key)  # hit -> MRU
        n_prefill = n - reused
        n_gen = min(self.n_generate, max_new_tokens)
        # deterministic "generation": seeded by content so answers differ
        # when context differs (lets tests detect context loss)
        h = int(np.uint64(5381))
        for t in all_ids:
            h = int((np.uint64(h) * np.uint64(33) + np.uint64(t)) & np.uint64(0xFFFFFFFF))
        rng = np.random.default_rng(h)
        words = ["robot", "sensor", "control", "state", "filter", "map",
                 "path", "power", "node", "token"]
        text = " ".join(rng.choice(words, size=max(1, n_gen // 2)))
        token_ids = self.tokenizer.encode(text)
        token_ids.append(IM_END)
        # exactly n_gen tokens — the paper fixes seed/temperature and
        # "verifies the number of generated tokens" so per-turn timing
        # differences isolate the context-management cost (§4.2)
        while len(token_ids) < n_gen:
            token_ids.append(token_ids[len(token_ids) % max(1, len(token_ids) - 1)])
        token_ids = token_ids[:n_gen]
        # text must decode-match the ids (a real model's output re-encodes
        # canonically) so raw/client-side modes see the same token counts
        text = self.tokenizer.decode([t for t in token_ids if t >= 8]).strip()
        # With kv_reuse the analytic prefill charges only the non-reused
        # suffix — the same O(new tokens) the real engine pays on a hit.
        inference_ms = (
            self.prefill_ms_per_token * (n_prefill if self.kv_reuse else n)
            + self.decode_ms_per_token * len(token_ids)
        )
        if self.kv_reuse and cache_key is not None:
            self._kv_prefix[cache_key] = all_ids + token_ids
            self._kv_prefix.move_to_end(cache_key)  # serve installs at MRU
            self._kv_source[cache_key] = "serve"
            self._evict_over_capacity()
        return ServiceResult(
            text=text,
            token_ids=token_ids,
            inference_ms=inference_ms,
            cache_hit=hit,
            reused_tokens=reused,
            prefill_tokens=n_prefill,
            warm_start=warm_source != "none",
            warm_source=warm_source,
        )
