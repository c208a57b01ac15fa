"""Admission control + adaptive mounting (docs/architecture.md, "Fleet
layer") — the port's copy of ``repro.fleet.admission``. The mounts are
the port's ``TorchLLMService`` and ``BatchedLLMService`` (or any service
with their ``capabilities``/``prime``/``crash``/``resident_keys``/
``submit``).

Two node-local mechanisms that keep a fleet member useful under load it
did not choose:

- :class:`AdmissionControl` — a concurrency target at the node's door.
  A submit arriving with ``limit`` turns already in flight is *shed*: the
  node answers immediately with an ``OVERLOADED`` error (it is alive, just
  full) and the client requeues the turn on a keygroup peer — router-ranked
  when a fleet router is mounted. Shedding early is cheaper for everyone
  than queueing: the refused client pays one link round-trip instead of an
  unbounded queue wait, and the telemetry the router sees stays honest.

- :class:`AdaptiveLLMService` — a service wrapper that flips a node
  between a single-stream mount and a continuous-batching mount based on
  *observed* concurrency. The motivation is measured, not hypothetical:
  BENCH_concurrency.json (the JAX package, on a CPU) shows the batched
  engine's bookkeeping losing to the single-stream engine at c=1–4 while
  winning decisively at c=16.
  A fleet node cannot know its concurrency regime up front — tenancy
  shifts with routing and diurnal load — so the mount follows the traffic:
  flip up when instantaneous in-flight crosses ``hi``, flip back down when
  the concurrency EWMA sinks below ``lo`` (hysteresis: the two thresholds
  straddle so a borderline load does not thrash). In-flight requests
  always finish on the mount that admitted them; only new submits move.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional

from ..core.manager import ServiceCapabilities, ServiceResult
from ..store.network import Network

# Hysteresis defaults: flip to batched at >=3 concurrent (where batching
# starts winning in BENCH_concurrency.json), back to single-stream once the
# smoothed concurrency is clearly below it.
DEFAULT_HI = 3
DEFAULT_LO = 2.0
CONCURRENCY_ALPHA = 0.3


@dataclass
class AdmissionControl:
    """Per-node concurrency target. ``admit(inflight)`` is consulted by
    :meth:`EdgeNode.submit` before any prepare work; a refusal is counted
    and surfaced to the client as an ``OVERLOADED`` response."""

    limit: int
    admitted: int = 0
    sheds: int = 0

    def admit(self, inflight: int) -> bool:
        if inflight >= self.limit:
            self.sheds += 1
            return False
        self.admitted += 1
        return True


@dataclass
class AdaptiveLLMService:
    """LLMServiceProtocol wrapper over a ``single``-stream mount and a
    ``batched`` mount of the same model (see module docstring). Starts
    single-stream — the cheap regime for the idle/low-tenancy node a fleet
    member usually is."""

    single: object   # LLMServiceProtocol, n_slots == 1 class
    batched: object  # LLMServiceProtocol, batched engine
    hi: int = DEFAULT_HI
    lo: float = DEFAULT_LO
    mode: str = "single"
    flips: int = 0
    ewma_concurrency: float = 0.0
    _inflight: int = field(default=0, repr=False)

    def __post_init__(self) -> None:
        assert self.single.model == self.batched.model, (
            "adaptive mounts must serve the same model"
        )
        assert self.lo < self.hi, "hysteresis bands must straddle"
        self.model: str = self.single.model
        self.tokenizer = self.single.tokenizer

    # -- mount selection -------------------------------------------------
    @property
    def current(self) -> object:
        return self.batched if self.mode == "batched" else self.single

    def _maybe_flip(self) -> None:
        if self.mode == "single" and self._inflight >= self.hi:
            self.mode, self.flips = "batched", self.flips + 1
        elif self.mode == "batched" and self.ewma_concurrency <= self.lo:
            self.mode, self.flips = "single", self.flips + 1

    # -- LLMServiceProtocol ----------------------------------------------
    def capabilities(self) -> ServiceCapabilities:
        caps = self.current.capabilities()
        # prime only when both mounts can honor it: a primed prefix must
        # survive a flip, or the warm-start accounting lies
        both_prime = (
            self.single.capabilities().prime and self.batched.capabilities().prime
        )
        return ServiceCapabilities(
            prime=both_prime,
            kv_reuse=caps.kv_reuse,
            batched=caps.batched,
            n_slots=caps.n_slots,
        )

    def prime(self, cache_key: str, token_ids: List[int]) -> bool:
        # Prime both mounts so a later flip does not cold-start the session
        # (the warm-start hook runs off the client-observable path).
        a = self.single.prime(cache_key, list(token_ids))
        b = self.batched.prime(cache_key, list(token_ids))
        return a or b

    def crash(self) -> None:
        for svc in (self.single, self.batched):
            crash_fn = getattr(svc, "crash", None)
            if crash_fn is not None:
                crash_fn()
        self.mode = "single"
        self._inflight = 0
        self.ewma_concurrency = 0.0

    def resident_keys(self):
        resident = dict(getattr(self.single, "resident_keys", dict)())
        for k, v in getattr(self.batched, "resident_keys", dict)().items():
            resident[k] = max(resident.get(k, 0), v)
        return resident

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
        self._inflight += 1
        self.ewma_concurrency = (
            CONCURRENCY_ALPHA * self._inflight
            + (1 - CONCURRENCY_ALPHA) * self.ewma_concurrency
        )
        self._maybe_flip()
        svc = self.current  # pin: this request finishes on its admitting mount

        def done(result: ServiceResult) -> None:
            self._inflight -= 1
            self.ewma_concurrency = (
                CONCURRENCY_ALPHA * self._inflight
                + (1 - CONCURRENCY_ALPHA) * self.ewma_concurrency
            )
            on_done(result)

        svc.submit(
            context_ids, prompt_ids, max_new_tokens, cache_key,
            net=net, on_done=done,
        )

    def completion(
        self,
        context_ids: List[int],
        prompt_ids: List[int],
        max_new_tokens: int,
        cache_key: Optional[str] = None,
    ) -> ServiceResult:
        return self.current.completion(
            context_ids, prompt_ids, max_new_tokens, cache_key
        )
