"""The Context Manager — DisCEdge's core component (paper §3.1).

The port's copy of ``repro.core.manager``: the same names and behaviour,
on numpy and the standard library.

A stationary middleware on each edge node between clients and the LLM
Service. It owns the context lifecycle:

- assigns user/session identifiers on first contact;
- enforces the turn-counter consistency protocol against its local KV
  replica (retry + backoff, strong or available policy);
- constructs the model input: in TOKENIZED mode it concatenates the stored
  pre-tokenized context with the freshly tokenized new prompt (only the new
  prompt is tokenized); in RAW mode it re-renders and re-tokenizes the entire
  history; in CLIENT_SIDE mode it forwards the client-shipped history
  untouched (to the LLM Service, raw and client-side are identical — §4.1);
- updates the stored context *asynchronously after* the response is sent,
  so the update never sits on the client-observable path (§4.1/§4.2.1);
- passes the session's context key to the LLM Service as ``cache_key``, so
  engines with a session-level KV cache (repro_torch.serving.engine) can reuse
  the KV state of the stored token prefix and prefill only the new tokens.

Since the submit/await redesign (docs/architecture.md, "Async serving
path"), request processing is split into three event-driven phases riding
the discrete-event :class:`~repro_torch.store.network.Network` clock, so context
reads, inference, and replication from *different tenants* genuinely
overlap:

- :meth:`ContextManager.submit` → **prepare**: id assignment, the
  consistency read (backoff retries are *scheduled events*, not clock
  advances), and tokenization of the new prompt;
- **infer**: the asynchronous :meth:`LLMServiceProtocol.submit` call — the
  service schedules its completion on the sim clock, modelling queueing
  delay and (for batched services) a shared decode batch;
- **finish**: response construction plus the asynchronous context write,
  which replicates to keygroup peers off the client-observable path.

:meth:`handle` remains as a thin blocking shim (submit + drive the event
loop until this one turn resolves) so single-tenant callers and the paper's
serialized benchmarks are unchanged.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Protocol, Tuple

from ..store.distributed import DistributedKVStore
from ..store.network import Network
from ..tokenizer import (
    ByteLevelBPE,
    assistant_header,
    encode_turn,
    render_turn,
)
from .consistency import (
    ReadResult,
    RetryPolicy,
    read_with_turn_check_async,
)
from .protocol import (
    NODE_DOWN,
    ConsistencyPolicy,
    ContextMode,
    Request,
    Response,
    StaleContextError,
    Timing,
)
from .session import context_key, fresh_session_id, fresh_user_id
from .tokens import RawContext, TokenizedContext


@dataclass(frozen=True)
class ServiceCapabilities:
    """What an LLM Service implementation can do, declared up front instead
    of discovered by ``hasattr`` duck-typing.

    - ``prime``: supports migration warm-start priming of a session KV pool
      (:meth:`LLMServiceProtocol.prime`); the EdgeNode only subscribes its
      replication-arrival hook when this is set.
    - ``kv_reuse``: honors ``cache_key`` with session-level KV-cache reuse
      (hit turns prefill only the new-token suffix).
    - ``batched``: concurrent sessions share one continuous decode batch
      (``Timing.batch_size`` can exceed 1).
    - ``n_slots``: concurrent inference streams/slots; requests beyond this
      queue (``Timing.queue_ms``).
    """

    prime: bool = False
    kv_reuse: bool = False
    batched: bool = False
    n_slots: int = 1


class LLMServiceProtocol(Protocol):
    """Paper §3.2 — any inference framework that (1) accepts a pre-tokenized
    'context' parameter next to the prompt tokens and (2) serves the same
    model/tokenizer as its keygroup peers.

    The serving entrypoint is the asynchronous :meth:`submit`: the service
    performs (or models) the work and schedules ``on_done(result)`` on the
    network's event clock at the request's completion time, accounting
    queueing delay and batch sharing in the result. :meth:`completion` is
    the legacy blocking form (contention-free; kept for direct callers and
    micro-benchmarks). :meth:`capabilities` declares optional features —
    :meth:`prime` is only called when ``capabilities().prime`` is True.
    """

    model: str
    tokenizer: ByteLevelBPE

    def capabilities(self) -> ServiceCapabilities: ...

    def submit(
        self,
        context_ids: List[int],
        prompt_ids: List[int],
        max_new_tokens: int,
        cache_key: Optional[str] = None,
        *,
        net: Network,
        on_done: Callable[["ServiceResult"], None],
    ) -> None: ...

    def completion(
        self,
        context_ids: List[int],
        prompt_ids: List[int],
        max_new_tokens: int,
        cache_key: Optional[str] = None,
    ) -> "ServiceResult": ...

    def prime(self, cache_key: str, token_ids: List[int]) -> bool: ...


@dataclass
class ServiceResult:
    text: str
    token_ids: List[int]
    inference_ms: float
    # Session-level KV-cache reuse accounting (engines without a session
    # cache leave the defaults).
    cache_hit: bool = False
    reused_tokens: int = 0
    prefill_tokens: int = 0
    cache_update_ms: float = 0.0
    # True when the reused KV prefix was installed by the migration
    # warm-start hook (replication arrival primed the pool) rather than by a
    # turn served on this node — see docs/architecture.md. ``warm_source``
    # says *how*: "tokens" (token-recompute prime), "pages" (digest-verified
    # KV-page ship install), "none" otherwise.
    warm_start: bool = False
    warm_source: str = "none"
    # Multi-tenant accounting (submit path): sim time spent queued for a
    # free stream/slot, and the peak decode batch this request shared.
    queue_ms: float = 0.0
    batch_size: int = 1
    # Token-level latency: time to first generated token and per-token
    # decode gap percentiles (see protocol.Timing for semantics).
    ttft_ms: float = 0.0
    decode_p50_ms: float = 0.0
    decode_p99_ms: float = 0.0


@dataclass
class PreparedTurn:
    """Output of the *prepare* phase: everything the infer phase needs."""

    req: Request
    user_id: str
    session_id: str
    key: str
    timing: Timing
    context_ids: List[int]
    prompt_ids: List[int]
    stored_tok: Optional[TokenizedContext] = None
    stored_raw: Optional[RawContext] = None
    stale: bool = False


@dataclass
class ContextManager:
    node_id: str
    store: DistributedKVStore
    service: LLMServiceProtocol
    retry: RetryPolicy = field(default_factory=RetryPolicy)
    context_ttl_ms: Optional[float] = None
    # -- crash/restart state (docs/architecture.md, "Failure model") --------
    down: bool = field(default=False, init=False)
    _epoch: int = field(default=0, init=False, repr=False)
    _next_rid: int = field(default=0, init=False, repr=False)
    # rid -> (request, user_id, session_id, on_done) for every turn between
    # submit and finish; a crash fails them all fast instead of leaving the
    # client's ticket hanging on a completion event that will never fire
    _inflight: Dict[int, Tuple[Request, str, str, Callable[[Response], None]]] = field(
        default_factory=dict, init=False, repr=False
    )
    crashed_inflight: int = field(default=0, init=False)

    # -- churn ------------------------------------------------------
    def crash(self) -> int:
        """Process crash: every phase callback of the current epoch becomes
        a no-op, and all in-flight turns fail *now* with a node-down error
        (the paper's client must be notified, not stranded). Returns the
        number of turns failed."""
        self.down = True
        self._epoch += 1
        pending, self._inflight = self._inflight, {}
        for req, user_id, session_id, on_done in pending.values():
            on_done(Response(
                text="", user_id=user_id, session_id=session_id,
                turn=req.turn, served_by=self.node_id,
                n_prompt_tokens=0, n_context_tokens=0, n_generated_tokens=0,
                timing=Timing(),
                error=f"{NODE_DOWN}: {self.node_id} crashed mid-request",
            ))
        self.crashed_inflight += len(pending)
        return len(pending)

    def restart(self) -> None:
        self.down = False

    @property
    def inflight_count(self) -> int:
        """Turns currently between submit and finish — the node's observed
        concurrency (fleet telemetry + admission-control input)."""
        return len(self._inflight)

    @property
    def tokenize_scale(self) -> float:
        """Hardware-calibrated clock factor for tokenization time: the BPE
        work is real, but this host is much faster than the paper's edge
        CPUs (measured 4–50 ms/turn on the TX2, <1 ms on the M2 for the same
        work our encoder does in ~0.1–1.5 ms). Services may expose
        ``tokenize_scale`` to model their node's CPU class; default 1."""
        return float(getattr(self.service, "tokenize_scale", 1.0))

    # ---------------------------------------------------------------
    @property
    def tokenizer(self) -> ByteLevelBPE:
        return self.service.tokenizer

    @property
    def keygroup(self) -> str:
        return self.service.model

    # -- blocking shim ----------------------------------------------
    def handle(self, req: Request) -> Response:
        """Blocking compatibility shim over the submit/await path: submit
        the request and drive the event loop until *this* turn resolves
        (events past it — in-flight replication, other tenants' turns —
        stay pending, exactly like the pre-async serialized path)."""
        net = self.store.network
        box: List[Response] = []
        self.submit(req, box.append)
        net.run_until(lambda: bool(box))
        assert box, "request did not resolve"
        return box[0]

    # -- phase 1: prepare -------------------------------------------
    def submit(self, req: Request, on_done: Callable[[Response], None]) -> None:
        """Event-driven entrypoint: run the prepare phase now (at the
        request's node-arrival time) and schedule the infer/finish phases;
        ``on_done(response)`` fires at response-completion sim time."""
        net = self.store.network
        timing = Timing()
        user_id = req.user_id or fresh_user_id()
        session_id = req.session_id or fresh_session_id()
        key = context_key(user_id, session_id)
        tok = self.tokenizer

        if self.down:
            # connection refused — fail fast, never schedule phases
            on_done(Response(
                text="", user_id=user_id, session_id=session_id,
                turn=req.turn, served_by=self.node_id,
                n_prompt_tokens=0, n_context_tokens=0, n_generated_tokens=0,
                timing=timing,
                error=f"{NODE_DOWN}: {self.node_id} is down",
            ))
            return

        # Register the turn and epoch-stamp every phase boundary: if the
        # node crashes while this turn is in flight, crash() resolves it
        # with a node-down error and the stale phase events become no-ops.
        epoch = self._epoch
        rid = self._next_rid
        self._next_rid += 1
        self._inflight[rid] = (req, user_id, session_id, on_done)

        def finish_done(resp: Response) -> None:
            if self._inflight.pop(rid, None) is not None:
                on_done(resp)

        def alive() -> bool:
            return self._epoch == epoch and rid in self._inflight

        if req.mode is ContextMode.CLIENT_SIDE:
            # History ships with the request; tokenize all of it, every time.
            t0 = time.perf_counter()
            full: List[int] = []
            for role, content in req.client_history or []:
                full.extend(encode_turn(tok, role, content))
            full.extend(encode_turn(tok, "user", req.prompt))
            full.extend(assistant_header(tok))
            timing.tokenize_ms = (time.perf_counter() - t0) * 1e3 * self.tokenize_scale
            pt = PreparedTurn(
                req=req, user_id=user_id, session_id=session_id, key=key,
                timing=timing, context_ids=[], prompt_ids=full,
            )
            net.schedule(
                net.clock.now_ms + timing.tokenize_ms,
                lambda: alive() and self._infer(pt, finish_done, alive),
            )
            return

        # Edge-side context: consistency-checked read from the local
        # replica. Retries are scheduled events — replication landing
        # inside a backoff window is applied (in timestamp order) before
        # the retry fires, and other tenants keep making progress.
        def resume(rr: ReadResult) -> None:
            if not alive():
                return
            timing.context_read_ms = rr.wait_ms
            timing.retries = rr.retries
            if rr.stale and req.policy is ConsistencyPolicy.STRONG:
                err = StaleContextError(
                    f"replica {self.node_id}/{self.keygroup}/{key} at turn "
                    f"{getattr(rr.value, 'version', None)} < client turn "
                    f"{req.turn} after {rr.retries} retries"
                )
                finish_done(Response(
                    text="", user_id=user_id, session_id=session_id,
                    turn=req.turn, served_by=self.node_id,
                    n_prompt_tokens=0, n_context_tokens=0,
                    n_generated_tokens=0, timing=timing, error=str(err),
                ))
                return
            # Migration detection: the stored context was last written by a
            # peer node — the client roamed here since its previous turn.
            timing.migrated = bool(
                rr.value is not None
                and rr.value.origin
                and rr.value.origin != self.node_id
            )
            pt = self._tokenize_after_read(
                req, rr, user_id, session_id, key, timing
            )
            net.schedule(
                net.clock.now_ms + timing.tokenize_ms,
                lambda: alive() and self._infer(pt, finish_done, alive),
            )

        read_with_turn_check_async(
            self.store, self.node_id, self.keygroup, key, req.turn,
            resume, policy=req.policy, retry=self.retry,
        )

    def _tokenize_after_read(
        self,
        req: Request,
        rr: ReadResult,
        user_id: str,
        session_id: str,
        key: str,
        timing: Timing,
    ) -> PreparedTurn:
        """Second half of prepare: build model input from the read context
        (only the new prompt is tokenized in TOKENIZED mode — the paper's
        core saving)."""
        tok = self.tokenizer
        if req.mode is ContextMode.TOKENIZED:
            stored_tok = (
                rr.value.value.copy() if rr.value is not None
                else TokenizedContext(model=req.model)
            )
            context_ids = list(stored_tok.ids)
            t0 = time.perf_counter()
            prompt_ids = encode_turn(tok, "user", req.prompt)
            prompt_ids.extend(assistant_header(tok))
            timing.tokenize_ms = (time.perf_counter() - t0) * 1e3 * self.tokenize_scale
            return PreparedTurn(
                req=req, user_id=user_id, session_id=session_id, key=key,
                timing=timing, context_ids=context_ids, prompt_ids=prompt_ids,
                stored_tok=stored_tok, stale=rr.stale,
            )
        # RAW: re-render + re-tokenize the whole history
        stored_raw = (
            rr.value.value.copy() if rr.value is not None
            else RawContext(model=req.model)
        )
        t0 = time.perf_counter()
        ctx_ids = tok.encode(stored_raw.text)
        new_ids = encode_turn(tok, "user", req.prompt)
        new_ids.extend(assistant_header(tok))
        timing.tokenize_ms = (time.perf_counter() - t0) * 1e3 * self.tokenize_scale
        # raw mode sends everything as one prompt (context param empty)
        return PreparedTurn(
            req=req, user_id=user_id, session_id=session_id, key=key,
            timing=timing, context_ids=[], prompt_ids=ctx_ids + new_ids,
            stored_raw=stored_raw, stale=rr.stale,
        )

    # -- phase 2: infer ---------------------------------------------
    def _infer(
        self,
        pt: PreparedTurn,
        on_done: Callable[[Response], None],
        alive: Optional[Callable[[], bool]] = None,
    ) -> None:
        """Hand the prepared input to the LLM Service. The session's context
        key doubles as the service's KV-cache key: services with a session
        pool reuse the stored prefix's KV state and prefill only the new
        tokens — correctness is guarded by the service's prefix match. The
        service schedules completion (queueing + inference) on the sim
        clock; ``_finish`` runs at that time (skipped if the node crashed
        while the request was in the service — crash() already failed it)."""
        self.service.submit(
            context_ids=pt.context_ids,
            prompt_ids=pt.prompt_ids,
            max_new_tokens=pt.req.max_new_tokens,
            cache_key=pt.key,
            net=self.store.network,
            on_done=lambda result: (
                (alive is None or alive()) and self._finish(pt, result, on_done)
            ),
        )

    # -- phase 3: finish --------------------------------------------
    def _finish(
        self,
        pt: PreparedTurn,
        result: ServiceResult,
        on_done: Callable[[Response], None],
    ) -> None:
        """Build the response and perform the asynchronous context update
        (local write + async replication) — after the response, off the
        client-observable path (§4.2.1)."""
        req, timing, tok = pt.req, pt.timing, self.tokenizer
        timing.inference_ms = result.inference_ms
        timing.queue_ms = result.queue_ms
        timing.batch_size = result.batch_size
        timing.kv_cache_hit = result.cache_hit
        timing.kv_reused_tokens = result.reused_tokens
        timing.prefill_tokens = result.prefill_tokens
        timing.kv_warm_start = result.warm_start
        timing.kv_warm_source = result.warm_source
        timing.ttft_ms = result.ttft_ms
        timing.decode_p50_ms = result.decode_p50_ms
        timing.decode_p99_ms = result.decode_p99_ms

        n_ctx = len(pt.context_ids) if req.mode is ContextMode.TOKENIZED else 0
        resp = Response(
            text=result.text,
            user_id=pt.user_id,
            session_id=pt.session_id,
            turn=req.turn + 1,
            served_by=self.node_id,
            n_prompt_tokens=len(pt.prompt_ids),
            n_context_tokens=n_ctx,
            n_generated_tokens=len(result.token_ids),
            timing=timing,
            stale=pt.stale,
        )

        if req.mode is not ContextMode.CLIENT_SIDE:
            t0 = time.perf_counter()
            if req.mode is ContextMode.TOKENIZED:
                assert pt.stored_tok is not None
                pt.stored_tok.extend(encode_turn(tok, "user", req.prompt))
                pt.stored_tok.extend(assistant_header(tok))
                pt.stored_tok.extend(result.token_ids)  # already tokens — free
                pt.stored_tok.commit_turn()
                new_value: object = pt.stored_tok
                version = pt.stored_tok.turn
            else:
                assert pt.stored_raw is not None
                pt.stored_raw.extend(render_turn("user", req.prompt))
                pt.stored_raw.extend(render_turn("assistant", result.text))
                pt.stored_raw.commit_turn()
                new_value = pt.stored_raw
                version = pt.stored_raw.turn
            timing.async_update_ms = (time.perf_counter() - t0) * 1e3
            # local write + async replication to keygroup peers
            self.store.put(self.node_id, self.keygroup, pt.key, new_value, version)
        on_done(resp)

    # ---------------------------------------------------------------
    def forget(
        self, user_id: str, session_id: str, turn: Optional[int] = None
    ) -> None:
        """Client-requested context deletion (paper §3.3). ``turn`` is the
        client's turn counter: the resulting tombstone then dominates any
        in-flight replicated put of this session, even ones this node
        hasn't seen (the client counter is the supremum of its writes)."""
        self.store.delete(
            self.node_id, self.keygroup, context_key(user_id, session_id), turn
        )
