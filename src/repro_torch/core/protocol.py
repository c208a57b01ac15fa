"""Wire protocol between LLM clients, the Context Manager, and the LLM
Service (paper §3.1/§3.4).

The port's copy of ``repro.core.protocol``: the same names and behaviour,
on numpy and the standard library.

Clients use the same request format as a centralized LLM service plus a
(user_id, session_id) pair — assignable by the Context Manager on first
contact — and a monotone *turn counter* that drives the consistency protocol.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple


class ContextMode(enum.Enum):
    """The three context-management modes evaluated in the paper (§4.1)."""

    RAW = "raw"              # server stores raw text; re-tokenizes everything
    TOKENIZED = "tokenized"  # server stores token ids; tokenizes only new prompt
    CLIENT_SIDE = "client_side"  # client ships full history each request


class ConsistencyPolicy(enum.Enum):
    """Paper §3.3: the consistency/availability trade-off is a client policy."""

    STRONG = "strong"        # default: fail the request if context is stale
    AVAILABLE = "available"  # proceed with possibly-stale context


@dataclass
class Request:
    prompt: str
    model: str
    user_id: Optional[str] = None
    session_id: Optional[str] = None
    turn: int = 0            # client-maintained turn counter (paper §3.4)
    mode: ContextMode = ContextMode.TOKENIZED
    policy: ConsistencyPolicy = ConsistencyPolicy.STRONG
    max_new_tokens: int = 128
    # CLIENT_SIDE mode only: the full prior history, shipped with the request.
    client_history: Optional[List[Tuple[str, str]]] = None

    def wire_bytes(self) -> int:
        """Client→server request size (paper Fig. 7 metric)."""
        n = len(self.prompt.encode("utf-8")) + 64  # headers/ids/counter
        if self.mode is ContextMode.CLIENT_SIDE and self.client_history:
            n += sum(
                len(r.encode("utf-8")) + len(c.encode("utf-8")) + 8
                for r, c in self.client_history
            )
        return n


@dataclass
class Timing:
    """Per-request latency decomposition (ms). network_* are simulated; the
    tokenize/inference components are measured wall time of real work."""

    network_up_ms: float = 0.0
    tokenize_ms: float = 0.0
    context_read_ms: float = 0.0   # includes retry backoff (10 ms each)
    inference_ms: float = 0.0
    network_down_ms: float = 0.0
    async_update_ms: float = 0.0   # context write; NOT on the response path
    retries: int = 0
    # Session-level KV-cache reuse (repro_torch.serving.session_cache): did this
    # turn hit the session's cached KV prefix, how many prefix tokens were
    # reused, and how many tokens were actually prefilled.
    kv_cache_hit: bool = False
    kv_reused_tokens: int = 0
    prefill_tokens: int = 0
    # Node migration (docs/architecture.md): `migrated` — this turn resumed a
    # session whose stored context was last written by a *different* node (the
    # client roamed here); `kv_warm_start` — the KV prefix reused this turn
    # was installed by the replication-arrival warm-start hook (an eager
    # prime), not by a turn previously served on this node.
    migrated: bool = False
    kv_warm_start: bool = False
    # *How* the warm start happened (KV-page shipping, docs/architecture.md
    # "KV page shipping"): "tokens" — the prime re-prefilled the replicated
    # token ids (token recompute); "pages" — the KV pages themselves were
    # shipped from the origin node and installed digest-verified; "none" —
    # no warm start (cold, or the node's own serve entry).
    kv_warm_source: str = "none"
    # Multi-tenant serving (submit/await path): time the request sat in the
    # LLM Service's queue waiting for a free stream/slot, and the peak decode
    # batch size this request shared the engine with (1 = single-stream).
    queue_ms: float = 0.0
    batch_size: int = 1
    # Token-level latency (chunked paged prefill, docs/architecture.md):
    # submit -> first generated token determined, and the per-token decode
    # gap distribution. For a resident tenant, p99 captures the bounded
    # bump other tenants' prefill chunks add to its steps — the metric the
    # per-step chunk budget holds flat where a monolithic prefill stalls.
    ttft_ms: float = 0.0
    decode_p50_ms: float = 0.0
    decode_p99_ms: float = 0.0

    @property
    def response_time_ms(self) -> float:
        """Client-observable end-to-end response time (paper Figs. 3/6).
        The async context update is excluded by design (paper §4.2.1);
        queueing delay inside the LLM Service is client-observable and
        included."""
        return (
            self.network_up_ms
            + self.tokenize_ms
            + self.context_read_ms
            + self.queue_ms
            + self.inference_ms
            + self.network_down_ms
        )


@dataclass
class Response:
    text: str
    user_id: str
    session_id: str
    turn: int
    served_by: str
    n_prompt_tokens: int
    n_context_tokens: int
    n_generated_tokens: int
    timing: Timing = field(default_factory=Timing)
    stale: bool = False   # AVAILABLE policy served stale context
    error: Optional[str] = None

    def wire_bytes(self) -> int:
        return len(self.text.encode("utf-8")) + 96

    @property
    def tps(self) -> float:
        """Tokens generated per second (paper Fig. 4 metric)."""
        if self.timing.inference_ms <= 0:
            return 0.0
        return self.n_generated_tokens / (self.timing.inference_ms / 1e3)


class StaleContextError(RuntimeError):
    """STRONG policy: replica did not catch up to the client's turn counter
    within the retry budget (paper §3.3 — node notifies the client)."""


# Error-marker prefix for responses that failed because the serving node was
# unavailable (crashed mid-request, down at submit, or unreachable). The
# client's failover path retries these on a keygroup peer; protocol errors
# (e.g. StaleContextError under STRONG) are NOT node-down and are not
# retried — they are the consistency protocol speaking.
NODE_DOWN = "node-down"


def is_node_down_error(error: Optional[str]) -> bool:
    """Does this Response.error mean the node (not the protocol) failed?"""
    return error is not None and error.startswith(NODE_DOWN)


# Error-marker prefix for requests shed by a node's admission controller
# (docs/architecture.md, "Fleet layer"): the node is alive but refuses work
# beyond its concurrency limit. The client *requeues* such a turn on another
# keygroup member (router-ranked when a fleet router is mounted) — distinct
# from node-down failover so the two are observable separately.
OVERLOADED = "overloaded"


def is_overload_error(error: Optional[str]) -> bool:
    """Does this Response.error mean the node shed the request at admission?"""
    return error is not None and error.startswith(OVERLOADED)


@dataclass
class Ticket:
    """Handle for one in-flight request on the submit/await serving path.

    Returned by :meth:`EdgeNode.submit` / :meth:`LLMClient.submit`. The
    response materializes when the discrete-event loop reaches the turn's
    completion (drive it with ``EdgeCluster.run_until_quiet()`` or
    ``network.run_until(lambda: ticket.done)``). ``request`` is filled at
    send time — a deferred submit (per-client think delay) builds its
    Request when it actually fires, so the turn counter reflects every
    earlier turn of the session."""

    request: Optional[Request] = None
    submitted_at_ms: float = 0.0
    response: Optional[Response] = None
    completed_at_ms: Optional[float] = None
    # Failover bookkeeping (docs/architecture.md, "Failure model"): how many
    # submit attempts this logical turn took and which nodes served them.
    attempts: int = 0
    nodes_tried: List[str] = field(default_factory=list)
    _callbacks: List[Callable[["Ticket"], None]] = field(
        default_factory=list, repr=False
    )

    @property
    def done(self) -> bool:
        return self.response is not None

    @property
    def latency_ms(self) -> float:
        """Send-to-response sim time. ``submitted_at_ms`` is the scheduled
        *send* time, so a deferred submit's think delay is excluded — this
        is the client-observable turn latency, not time-since-decision."""
        assert self.completed_at_ms is not None, "ticket not resolved yet"
        return self.completed_at_ms - self.submitted_at_ms

    def on_done(self, cb: Callable[["Ticket"], None]) -> None:
        """Register a completion callback (fires immediately if done)."""
        if self.done:
            cb(self)
        else:
            self._callbacks.append(cb)

    def resolve(self, response: Response, now_ms: float) -> None:
        assert self.response is None, "ticket already resolved"
        self.response = response
        self.completed_at_ms = now_ms
        callbacks, self._callbacks = self._callbacks, []
        for cb in callbacks:
            cb(self)
