"""LLM client (paper §3.4): standard request format + user/session ids +
the turn counter. The client picks its edge node per request (geo-aware
routing is out of scope — the mobility benchmarks select nodes explicitly,
like the paper's turn-3/5/7 switches).

The port's copy of ``repro.edge.client``: the same names and behaviour,
on numpy and the standard library.

Two ways to drive a conversation:

- **submit/await** (the real path): :meth:`LLMClient.submit` schedules the
  uplink, node processing, and downlink as discrete events and returns a
  :class:`~repro_torch.core.protocol.Ticket`; :meth:`LLMClient.run_session`
  chains a whole multi-turn conversation with *per-client* think-time
  events. Many clients' sessions interleave on the shared event clock —
  drive them all with ``EdgeCluster.run_until_quiet()``.
- **chat()** (blocking shim): submit one turn and drive the event loop
  until it resolves — identical Responses to submit/await for a serialized
  workload, kept so single-tenant callers read like the paper's setup.

Failure handling (docs/architecture.md, "Failure model"): a turn whose node
is down, crashes mid-request, or exceeds ``timeout_ms`` *fails over* — the
client retries on the next keygroup peer after ``failover_backoff_ms``, up
to ``max_attempts`` attempts, and the turn-counter protocol then does
exactly what the paper promises on the peer: STRONG waits for replication
or fails explicitly; AVAILABLE degrades to stale-but-served. A ticket
always resolves — with the response, a protocol error, or a node-down
error after the attempt budget — never hangs. Protocol errors (e.g.
STRONG staleness) are not failed over: they are the consistency protocol
speaking, and a different node would only be *more* stale.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..core.protocol import (
    NODE_DOWN,
    ConsistencyPolicy,
    ContextMode,
    Request,
    Response,
    Ticket,
    Timing,
    is_node_down_error,
    is_overload_error,
)
from ..core.session import context_key
from .cluster import CLIENT_DOWN_TAG, CLIENT_UP_TAG, EdgeCluster

CLIENT_HOST = "client"


@dataclass
class SessionTrace:
    """Progress of one client's chained multi-turn conversation (filled in
    as the event loop runs — drive with ``EdgeCluster.run_until_quiet()``)."""

    client: "LLMClient"
    tickets: List[Ticket] = field(default_factory=list)
    responses: List[Response] = field(default_factory=list)
    done: bool = False


@dataclass
class LLMClient:
    cluster: EdgeCluster
    model: str
    mode: ContextMode = ContextMode.TOKENIZED
    policy: ConsistencyPolicy = ConsistencyPolicy.STRONG
    max_new_tokens: int = 128
    user_id: Optional[str] = None
    session_id: Optional[str] = None
    turn: int = 0
    # -- failure handling --------------------------------------------------
    # per-attempt response deadline in sim ms (None: wait forever — the
    # pre-failover behaviour); a timed-out attempt fails over like node-down
    timeout_ms: Optional[float] = None
    # retry on keygroup peers when an attempt fails with node-down/timeout
    failover: bool = True
    max_attempts: int = 3
    failover_backoff_ms: float = 20.0
    failovers: int = 0
    timeouts: int = 0
    late_responses: int = 0   # answers that arrived after we gave up on them
    # Turns shed by a node's admission controller and requeued on a peer —
    # counted apart from failovers (the node was alive, just full).
    requeues: int = 0
    # Failover spread: peers are rotated by a per-client salt so a fleet of
    # clients abandoning one dead node fans out across its keygroup instead
    # of stampeding the same first peer. ``None`` (default) derives the salt
    # from the server-assigned user id; pin an int to fix the order (tests).
    failover_salt: Optional[int] = None
    # client-side mode keeps the full history locally and ships it each turn
    history: List[Tuple[str, str]] = field(default_factory=list)
    request_bytes_log: List[int] = field(default_factory=list)
    response_log: List[Response] = field(default_factory=list)

    # -- submit/await -----------------------------------------------------
    def _salt(self) -> int:
        if self.failover_salt is not None:
            return self.failover_salt
        if self.user_id:
            # server-assigned ids are sequential ("user-0007") — use the
            # suffix so *neighbouring* clients start on different peers
            tail = self.user_id.rsplit("-", 1)[-1]
            if tail.isdigit():
                return int(tail)
            return zlib.crc32(self.user_id.encode("utf-8"))
        return 0

    def _cache_key(self) -> Optional[str]:
        """The session's context/KV cache key — what the router scores
        residency against. None until the server assigns identifiers."""
        if self.user_id and self.session_id:
            return context_key(self.user_id, self.session_id)
        return None

    def _failover_targets(self, primary: str) -> List[str]:
        """Attempt order: the chosen node, then its keygroup peers (they
        hold replicas of this session's context) rotated by the client's
        salt — ring order alone would send every client fleeing the same
        dead node to the same first peer."""
        try:
            members = self.cluster.store.keygroup(self.model).members
        except KeyError:
            return [primary]
        if primary not in members:
            return [primary] + [m for m in members]
        i = members.index(primary)
        peers = [members[(i + k) % len(members)] for k in range(1, len(members))]
        if len(peers) > 1:
            s = self._salt() % len(peers)
            peers = peers[s:] + peers[:s]
        return [primary] + peers

    def submit(
        self,
        prompt: str,
        node_id: Optional[str] = None,
        *,
        delay_ms: float = 0.0,
        on_response: Optional[Callable[[Response], None]] = None,
    ) -> Ticket:
        """Send one turn as a chain of events — uplink transfer, node-side
        prepare/infer/finish, downlink transfer — and return its Ticket.
        ``delay_ms`` defers the send (per-client think time: it delays
        *this* client's next turn without advancing the shared clock, so
        other tenants' in-flight turns are neither stalled nor
        fast-forwarded). The Request is built when the send actually fires,
        so a deferred turn carries the session state left by the previous
        one. On node-down or timeout the turn retries on a keygroup peer
        (see the module docstring); the ticket always resolves.

        Node choice (docs/architecture.md, "Fleet layer"): an explicit
        ``node_id`` is honored for the first attempt (mobility experiments
        steer placement); ``node_id=None`` asks the cluster's mounted
        :class:`~repro_torch.fleet.router.FleetRouter` to place the turn.
        Retry attempts — failover after node-down/timeout,
        requeue after an admission shed — consult the router too
        (excluding nodes already tried), falling back to salted ring order
        without one."""
        net = self.cluster.network
        router = getattr(self.cluster, "router", None)
        if node_id is None and router is None:
            raise ValueError("submit(node_id=None) requires a mounted fleet "
                             "router — EdgeCluster.build(router=...)")
        ticket = Ticket(submitted_at_ms=net.clock.now_ms + max(0.0, delay_ms))
        # Attempt generation: each attempt (and each abandonment) bumps it,
        # so events belonging to a dead attempt — late deliveries, stale
        # deadline timers — become no-ops instead of double-resolving.
        state: Dict[str, int] = {"gen": 0}

        def current(g: int) -> bool:
            return state["gen"] == g and not ticket.done

        def static_targets() -> List[str]:
            if node_id is not None:
                return self._failover_targets(node_id)
            try:
                return list(self.cluster.store.keygroup(self.model).members)
            except KeyError:
                return []

        def pick_target(idx: int) -> str:
            if idx == 0 and node_id is not None:
                return node_id
            if router is not None:
                ranked = router.route(
                    self.model,
                    cache_key=self._cache_key(),
                    exclude=ticket.nodes_tried,
                )
                if ranked:
                    return ranked[0]
            targets = static_targets()
            return targets[idx % len(targets)] if targets else str(node_id)

        def more_peers() -> bool:
            return len(static_targets()) > 1

        def start_attempt(idx: int) -> None:
            if ticket.done:
                return
            state["gen"] += 1
            g = state["gen"]
            target = pick_target(idx)
            ticket.attempts += 1
            ticket.nodes_tried.append(target)
            send(g, idx, target)

        def send(g: int, idx: int, target: str) -> None:
            req = Request(
                prompt=prompt,
                model=self.model,
                user_id=self.user_id,
                session_id=self.session_id,
                turn=self.turn,
                mode=self.mode,
                policy=self.policy,
                max_new_tokens=self.max_new_tokens,
                client_history=(
                    list(self.history)
                    if self.mode is ContextMode.CLIENT_SIDE else None
                ),
            )
            ticket.request = req
            if not net.reachable(CLIENT_HOST, target):
                # connection refused after one link latency — visible, fast
                net.schedule(
                    net.clock.now_ms + net.link(CLIENT_HOST, target).latency_ms,
                    lambda: current(g) and fail_attempt(
                        g, idx, target, f"{NODE_DOWN}: {target} unreachable"
                    ),
                )
                return
            up_bytes = req.wire_bytes()
            self.request_bytes_log.append(up_bytes)
            up_ms = net.send(CLIENT_HOST, target, up_bytes, CLIENT_UP_TAG)
            net.schedule(
                net.clock.now_ms + up_ms, lambda: arrive(g, idx, target, req, up_ms)
            )
            if self.timeout_ms is not None:
                net.schedule(
                    net.clock.now_ms + self.timeout_ms,
                    lambda: deadline(g, idx, target),
                )

        def arrive(g: int, idx: int, target: str, req: Request, up_ms: float) -> None:
            if not current(g):
                return
            node = self.cluster.node(target)
            if not node.alive or not net.node_is_up(target):
                fail_attempt(
                    g, idx, target, f"{NODE_DOWN}: {target} refused connection"
                )
                return
            node.submit(
                req, on_done=lambda resp: respond(g, idx, target, resp, up_ms)
            )

        def respond(g: int, idx: int, target: str, resp: Response, up_ms: float) -> None:
            # The response (or the crash notification — our TCP-RST model)
            # flows back over the downlink.
            down_ms = net.send(
                target, CLIENT_HOST, resp.wire_bytes(), CLIENT_DOWN_TAG
            )
            resp.timing.network_up_ms = up_ms
            resp.timing.network_down_ms = down_ms
            net.schedule(
                net.clock.now_ms + down_ms, lambda: deliver(g, idx, target, resp)
            )

        def deliver(g: int, idx: int, target: str, resp: Response) -> None:
            if not current(g):
                self.late_responses += 1
                return
            if is_node_down_error(resp.error):
                fail_attempt(g, idx, target, resp.error)
                return
            if is_overload_error(resp.error):
                # the node is alive but shed us at admission: requeue on a
                # peer (router-ranked), same attempt budget as failover
                retry(g, idx, resp, "requeues")
                return
            if resp.error is None:
                # adopt server-assigned identifiers; bump the turn counter
                self.user_id = resp.user_id
                self.session_id = resp.session_id
                self.turn = resp.turn
                if self.mode is ContextMode.CLIENT_SIDE:
                    self.history.append(("user", prompt))
                    self.history.append(("assistant", resp.text))
            resolve(resp)

        def deadline(g: int, idx: int, target: str) -> None:
            if not current(g):
                return
            self.timeouts += 1
            fail_attempt(
                g, idx, target,
                f"{NODE_DOWN}: timeout after {self.timeout_ms:g} ms "
                f"waiting on {target}",
            )

        def fail_attempt(g: int, idx: int, target: str, reason: str) -> None:
            if not current(g):
                return
            resp = Response(
                text="", user_id=self.user_id or "",
                session_id=self.session_id or "", turn=self.turn,
                served_by=target, n_prompt_tokens=0, n_context_tokens=0,
                n_generated_tokens=0, timing=Timing(), error=reason,
            )
            retry(g, idx, resp, "failovers")

        def retry(g: int, idx: int, resp: Response, counter: str) -> None:
            """Shared retry tail for failover (node down/timeout) and
            requeue (admission shed): try the next peer after backoff while
            budget and peers remain, else resolve with the error — never
            hang."""
            state["gen"] += 1  # abandon: late events for attempt g no-op
            if self.failover and idx + 1 < self.max_attempts and more_peers():
                setattr(self, counter, getattr(self, counter) + 1)
                net.schedule(
                    net.clock.now_ms + self.failover_backoff_ms,
                    lambda: start_attempt(idx + 1),
                )
                return
            resolve(resp)  # attempt budget exhausted: resolve explicitly

        def resolve(resp: Response) -> None:
            self.response_log.append(resp)
            ticket.resolve(resp, net.clock.now_ms)
            if on_response is not None:
                on_response(resp)

        if delay_ms > 0:
            net.schedule(net.clock.now_ms + delay_ms, lambda: start_attempt(0))
        else:
            start_attempt(0)
        return ticket

    def run_session(
        self,
        turns: Sequence[Tuple[str, Optional[str]]],
        think_ms: float = 0.0,
        on_turn: Optional[Callable[[int, Response], None]] = None,
        continue_on_error: bool = False,
        start_delay_ms: float = 0.0,
    ) -> SessionTrace:
        """Chain a multi-turn conversation: turn ``i+1`` is sent
        ``think_ms`` after turn ``i``'s response arrives at the client —
        think time as a *per-client* event, never a shared-clock advance.
        ``turns`` is a sequence of ``(prompt, node_id)`` pairs (the node
        choice per turn models mobility, like the paper's switches;
        ``node_id=None`` routes the turn through the cluster's fleet
        router). ``start_delay_ms`` defers the whole session — scenario
        engines schedule thousands of session arrivals this way without
        advancing the shared clock. The session stops early on a protocol
        error (e.g. a STRONG-policy
        staleness failure) unless ``continue_on_error`` — churn workloads
        set it so one explicitly failed turn doesn't strand the rest of the
        conversation (the turn counter didn't advance; the next turn simply
        retries against the same context). Drive to completion with
        ``EdgeCluster.run_until_quiet()``."""
        trace = SessionTrace(client=self)

        def launch(i: int, delay: float) -> None:
            prompt, node_id = turns[i]
            trace.tickets.append(self.submit(
                prompt, node_id, delay_ms=delay,
                on_response=lambda resp: advance(i, resp),
            ))

        def advance(i: int, resp: Response) -> None:
            trace.responses.append(resp)
            if on_turn is not None:
                on_turn(i, resp)
            if (resp.error is None or continue_on_error) and i + 1 < len(turns):
                launch(i + 1, think_ms)
            else:
                trace.done = True

        if turns:
            launch(0, max(0.0, start_delay_ms))
        else:
            trace.done = True
        return trace

    # -- blocking shims ---------------------------------------------------
    def chat(self, prompt: str, node_id: str) -> Response:
        """Blocking compatibility shim over submit/await: submit the turn
        and drive the event loop until *this* ticket resolves (events past
        it — in-flight replication, other tenants' turns — stay pending)."""
        ticket = self.submit(prompt, node_id)
        self.cluster.network.run_until(lambda: ticket.done)
        assert ticket.response is not None
        return ticket.response

    def think(self, ms: float) -> None:
        """Client think time between turns in the *serialized* blocking
        style — advances the shared clock, letting replication land. With
        one client this equals waiting. With concurrent tenants use
        :meth:`run_session`/``submit(delay_ms=...)`` instead: think becomes
        a per-client event that defers only this client's next turn, so it
        neither stalls other tenants' in-flight turns (they progress at
        their own scheduled times) nor fast-forwards the cluster."""
        self.cluster.network.advance(ms)
