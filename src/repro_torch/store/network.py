"""Discrete-event network simulator with first-class fault injection.

The port's copy of ``repro.store.network``: the same names and behaviour,
on numpy and the standard library.

Stands in for the paper's LAN testbed. Every byte that crosses a link is
accounted per (src, dst, tag) — our equivalent of the paper's tcpdump/tshark
capture on the FReD peer port (§4.2), but exact rather than sampled.

The simulation is deterministic: a shared millisecond clock, per-link latency
and bandwidth, optional seeded jitter. Deliveries are a min-heap of events the
cluster applies when the clock advances past their arrival time.

Beyond the healthy-LAN model the paper evaluates, the network carries a
:class:`FaultPlan` (docs/architecture.md, "Failure model"): per-link
partition windows, seeded per-window message-drop probability, latency/
bandwidth degradation windows, and node down/up intervals. A send whose
message cannot be delivered — peer down or partitioned at send or arrival
time, or the message drawn as dropped — fails *visibly*: the sender's
``on_failure(reason)`` callback fires on the event clock instead of the
message silently vanishing. Node liveness is also steerable manually
(:meth:`Network.set_node_down`) so ``EdgeCluster.crash``/``restart`` can
model process crashes whose end time no plan knows in advance.
"""

from __future__ import annotations

import heapq
import itertools
import random
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set, Tuple

# Failure reasons passed to on_failure callbacks.
FAIL_NODE_DOWN = "node-down"
FAIL_PARTITIONED = "partitioned"
FAIL_DROPPED = "dropped"

# TCP-ish fixed framing overhead billed per message on top of the payload —
# the handshakes tcpdump catches. Exposed so byte-accounting tests (e.g. the
# KV-ship billed-bytes-equal-shipped-bytes assertions) can reconstruct the
# exact wire total for a message count instead of hard-coding 66.
MESSAGE_OVERHEAD_BYTES = 66


@dataclass
class SimClock:
    now_ms: float = 0.0

    def advance(self, dt_ms: float) -> float:
        assert dt_ms >= 0
        self.now_ms += dt_ms
        return self.now_ms

    def advance_to(self, t_ms: float) -> float:
        self.now_ms = max(self.now_ms, t_ms)
        return self.now_ms


@dataclass
class Link:
    """Point-to-point link with latency + bandwidth. transfer(b) returns the
    one-way transfer time for b bytes."""

    latency_ms: float = 1.0
    bandwidth_mbps: float = 1000.0  # megabits/s

    def transfer_ms(self, n_bytes: int) -> float:
        return self.latency_ms + (n_bytes * 8) / (self.bandwidth_mbps * 1e3)


@dataclass
class TrafficCounter:
    bytes_total: int = 0
    messages: int = 0
    # TCP-ish fixed overhead per message, like the handshakes tcpdump catches
    per_message_overhead: int = MESSAGE_OVERHEAD_BYTES

    def record(self, n_bytes: int) -> int:
        wire = n_bytes + self.per_message_overhead
        self.bytes_total += wire
        self.messages += 1
        return wire


# ---------------------------------------------------------------------------
# Fault plan
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class PartitionWindow:
    """Bidirectional link cut between ``a`` and ``b`` for [start, end)."""

    a: str
    b: str
    start_ms: float
    end_ms: float

    def severs(self, x: str, y: str, t: float) -> bool:
        return self.start_ms <= t < self.end_ms and {x, y} == {self.a, self.b}


@dataclass(frozen=True)
class NodeDownWindow:
    """``node`` is down (crashed / rebooting) for [start, end)."""

    node: str
    start_ms: float
    end_ms: float

    def covers(self, n: str, t: float) -> bool:
        return n == self.node and self.start_ms <= t < self.end_ms


@dataclass(frozen=True)
class DropWindow:
    """Lossy link between ``a`` and ``b`` for [start, end): each message is
    independently dropped with probability ``prob`` (seeded, deterministic —
    draws happen in send order against the plan's single RNG stream)."""

    a: str
    b: str
    start_ms: float
    end_ms: float
    prob: float = 1.0

    def covers(self, x: str, y: str, t: float) -> bool:
        return self.start_ms <= t < self.end_ms and {x, y} == {self.a, self.b}


@dataclass(frozen=True)
class DegradedWindow:
    """Latency/bandwidth degradation between ``a`` and ``b`` for [start,
    end): effective latency is multiplied by ``latency_mult`` and bandwidth
    by ``bandwidth_mult`` (< 1 slows the link)."""

    a: str
    b: str
    start_ms: float
    end_ms: float
    latency_mult: float = 1.0
    bandwidth_mult: float = 1.0

    def covers(self, x: str, y: str, t: float) -> bool:
        return self.start_ms <= t < self.end_ms and {x, y} == {self.a, self.b}


@dataclass
class FaultPlan:
    """Deterministic failure schedule for one run. All windows are in sim
    ms; ``drop_prob`` is a plan-wide background loss rate applied to every
    async message on top of any :class:`DropWindow`. The same (plan, seed)
    over the same workload reproduces the exact same failures — churn runs
    are debuggable (tests/test_fault_properties.py)."""

    partitions: List[PartitionWindow] = field(default_factory=list)
    node_down: List[NodeDownWindow] = field(default_factory=list)
    drops: List[DropWindow] = field(default_factory=list)
    degraded: List[DegradedWindow] = field(default_factory=list)
    drop_prob: float = 0.0
    seed: int = 0

    def drop_probability(self, src: str, dst: str, t: float) -> float:
        p = self.drop_prob
        for w in self.drops:
            if w.covers(src, dst, t):
                p = max(p, w.prob)
        return p


class Network:
    """Topology + event queue. Node names are strings; links are symmetric by
    default but can be overridden per direction."""

    def __init__(self, default_link: Optional[Link] = None) -> None:
        self.clock = SimClock()
        self.default_link = default_link or Link()
        self._links: Dict[Tuple[str, str], Link] = {}
        self._counters: Dict[Tuple[str, str, str], TrafficCounter] = {}
        self._events: List[Tuple[float, int, Callable[[], None]]] = []
        self._seq = itertools.count()
        # fault model
        self.fault_plan: Optional[FaultPlan] = None
        self._fault_rng: Optional[random.Random] = None
        self._down_nodes: Set[str] = set()  # manual crash/restart liveness
        self.dropped_messages = 0
        self.failed_sends = 0

    # -- topology -----------------------------------------------------------
    def set_link(self, src: str, dst: str, link: Link, symmetric: bool = True) -> None:
        self._links[(src, dst)] = link
        if symmetric:
            self._links[(dst, src)] = link

    def link(self, src: str, dst: str) -> Link:
        return self._links.get((src, dst), self.default_link)

    # -- fault model ---------------------------------------------------------
    def install_faults(self, plan: FaultPlan) -> None:
        """Arm a fault plan. Deterministic: the plan's seed drives a single
        RNG stream consumed in send order (event ordering is itself
        deterministic, so the same plan + workload reproduces the same
        drops)."""
        self.fault_plan = plan
        self._fault_rng = random.Random(plan.seed)

    def set_node_down(self, node: str, down: bool = True) -> None:
        """Manual liveness toggle — EdgeCluster.crash/restart. Unlike a
        :class:`NodeDownWindow`, no end time is known in advance: senders
        must park (not poll) until the node is restarted."""
        if down:
            self._down_nodes.add(node)
        else:
            self._down_nodes.discard(node)

    def node_is_up(self, node: str, t: Optional[float] = None) -> bool:
        if node in self._down_nodes:
            return False
        if self.fault_plan is not None:
            at = self.clock.now_ms if t is None else t
            if any(w.covers(node, at) for w in self.fault_plan.node_down):
                return False
        return True

    def partitioned(self, a: str, b: str, t: Optional[float] = None) -> bool:
        if self.fault_plan is None:
            return False
        at = self.clock.now_ms if t is None else t
        return any(w.severs(a, b, at) for w in self.fault_plan.partitions)

    def reachable(self, src: str, dst: str, t: Optional[float] = None) -> bool:
        """Both endpoints up and no partition window severs the link."""
        return (
            self.node_is_up(src, t)
            and self.node_is_up(dst, t)
            and not self.partitioned(src, dst, t)
        )

    def unreachable_reason(self, src: str, dst: str) -> str:
        if not self.node_is_up(dst):
            return f"{FAIL_NODE_DOWN}: {dst}"
        if not self.node_is_up(src):
            return f"{FAIL_NODE_DOWN}: {src}"
        return f"{FAIL_PARTITIONED}: {src}<->{dst}"

    def next_reachable_at(self, src: str, dst: str) -> Optional[float]:
        """Earliest sim time >= now at which ``src``->``dst`` might be
        reachable again, judging by the fault plan's windows. ``None`` means
        blocked indefinitely (an endpoint is *manually* down — only a
        restart unblocks it; senders should park, not poll). Returns now
        when already reachable."""
        if src in self._down_nodes or dst in self._down_nodes:
            return None
        t = self.clock.now_ms
        if self.fault_plan is None:
            return t
        for _ in range(64):  # fixpoint over possibly-chained windows
            bound = t
            for w in self.fault_plan.node_down:
                if w.covers(src, t) or w.covers(dst, t):
                    bound = max(bound, w.end_ms)
            for w in self.fault_plan.partitions:
                if w.severs(src, dst, t):
                    bound = max(bound, w.end_ms)
            if bound == t:
                return t
            t = bound
        return t

    def _drawn_dropped(self, src: str, dst: str) -> bool:
        if self.fault_plan is None or self._fault_rng is None:
            return False
        p = self.fault_plan.drop_probability(src, dst, self.clock.now_ms)
        if p <= 0.0:
            return False
        return self._fault_rng.random() < p

    # -- accounting ---------------------------------------------------------
    def counter(self, src: str, dst: str, tag: str) -> TrafficCounter:
        key = (src, dst, tag)
        if key not in self._counters:
            self._counters[key] = TrafficCounter()
        return self._counters[key]

    def bytes_for_tag(self, tag: str) -> int:
        return sum(c.bytes_total for (s, d, t), c in self._counters.items() if t == tag)

    def messages_for_tag(self, tag: str) -> int:
        return sum(c.messages for (s, d, t), c in self._counters.items() if t == tag)

    def traffic_snapshot(self) -> Dict[Tuple[str, str, str], Tuple[int, int]]:
        """Immutable view of every counter — the determinism property test
        compares two runs' snapshots for equality."""
        return {k: (c.bytes_total, c.messages) for k, c in self._counters.items()}

    # -- transfers ----------------------------------------------------------
    def transfer_ms(self, src: str, dst: str, n_bytes: int) -> float:
        """One-way transfer time under the link's current (possibly
        degraded) latency and bandwidth."""
        link = self.link(src, dst)
        lat, bw = link.latency_ms, link.bandwidth_mbps
        if self.fault_plan is not None:
            now = self.clock.now_ms
            for w in self.fault_plan.degraded:
                if w.covers(src, dst, now):
                    lat *= w.latency_mult
                    bw *= w.bandwidth_mult
        return lat + (n_bytes * 8) / (max(bw, 1e-9) * 1e3)

    def send(self, src: str, dst: str, n_bytes: int, tag: str) -> float:
        """Synchronous transfer: returns the transfer time in ms (caller
        advances the clock — used for the client<->node request path)."""
        self.counter(src, dst, tag).record(n_bytes)
        return self.transfer_ms(src, dst, n_bytes)

    def send_async(
        self,
        src: str,
        dst: str,
        n_bytes: int,
        tag: str,
        on_delivery: Callable[[], None],
        extra_delay_ms: float = 0.0,
        on_failure: Optional[Callable[[str], None]] = None,
    ) -> float:
        """Asynchronous transfer (replication path): schedules ``on_delivery``
        at arrival time and returns it.

        Failure semantics (docs/architecture.md, "Failure model"): if the
        peers are unreachable at send time the send fails after one link
        latency (connection refused — no payload bytes are billed); if the
        message is drawn as dropped, or the destination is down/partitioned
        at *arrival* time (cut mid-flight), the payload is billed but
        ``on_failure(reason)`` fires at arrival instead of ``on_delivery``.
        With ``on_failure=None`` failures are silent losses (legacy
        callers), still counted in ``dropped_messages``/``failed_sends``."""
        now = self.clock.now_ms
        if not self.reachable(src, dst):
            self.failed_sends += 1
            reason = self.unreachable_reason(src, dst)
            fail_at = now + extra_delay_ms + self.link(src, dst).latency_ms
            if on_failure is not None:
                heapq.heappush(
                    self._events,
                    (fail_at, next(self._seq), lambda: on_failure(reason)),
                )
            return fail_at

        self.counter(src, dst, tag).record(n_bytes)
        arrival = now + extra_delay_ms + self.transfer_ms(src, dst, n_bytes)

        if self._drawn_dropped(src, dst):
            self.dropped_messages += 1
            if on_failure is not None:
                heapq.heappush(
                    self._events,
                    (arrival, next(self._seq), lambda: on_failure(FAIL_DROPPED)),
                )
            return arrival

        def deliver_or_fail() -> None:
            # a message in flight when its destination dies or the link
            # partitions is lost at arrival, not silently delivered
            if self.reachable(src, dst):
                on_delivery()
                return
            self.dropped_messages += 1
            if on_failure is not None:
                on_failure(self.unreachable_reason(src, dst))

        heapq.heappush(self._events, (arrival, next(self._seq), deliver_or_fail))
        return arrival

    def schedule(self, at_ms: float, fn: Callable[[], None]) -> None:
        heapq.heappush(self._events, (at_ms, next(self._seq), fn))

    # -- event pump ---------------------------------------------------------
    def deliver_until(self, t_ms: Optional[float] = None) -> int:
        """Apply every event with arrival <= t_ms (default: now). Returns the
        number applied. Does NOT advance the clock."""
        limit = self.clock.now_ms if t_ms is None else t_ms
        n = 0
        while self._events and self._events[0][0] <= limit:
            _, _, fn = heapq.heappop(self._events)
            fn()
            n += 1
        return n

    def advance(self, dt_ms: float) -> None:
        self.clock.advance(dt_ms)
        self.deliver_until()

    def run_until_quiet(self, max_ms: float = 1e9) -> float:
        """Drain all pending events (eventual-consistency convergence)."""
        while self._events and self._events[0][0] <= max_ms:
            t, _, fn = heapq.heappop(self._events)
            self.clock.advance_to(t)
            fn()
        return self.clock.now_ms

    def run_until(self, cond: Callable[[], bool], max_ms: float = 1e9) -> bool:
        """Process events in arrival order until ``cond()`` holds (e.g. a
        Ticket resolving). Unlike :meth:`run_until_quiet`, events past the
        condition stay pending — the blocking-API shims use this so a
        serialized ``chat()`` stops the clock at response receipt instead of
        fast-forwarding through every in-flight replication.

        Returns whether ``cond()`` held when the loop stopped — ``False``
        means the event queue ran dry (or passed ``max_ms``) without the
        condition ever holding, so callers (e.g. the client ticket-deadline
        path) can tell quiescence apart from success."""
        while not cond():
            if not self._events or self._events[0][0] > max_ms:
                return False
            t, _, fn = heapq.heappop(self._events)
            self.clock.advance_to(t)
            fn()
        return True

    @property
    def pending_events(self) -> int:
        return len(self._events)
