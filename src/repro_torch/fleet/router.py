"""Fleet router: KV-residency-aware request placement over stale telemetry
(docs/architecture.md, "Fleet layer") — the port's copy of
``repro.fleet.router``.

The paper's clients pick their edge node explicitly (geo/mobility is the
experiment variable); at fleet scale the choice becomes a policy problem —
a session's next turn is cheap exactly where its KV prefix is resident, but
that node may also be the most loaded. The router closes this loop with
three pieces:

- :class:`~repro_torch.edge.node.LoadReport` — each node's telemetry snapshot
  (pool residency by cache key, active turns, queue depth, EWMA tok/s),
  produced by :meth:`EdgeNode.load_report`.
- :class:`HeartbeatBus` — publishes each live node's report over the
  simulated network on a gossip-style interval. Reports arrive late and age
  in place: every routing decision reads *possibly stale* data.
- :class:`FleetRouter` — keeps the freshest report per node and ranks a
  keygroup's members through a pluggable :class:`RoutingPolicy`
  (``random`` / ``round_robin`` / ``residency``).

Staleness is embraced, not hidden: a report older than ``stale_after_ms``
drops its node from candidacy (it may be dead), but if *every* member looks
stale the router falls back to all of them — routing must always return
someone, and the client's failover/requeue path is the correctness
backstop when the choice turns out to be wrong. A routed fleet under churn
therefore degrades to extra attempts, never to hung tickets.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Protocol, Sequence

import numpy as np

from ..edge.cluster import EdgeCluster
from ..edge.node import LoadReport

HEARTBEAT_TAG = "fleet-heartbeat"

# A node whose freshest report is older than this is presumed unavailable
# for routing (crash window >> heartbeat interval); liveness truth stays
# with the network + client failover.
DEFAULT_STALE_AFTER_MS = 2_000.0
DEFAULT_HEARTBEAT_MS = 250.0


class RoutingPolicy(Protocol):
    """Pluggable placement policy. ``reports`` holds only *fresh* reports
    (possibly none for some candidates); implementations must return one of
    ``candidates``."""

    name: str

    def choose(
        self,
        candidates: Sequence[str],
        cache_key: Optional[str],
        reports: Dict[str, LoadReport],
        now_ms: float,
    ) -> str: ...


@dataclass
class RandomPolicy:
    """Uniform seeded choice — the fleet baseline (no telemetry read)."""

    seed: int = 0
    name: str = "random"

    def __post_init__(self) -> None:
        self._rng = np.random.default_rng(self.seed)

    def choose(self, candidates, cache_key, reports, now_ms):
        return candidates[int(self._rng.integers(len(candidates)))]


@dataclass
class RoundRobinPolicy:
    """Cycle through candidates — load-blind fairness baseline."""

    name: str = "round_robin"
    _i: int = field(default=0, repr=False)

    def choose(self, candidates, cache_key, reports, now_ms):
        pick = candidates[self._i % len(candidates)]
        self._i += 1
        return pick


@dataclass
class ResidencyPolicy:
    """Score = (1 + resident_tokens(cache_key)) / (1 + active + queue_depth).

    The numerator prices KV residency (prefill avoided if routed here); the
    denominator prices the queue the request would join. A node at or above
    ``shed_limit`` active turns forfeits its residency bonus and scores
    ``overload_penalty / queue`` instead — its KV is worthless to a request
    it would shed, so routing there (a shed + requeue round-trip) happens
    only when everyone is full, ordered by relative load. Candidates
    without a fresh report score as cold-and-idle (1.0). Ties break by
    rotation, not index order, so a cold start spreads instead of
    dogpiling the first member.
    """

    shed_limit: Optional[int] = None
    overload_penalty: float = 0.01
    name: str = "residency"
    _tie: int = field(default=0, repr=False)

    def score(
        self, nid: str, cache_key: Optional[str], reports: Dict[str, LoadReport]
    ) -> float:
        r = reports.get(nid)
        if r is None:
            return 1.0
        load = 1.0 + r.active + r.queue_depth
        if self.shed_limit is not None and r.active >= self.shed_limit:
            return self.overload_penalty / load
        resident = r.resident.get(cache_key, 0) if cache_key is not None else 0
        return (1.0 + resident) / load

    def choose(self, candidates, cache_key, reports, now_ms):
        best = max(self.score(n, cache_key, reports) for n in candidates)
        tied = [n for n in candidates if self.score(n, cache_key, reports) == best]
        pick = tied[self._tie % len(tied)]
        self._tie += 1
        return pick


def make_policy(name: str, *, seed: int = 0, shed_limit: Optional[int] = None):
    """Policy registry for benchmarks/CLI (`random`/`round_robin`/`residency`)."""
    if name == "random":
        return RandomPolicy(seed=seed)
    if name == "round_robin":
        return RoundRobinPolicy()
    if name == "residency":
        return ResidencyPolicy(shed_limit=shed_limit)
    raise ValueError(f"unknown routing policy: {name!r}")


@dataclass
class FleetRouter:
    """Keeps the freshest :class:`LoadReport` per node and ranks keygroup
    members for the client. Mounted on the cluster by
    ``EdgeCluster.build(router=...)``; :meth:`route` is consulted by
    ``LLMClient.submit`` for the primary target *and* on every failover/
    requeue attempt (with the already-tried nodes excluded)."""

    cluster: EdgeCluster
    policy: RoutingPolicy
    stale_after_ms: float = DEFAULT_STALE_AFTER_MS
    reports: Dict[str, LoadReport] = field(default_factory=dict)
    bus: Optional["HeartbeatBus"] = None
    decisions: int = 0
    stale_fallbacks: int = 0  # routed with zero fresh reports

    def observe(self, report: LoadReport) -> None:
        """Ingest a delivered heartbeat; reports may arrive reordered over
        the network — keep the one *sent* last."""
        prev = self.reports.get(report.node_id)
        if prev is None or report.sent_at_ms >= prev.sent_at_ms:
            self.reports[report.node_id] = report

    def fresh_reports(self, members: Sequence[str]) -> Dict[str, LoadReport]:
        now = self.cluster.network.clock.now_ms
        return {
            nid: r
            for nid in members
            if (r := self.reports.get(nid)) is not None
            and now - r.received_at_ms <= self.stale_after_ms
        }

    def route(
        self,
        model: str,
        cache_key: Optional[str] = None,
        exclude: Sequence[str] = (),
    ) -> List[str]:
        """Rank the model's keygroup members for one attempt: the policy's
        pick first, then the rest by descending score (the client walks this
        list only if the pick sheds or fails). ``exclude`` removes nodes this
        turn already tried — unless that empties the slate (every member
        tried: retrying one beats hanging)."""
        if self.bus is not None:
            self.bus.kick()  # routing implies traffic: keep telemetry flowing
        members = list(self.cluster.store.keygroup(model).members)
        candidates = [m for m in members if m not in set(exclude)] or members
        fresh = self.fresh_reports(members)
        live = [m for m in candidates if m in fresh]
        if not live:
            # all stale/unreported (cold start, mass churn): route blind —
            # failover sorts out who is actually up
            self.stale_fallbacks += 1
            live = candidates
        now = self.cluster.network.clock.now_ms
        first = self.policy.choose(live, cache_key, fresh, now)
        self.decisions += 1
        scorer = getattr(self.policy, "score", None)
        rest = [m for m in candidates if m != first]
        if scorer is not None:
            rest.sort(key=lambda m: scorer(m, cache_key, fresh), reverse=True)
        return [first] + rest


@dataclass
class HeartbeatBus:
    """Per-node heartbeat chains on the discrete-event clock.

    Each live node periodically sends its :meth:`EdgeNode.load_report` to
    the router's vantage point (the client host — one hop, like the request
    path) as a billed async message; delivery stamps ``received_at_ms`` and
    feeds :meth:`FleetRouter.observe`. Crashed/partitioned nodes' reports
    fail visibly and simply age out at the router.

    Chains are **self-terminating** so ``run_until_quiet()`` still means
    quiescence: a tick only reschedules itself while the simulation has
    *other* pending work (anything beyond the live ticks and in-flight
    heartbeat messages the bus itself accounts for). When the fleet goes
    idle the chains die out; :meth:`kick` (called on every route and on
    node restart) revives them.
    """

    cluster: EdgeCluster
    router: FleetRouter
    interval_ms: float = DEFAULT_HEARTBEAT_MS
    listener: str = "client"  # CLIENT_HOST — the router's vantage point
    sent: int = 0
    failed: int = 0
    _live: Dict[str, bool] = field(default_factory=dict, repr=False)
    _inflight: int = field(default=0, repr=False)

    def kick(self) -> None:
        """(Re)start the tick chain of every node that lacks one."""
        net = self.cluster.network
        for nid in self.cluster.nodes:
            if not self._live.get(nid):
                self._live[nid] = True
                net.schedule(net.clock.now_ms, lambda n=nid: self._tick(n))

    def _tick(self, nid: str) -> None:
        net = self.cluster.network
        node = self.cluster.nodes.get(nid)
        if node is not None and node.alive and net.node_is_up(nid):
            report = node.load_report()

            def deliver() -> None:
                self._inflight -= 1
                report.received_at_ms = net.clock.now_ms
                self.router.observe(report)

            def fail(_reason: str) -> None:
                self._inflight -= 1
                self.failed += 1

            self._inflight += 1
            self.sent += 1
            net.send_async(
                nid, self.listener, report.wire_bytes(), HEARTBEAT_TAG,
                deliver, on_failure=fail,
            )
        # Reschedule only while the sim has work that is not the bus's own:
        # this tick's event is already popped, so the bus currently owns
        # (live chains - 1) scheduled ticks plus its in-flight messages.
        ours = (sum(self._live.values()) - 1) + self._inflight
        if net.pending_events - ours > 0:
            net.schedule(
                net.clock.now_ms + self.interval_ms, lambda: self._tick(nid)
            )
        else:
            self._live[nid] = False


def mount_router(
    cluster: EdgeCluster,
    policy: RoutingPolicy,
    *,
    stale_after_ms: float = DEFAULT_STALE_AFTER_MS,
    heartbeat_ms: float = DEFAULT_HEARTBEAT_MS,
) -> FleetRouter:
    """Attach a router + heartbeat bus to a built cluster (also reachable
    via ``EdgeCluster.build(router=policy_or_name)``). Sets
    ``cluster.router`` — the attribute ``LLMClient`` consults."""
    router = FleetRouter(
        cluster=cluster, policy=policy, stale_after_ms=stale_after_ms
    )
    router.bus = HeartbeatBus(
        cluster=cluster, router=router, interval_ms=heartbeat_ms
    )
    cluster.router = router
    router.bus.kick()
    return router
