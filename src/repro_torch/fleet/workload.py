"""Heavy-traffic scenario engine (docs/architecture.md, "Fleet layer") —
the port's copy of ``repro.fleet.workload``: the same seeded numpy draws,
so the same plans as JAX for the same spec.

The paper's experiments drive a handful of sessions; the fleet layer is
judged under *populations*. This module generates seeded, reproducible
traffic with the shapes real chat fleets show —

- **session arrivals** from a nonhomogeneous Poisson process (thinning)
  whose rate follows a diurnal sine ramp;
- **session lengths** from a bounded Pareto (most sessions are short, a
  heavy tail runs long — exactly the sessions KV residency pays off for);
- **prompt families** from a Zipf law (a few openings dominate, mirroring
  shared system prompts / FAQ traffic);
- optional **node churn** mid-run (crash/restart on the event clock).

``generate_workload(spec)`` is a *pure* function of the spec — same seed,
same trace, byte for byte (property-tested) — so every routing policy in a
benchmark faces the identical workload. ``run_fleet`` replays a trace
against a built cluster through routed clients and reduces the outcome to
fleet metrics (aggregate tok/s, latency percentiles, KV-hit/shed rates).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..core.protocol import ConsistencyPolicy
from ..edge.client import LLMClient, SessionTrace
from ..edge.cluster import EdgeCluster
from .router import HEARTBEAT_TAG


@dataclass(frozen=True)
class WorkloadSpec:
    """Everything the generator needs; all randomness flows from ``seed``."""

    n_clients: int = 256
    seed: int = 0
    # arrival process: base rate in sessions/s, diurnal modulation
    # rate(t) = base * (1 + amplitude * sin(2*pi*t / period_ms))
    arrival_rate_per_s: float = 8.0
    diurnal_amplitude: float = 0.6
    diurnal_period_ms: float = 60_000.0
    # bounded-Pareto session length (turns)
    pareto_alpha: float = 1.5
    max_turns: int = 12
    # Zipf prompt families (shared openings)
    n_families: int = 16
    zipf_s: float = 1.1
    # per-session think time mean (exponential), floored
    think_ms_mean: float = 800.0
    think_ms_min: float = 50.0
    max_new_tokens: int = 64


@dataclass(frozen=True)
class SessionPlan:
    """One client's scripted session (pure data — no cluster references)."""

    client: int
    start_ms: float
    family: int
    think_ms: float
    prompts: tuple  # of str, len == n_turns


@dataclass(frozen=True)
class ChurnEvent:
    """Crash ``node_id`` at ``crash_at_ms``; restart at ``restart_at_ms``
    (None: stays down)."""

    node_id: str
    crash_at_ms: float
    restart_at_ms: Optional[float] = None


_FAMILY_TOPICS = [
    "robot arm calibration", "sensor fusion drift", "path planning detour",
    "battery power budget", "lidar point filtering", "map tile updates",
    "gripper force control", "wheel odometry slip", "camera exposure lock",
    "motor thermal limits", "waypoint replanning", "imu bias estimate",
    "depth frame dropout", "docking alignment", "payload manifest check",
    "radio link fallback",
]


def _arrival_times(
    rng: np.random.Generator, n: int, spec: WorkloadSpec
) -> List[float]:
    """Nonhomogeneous Poisson via thinning against the peak rate."""
    peak_per_ms = spec.arrival_rate_per_s * (1 + spec.diurnal_amplitude) / 1e3
    t, out = 0.0, []
    while len(out) < n:
        t += float(rng.exponential(1.0 / peak_per_ms))
        rate = spec.arrival_rate_per_s * (
            1 + spec.diurnal_amplitude
            * math.sin(2 * math.pi * t / spec.diurnal_period_ms)
        ) / 1e3
        if rng.random() < rate / peak_per_ms:
            out.append(round(t, 3))
    return out


def generate_workload(spec: WorkloadSpec) -> List[SessionPlan]:
    """Pure seeded generation: same spec => identical plan list (the
    determinism property the benchmark's policy comparison rests on)."""
    rng = np.random.default_rng(spec.seed)
    starts = _arrival_times(rng, spec.n_clients, spec)
    fam_p = np.array(
        [1.0 / (k + 1) ** spec.zipf_s for k in range(spec.n_families)]
    )
    fam_p /= fam_p.sum()
    plans: List[SessionPlan] = []
    for i in range(spec.n_clients):
        family = int(rng.choice(spec.n_families, p=fam_p))
        n_turns = min(spec.max_turns, 1 + int(rng.pareto(spec.pareto_alpha) * 2))
        think = max(spec.think_ms_min, float(rng.exponential(spec.think_ms_mean)))
        topic = _FAMILY_TOPICS[family % len(_FAMILY_TOPICS)]
        prompts = tuple(
            f"about {topic}: question {t} from client {i}"
            if t else f"help with {topic}"
            for t in range(n_turns)
        )
        plans.append(SessionPlan(
            client=i, start_ms=starts[i], family=family,
            think_ms=round(think, 3), prompts=prompts,
        ))
    return plans


@dataclass
class FleetResult:
    """Outcome of one scenario run, reduced to the fleet metrics the
    benchmark compares across routing policies."""

    policy: str
    n_sessions: int
    n_turns: int
    ok_turns: int
    error_turns: int
    hung_tickets: int
    makespan_ms: float
    agg_tok_s: float
    p50_ms: float
    p99_ms: float
    kv_hit_rate: float
    shed_rate: float
    sheds: int
    requeues: int
    failovers: int
    timeouts: int
    evictions: int
    router_decisions: int
    stale_fallbacks: int
    heartbeat_bytes: int
    traces: List[SessionTrace] = field(default_factory=list, repr=False)

    def summary(self) -> Dict[str, object]:
        return {
            k: getattr(self, k)
            for k in (
                "policy", "n_sessions", "n_turns", "ok_turns", "error_turns",
                "hung_tickets", "makespan_ms", "agg_tok_s", "p50_ms",
                "p99_ms", "kv_hit_rate", "shed_rate", "sheds", "requeues",
                "failovers", "timeouts", "evictions", "router_decisions",
                "stale_fallbacks", "heartbeat_bytes",
            )
        }


def _percentile(values: Sequence[float], p: float) -> float:
    if not values:
        return 0.0
    return float(np.percentile(np.asarray(values, dtype=float), p))


def run_fleet(
    cluster: EdgeCluster,
    plans: Sequence[SessionPlan],
    *,
    policy_name: str = "",
    churn: Sequence[ChurnEvent] = (),
    timeout_ms: float = 60_000.0,
    max_attempts: int = 4,
    consistency: ConsistencyPolicy = ConsistencyPolicy.STRONG,
    max_ms: float = 1e9,
) -> FleetResult:
    """Replay a workload through routed clients (``node_id=None`` — the
    cluster must have a mounted router) with churn events on the clock,
    drive to quiescence, and reduce to :class:`FleetResult`. Every ticket
    must resolve; ``hung_tickets`` counts the ones that did not."""
    assert cluster.router is not None, "run_fleet needs a mounted router"
    net = cluster.network
    clients = [
        LLMClient(
            cluster, model=_fleet_model(cluster),
            policy=consistency, max_new_tokens=64,
            timeout_ms=timeout_ms, max_attempts=max_attempts,
            failover_backoff_ms=10.0,
        )
        for _ in plans
    ]
    traces = [
        c.run_session(
            [(p, None) for p in plan.prompts],
            think_ms=plan.think_ms,
            continue_on_error=True,
            start_delay_ms=plan.start_ms,
        )
        for c, plan in zip(clients, plans)
    ]
    for ev in churn:
        net.schedule(ev.crash_at_ms, lambda n=ev.node_id: cluster.crash(n))
        if ev.restart_at_ms is not None:
            net.schedule(
                ev.restart_at_ms, lambda n=ev.node_id: cluster.restart(n)
            )
    t0 = net.clock.now_ms
    cluster.run_until_quiet(max_ms)

    all_tickets = [t for tr in traces for t in tr.tickets]
    hung = sum(1 for t in all_tickets if not t.done)
    # Serving horizon = last response delivery, not the final clock: the
    # drain also fires every per-attempt deadline timer that never mattered
    # (they are no-ops ~timeout_ms after the last turn), which would
    # understate aggregate throughput by that dead tail.
    done_at = [t.completed_at_ms for t in all_tickets if t.done]
    makespan = (max(done_at) - t0) if done_at else net.clock.now_ms - t0
    ok_lat: List[float] = []
    gen_tokens = 0
    kv_eligible = kv_hits = 0
    ok = err = 0
    for tr in traces:
        for i, t in enumerate(tr.tickets):
            if not t.done:
                continue
            r = t.response
            if r.error is None:
                ok += 1
                ok_lat.append(t.latency_ms)
                gen_tokens += r.n_generated_tokens
                if i > 0:  # a session's first turn has nothing to hit
                    kv_eligible += 1
                    kv_hits += int(r.timing.kv_cache_hit)
            else:
                err += 1
    sheds = sum(
        n.admission.sheds for n in cluster.nodes.values()
        if n.admission is not None
    )
    admitted = sum(
        n.admission.admitted for n in cluster.nodes.values()
        if n.admission is not None
    )
    router = cluster.router
    return FleetResult(
        policy=policy_name or getattr(router.policy, "name", "?"),
        n_sessions=len(plans),
        n_turns=sum(len(p.prompts) for p in plans),
        ok_turns=ok,
        error_turns=err,
        hung_tickets=hung,
        makespan_ms=makespan,
        agg_tok_s=gen_tokens / (makespan / 1e3) if makespan > 0 else 0.0,
        p50_ms=_percentile(ok_lat, 50),
        p99_ms=_percentile(ok_lat, 99),
        kv_hit_rate=kv_hits / kv_eligible if kv_eligible else 0.0,
        shed_rate=sheds / max(1, sheds + admitted),
        sheds=sheds,
        requeues=sum(c.requeues for c in clients),
        failovers=sum(c.failovers for c in clients),
        timeouts=sum(c.timeouts for c in clients),
        evictions=sum(
            getattr(n.service, "evictions", 0) for n in cluster.nodes.values()
        ),
        router_decisions=router.decisions,
        stale_fallbacks=router.stale_fallbacks,
        heartbeat_bytes=net.bytes_for_tag(HEARTBEAT_TAG),
        traces=list(traces),
    )


def _fleet_model(cluster: EdgeCluster) -> str:
    names = cluster.store.keygroup_names()
    assert len(names) == 1, "run_fleet drives single-model clusters"
    return names[0]
