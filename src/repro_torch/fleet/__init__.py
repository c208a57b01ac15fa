"""Fleet layer (docs/architecture.md, "Fleet layer") — the port's copy of
``repro.fleet``, on numpy and the port's system layers.

Scales DisCEdge from the paper's explicitly-steered sessions to
populations of clients: KV-residency-aware routing over gossiped, possibly
stale node telemetry (:mod:`.router`), per-node admission control and
adaptive single-stream/batched mounting (:mod:`.admission`), and a seeded
heavy-traffic scenario engine (:mod:`.workload`).
"""

from .admission import AdaptiveLLMService, AdmissionControl
from .router import (
    DEFAULT_HEARTBEAT_MS,
    DEFAULT_STALE_AFTER_MS,
    HEARTBEAT_TAG,
    FleetRouter,
    HeartbeatBus,
    RandomPolicy,
    ResidencyPolicy,
    RoundRobinPolicy,
    RoutingPolicy,
    make_policy,
    mount_router,
)
from .workload import (
    ChurnEvent,
    FleetResult,
    SessionPlan,
    WorkloadSpec,
    generate_workload,
    run_fleet,
)

__all__ = [
    "AdaptiveLLMService",
    "AdmissionControl",
    "DEFAULT_HEARTBEAT_MS",
    "DEFAULT_STALE_AFTER_MS",
    "HEARTBEAT_TAG",
    "FleetRouter",
    "HeartbeatBus",
    "RandomPolicy",
    "ResidencyPolicy",
    "RoundRobinPolicy",
    "RoutingPolicy",
    "make_policy",
    "mount_router",
    "ChurnEvent",
    "FleetResult",
    "SessionPlan",
    "WorkloadSpec",
    "generate_workload",
    "run_fleet",
]
