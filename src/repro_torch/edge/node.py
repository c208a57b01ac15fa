"""Edge node: Context Manager + LLM Service + local KV replica (paper Fig. 1)
— the port's copy of ``repro.edge.node``.

One :class:`EdgeNode` is the unit of deployment in a DisCEdge cluster — the
co-located triple the paper runs on each edge machine. Beyond the paper, the
node is also where the *migration warm-start* hook lives (docs/
architecture.md, "Migration warm-start"): the node subscribes to replicated
context writes landing on its local KV replica
(:meth:`repro_torch.store.distributed.DistributedKVStore.on_apply`) and, for each
arriving tokenized context, asks its LLM Service to ``prime`` the session
KV-cache pool with that token sequence. When the roaming client's next turn
lands here, the engine prefix-matches the primed entry and prefills only the
new tokens — the node switch stops being a full re-prefill.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from time import perf_counter
from typing import TYPE_CHECKING, Callable, Dict, Optional

from ..core.consistency import RetryPolicy
from ..core.manager import ContextManager, LLMServiceProtocol
from ..core.protocol import OVERLOADED, Request, Response, Ticket, Timing
from ..store.distributed import DistributedKVStore
from ..store.kvstore import VersionedValue

if TYPE_CHECKING:  # fleet imports edge; the reverse stays type-only
    from ..fleet.admission import AdmissionControl

# EWMA smoothing for the node's observed generation throughput — one
# decade of turns dominates the estimate (docs/architecture.md, "Fleet
# layer").
_TPS_ALPHA = 0.3


@dataclass
class LoadReport:
    """One node's telemetry snapshot, published on the fleet heartbeat
    (docs/architecture.md, "Fleet layer"). Consumers must treat it as
    *possibly stale*: it describes the node at ``sent_at_ms``, and the
    router reads it at ``received_at_ms`` or later — never as ground truth
    for liveness (client failover is the correctness backstop)."""

    node_id: str
    sent_at_ms: float
    # cache_key -> resident KV token count in the node's session pool
    resident: Dict[str, int] = field(default_factory=dict)
    active: int = 0        # turns between submit and finish
    queue_depth: int = 0   # active beyond the service's slot count
    ewma_tps: float = 0.0  # smoothed generation throughput (tok/s)
    received_at_ms: float = 0.0  # stamped by the heartbeat bus on delivery

    def wire_bytes(self) -> int:
        # header/ids/counters + one (key-hash, token-count) pair per entry
        return 96 + 16 * len(self.resident)


@dataclass
class EdgeNode:
    node_id: str
    manager: ContextManager
    service: LLMServiceProtocol
    # Migration warm-start accounting: primes performed on replication
    # arrival, and the wall time they cost (off the client-observable path —
    # the work overlaps client think time, like the paper's async update).
    warm_starts: int = 0
    warm_start_ms: float = 0.0
    # Liveness (docs/architecture.md, "Failure model"): a crashed node
    # refuses new submits, fails its in-flight turns fast, and loses its
    # volatile session-KV pool; the KV *replica* survives unless the
    # cluster-level crash was invoked with lose_replica=True.
    alive: bool = True
    crashes: int = 0
    # Fleet layer (docs/architecture.md): optional per-node admission
    # controller (None: admit everything — the pre-fleet behaviour) and the
    # smoothed generation throughput published in load reports.
    admission: Optional["AdmissionControl"] = None
    ewma_tps: float = 0.0
    # KV-page shipping (docs/architecture.md, "KV page shipping"): the
    # cluster's KVShipper when this node participates (None: every
    # replication arrival primes by token recompute — the recompute-only behaviour).
    kv_ship: Optional[object] = None
    kv_ships: int = 0            # shipped-page installs completed here
    kv_ship_fallbacks: int = 0   # failed ships that recomputed instead

    @classmethod
    def create(
        cls,
        node_id: str,
        store: DistributedKVStore,
        service: LLMServiceProtocol,
        retry: Optional[RetryPolicy] = None,
        warm_start: str = "eager",
    ) -> "EdgeNode":
        """``warm_start="eager"`` (default) subscribes the node to
        replication arrivals and proactively primes the service's session
        KV pool; ``"off"`` reverts to lazy behaviour — the first turn after
        a node switch pays a full prefill, which registers the prefix so
        only *subsequent* turns are suffix-only (the lazy baseline)."""
        assert warm_start in ("eager", "off"), warm_start
        mgr = ContextManager(
            node_id=node_id,
            store=store,
            service=service,
            retry=retry or RetryPolicy(),
        )
        node = cls(node_id=node_id, manager=mgr, service=service)
        if warm_start == "eager" and service.capabilities().prime:
            store.on_apply(node_id, node._on_replicated_context)
        return node

    def submit(
        self, req: Request, on_done: Optional[Callable[[Response], None]] = None
    ) -> Ticket:
        """Async serving entrypoint: start the request's prepare phase now
        (its node-arrival time) and return a :class:`Ticket` that resolves
        when the finish phase completes on the event clock. Many tenants'
        tickets can be in flight at once; drive them with
        ``EdgeCluster.run_until_quiet()``."""
        net = self.manager.store.network
        ticket = Ticket(request=req, submitted_at_ms=net.clock.now_ms)

        def resolve(resp: Response) -> None:
            if resp.error is None and resp.tps > 0:
                self.ewma_tps = (
                    resp.tps if self.ewma_tps == 0.0
                    else _TPS_ALPHA * resp.tps + (1 - _TPS_ALPHA) * self.ewma_tps
                )
            ticket.resolve(resp, net.clock.now_ms)
            if on_done is not None:
                on_done(resp)

        if self.admission is not None and not self.admission.admit(
            self.manager.inflight_count
        ):
            # Shed at the door — before any prepare work. The refusal is a
            # normal response on the downlink (the client requeues it on a
            # peer), not a node-down error: the node is alive, just full.
            resolve(Response(
                text="", user_id=req.user_id or "",
                session_id=req.session_id or "", turn=req.turn,
                served_by=self.node_id, n_prompt_tokens=0,
                n_context_tokens=0, n_generated_tokens=0, timing=Timing(),
                error=(
                    f"{OVERLOADED}: {self.node_id} at "
                    f"{self.admission.limit} in-flight"
                ),
            ))
            return ticket

        self.manager.submit(req, resolve)
        return ticket

    # -- fleet telemetry ----------------------------------------------------
    def load_report(self) -> LoadReport:
        """Snapshot this node's load for the heartbeat (docs/architecture.md,
        "Fleet layer"): KV residency by cache key, observed concurrency, and
        smoothed throughput. Cheap by design — it reads counters and the
        pool's key index, never device state."""
        resident_fn = getattr(self.service, "resident_keys", None)
        resident = dict(resident_fn()) if resident_fn is not None else {}
        active = self.manager.inflight_count
        n_slots = max(1, self.service.capabilities().n_slots)
        return LoadReport(
            node_id=self.node_id,
            sent_at_ms=self.manager.store.network.clock.now_ms,
            resident=resident,
            active=active,
            queue_depth=max(0, active - n_slots),
            ewma_tps=self.ewma_tps,
        )

    def handle(self, req: Request) -> Response:
        """Blocking compatibility shim (see ContextManager.handle)."""
        return self.manager.handle(req)

    # -- churn --------------------------------------------------------------
    def crash(self) -> int:
        """Process crash: in-flight turns fail fast with a node-down error,
        the service drops its volatile session-KV state, and new submits are
        refused until :meth:`restart`. Returns the number of in-flight turns
        failed. (The KV replica is the store's concern — see
        ``EdgeCluster.crash``.)"""
        self.alive = False
        self.crashes += 1
        failed = self.manager.crash()
        crash_fn = getattr(self.service, "crash", None)
        if crash_fn is not None:
            crash_fn()
        return failed

    def restart(self) -> int:
        """Come back up and re-prime the session KV pool from whatever the
        local replica still holds (the warm-start hook replays each stored
        tokenized context). Anti-entropy catch-up is the cluster/store's
        job; contexts it ships will prime through the normal apply hook.
        Returns the number of contexts re-primed."""
        self.alive = True
        self.manager.restart()
        primed = 0
        if not self.service.capabilities().prime:
            return 0
        store = self.manager.store
        keygroup = self.manager.keygroup
        if store.has_replica(self.node_id, keygroup):
            for key, vv in list(store.replica(self.node_id, keygroup).items()):
                before = self.warm_starts
                self._on_replicated_context(keygroup, key, vv)
                primed += self.warm_starts - before
        return primed

    # -- migration warm-start hook ----------------------------------------
    def _on_replicated_context(
        self, keygroup: str, key: str, vv: VersionedValue
    ) -> None:
        """Replication arrival → pre-warm the session KV pool. Only
        tokenized contexts for this node's own model prime anything; raw
        text has no token ids to prefill (the paper's raw baseline gets no
        warm start — one more cost of storing text).

        With a mounted :class:`~repro_torch.store.kv_ship.KVShipper`, this is
        also the ship-vs-recompute decision point (docs/architecture.md,
        "KV page shipping"): when the write originated on a *different*
        node and the measured cost model says shipping that node's KV pages
        beats re-prefilling the tokens here, the shipper takes ownership of
        the prime — it ends in :meth:`_ship_install` or a visible
        :meth:`_ship_fallback`, never silently."""
        if keygroup != self.service.model:
            return
        ids = getattr(vv.value, "ids", None)
        if not ids:
            return
        origin = getattr(vv, "origin", "")
        if (
            self.kv_ship is not None
            and self.alive
            and origin
            and origin != self.node_id
            and self.kv_ship.maybe_ship(
                keygroup, key, origin, self.node_id, list(ids)
            )
        ):
            return  # the shipper owns this prime now
        self._prime_tokens(key, ids)

    def _prime_tokens(self, key: str, ids) -> None:
        """The token-recompute prime (also the shipper's fallback)."""
        t0 = perf_counter()
        if self.service.prime(key, list(ids)):
            self.warm_starts += 1
            self.warm_start_ms += (perf_counter() - t0) * 1e3

    # -- KVShipper hooks ---------------------------------------------------
    def _ship_install(
        self, key: str, token_ids, payloads, have_pages: int
    ) -> bool:
        """Installer hook: digest-verified pages arrive — put them in the
        session pool. False (node down, or the service can't take pages)
        sends the shipper to the fallback path."""
        if not self.alive:
            return False
        install = getattr(self.service, "install_kv_pages", None)
        if install is None:
            return False
        t0 = perf_counter()
        ok = bool(install(key, list(token_ids), payloads, have_pages))
        if ok:
            self.kv_ships += 1
            self.warm_starts += 1
            self.warm_start_ms += (perf_counter() - t0) * 1e3
        return ok

    def _ship_fallback(self, key: str, token_ids, reason: str) -> None:
        """Fallback hook: the ship failed (NACK, retries exhausted, stale
        at apply, install refused) — degrade gracefully to the token
        recompute prime, visibly counted."""
        if not self.alive:
            return
        self.kv_ship_fallbacks += 1
        self._prime_tokens(key, token_ids)
