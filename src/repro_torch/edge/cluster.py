"""Edge cluster wiring: nodes + network + distributed store + keygroups —
the port's copy of ``repro.edge.cluster``.

Builds the deployment the paper evaluates (§4.1): a set of
:class:`~repro_torch.edge.node.EdgeNode`s over a simulated network, one FReD-style
keygroup per model in a shared :class:`~repro_torch.store.distributed.
DistributedKVStore` (paper §3.3 — context replicates only among the nodes
serving that model). Beyond the paper, ``build(warm_start="eager")`` (the
default) also registers each node's migration warm-start hook: replicated
tokenized contexts pre-warm the destination node's session KV pool so a
roaming client resumes with a suffix-only prefill instead of a cold one —
see docs/architecture.md, "Migration warm-start".
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from ..core.consistency import RetryPolicy
from ..core.manager import LLMServiceProtocol
from ..core.tokens import TokenizedContext
from ..store.distributed import DistributedKVStore
from ..store.kv_ship import KVShipper
from ..store.network import FaultPlan, Link, Network
from .node import EdgeNode

CLIENT_UP_TAG = "client-up"
CLIENT_DOWN_TAG = "client-down"


@dataclass
class EdgeCluster:
    network: Network
    store: DistributedKVStore
    nodes: Dict[str, EdgeNode] = field(default_factory=dict)
    # Fleet layer (docs/architecture.md): the mounted FleetRouter, or None.
    # LLMClient consults it for placement; mount via build(router=...) or
    # repro_torch.fleet.mount_router on a built cluster.
    router: Optional[object] = None
    # KV-page shipping fabric (docs/architecture.md, "KV page shipping"),
    # mounted by build(kv_ship=True); None = replication always recomputes.
    kv_ship: Optional[KVShipper] = None

    @classmethod
    def build(
        cls,
        node_ids: List[str],
        service_factory: Callable[[str], LLMServiceProtocol],
        *,
        inter_node_link: Optional[Link] = None,
        client_link: Optional[Link] = None,
        replication: str = "full",
        retry: Optional[RetryPolicy] = None,
        context_ttl_ms: Optional[float] = None,
        warm_start: str = "eager",
        router: Optional[object] = None,
        admission_limit: Optional[int] = None,
        kv_ship: bool = False,
        kv_ship_force: Optional[str] = None,
        kv_ship_chunk_pages: int = 4,
    ) -> "EdgeCluster":
        """Build a cluster where every node serves the same model — one
        keygroup per model, membership = nodes serving it (paper §3.3).
        ``warm_start`` ("eager"/"off") controls the migration warm-start
        hook on each node (see EdgeNode.create).

        Fleet options (docs/architecture.md, "Fleet layer"): ``router``
        mounts a :class:`~repro_torch.fleet.router.FleetRouter` — pass a
        policy name (``"random"``/``"round_robin"``/``"residency"``) or a
        :class:`~repro_torch.fleet.router.RoutingPolicy` instance;
        ``admission_limit`` gives every node an
        :class:`~repro_torch.fleet.admission.AdmissionControl` with that
        concurrency target.

        ``kv_ship=True`` mounts a :class:`~repro_torch.store.kv_ship.KVShipper`
        and registers every node whose service exposes the shipping hooks
        (``kv_ship_profile`` returning non-None): replication arrivals
        then choose between shipping the origin's KV pages and token
        recompute via the measured cost model (``kv_ship_force`` pins one
        path for benches). Off by default — the recompute-only
        behaviour."""
        net = Network(default_link=inter_node_link or Link(latency_ms=1.0, bandwidth_mbps=1000.0))
        if client_link is not None:
            for nid in node_ids:
                net.set_link("client", nid, client_link)
        store = DistributedKVStore(net, replication=replication)
        cluster = cls(network=net, store=store)

        services = {nid: service_factory(nid) for nid in node_ids}
        # group nodes by model -> keygroups
        by_model: Dict[str, List[str]] = {}
        for nid, svc in services.items():
            by_model.setdefault(svc.model, []).append(nid)
        for model, members in by_model.items():
            tok = services[members[0]].tokenizer
            # The keygroup's size/delta closures bill replication traffic
            # with ONE member's tokenizer — sizes would silently lie if the
            # members tokenized differently (and a migrated context's token
            # ids would be garbage to the destination's engine).
            for m in members[1:]:
                other = services[m].tokenizer
                assert (
                    other.vocab_size == tok.vocab_size
                    and other.seed == tok.seed
                ), (
                    f"keygroup {model!r}: node {m!r} tokenizer "
                    f"(vocab={other.vocab_size}, seed={other.seed}) differs "
                    f"from {members[0]!r} (vocab={tok.vocab_size}, "
                    f"seed={tok.seed}) — keygroup members must share one"
                )
            store.create_keygroup(
                model,
                members,
                size_fn=lambda v, _tok=tok: v.wire_bytes(_tok),
                delta_size_fn=lambda v, since, _tok=tok: (
                    v.delta_wire_bytes(_tok, since)
                    if isinstance(v, TokenizedContext)
                    else v.wire_bytes(_tok)
                ),
                ttl_ms=context_ttl_ms,
            )
        for nid in node_ids:
            cluster.nodes[nid] = EdgeNode.create(
                nid, store, services[nid], retry=retry, warm_start=warm_start
            )
        if kv_ship:
            shipper = KVShipper(
                net, store, chunk_pages=kv_ship_chunk_pages,
                force=kv_ship_force,
            )
            for nid, node in cluster.nodes.items():
                svc = services[nid]
                profile_fn = getattr(svc, "kv_ship_profile", None)
                if profile_fn is None or profile_fn() is None:
                    continue  # this node can't ship — recompute-only
                node.kv_ship = shipper
                shipper.register_node(
                    nid, svc.model,
                    profile=profile_fn,
                    exporter=svc.export_kv_pages,
                    installer=node._ship_install,
                    fallback=node._ship_fallback,
                    coverage=svc.resident_ship_pages,
                )
            cluster.kv_ship = shipper
        if admission_limit is not None:
            from ..fleet.admission import AdmissionControl  # lazy: no cycle
            for node in cluster.nodes.values():
                node.admission = AdmissionControl(limit=admission_limit)
        if router is not None:
            from ..fleet.router import make_policy, mount_router
            policy = make_policy(router, shed_limit=admission_limit) \
                if isinstance(router, str) else router
            mount_router(cluster, policy)
        return cluster

    def node(self, node_id: str) -> EdgeNode:
        return self.nodes[node_id]

    def sync_bytes(self) -> int:
        return self.store.sync_bytes()

    def warm_starts(self) -> int:
        """Total pool primes performed on replication arrival, all nodes."""
        return sum(n.warm_starts for n in self.nodes.values())

    def kv_ship_stats(self) -> Dict[str, int]:
        """Cluster-wide KV-page shipping counters: the shipper's protocol
        stats plus the per-node install/fallback tallies (empty when
        shipping isn't mounted)."""
        if self.kv_ship is None:
            return {}
        stats = dict(self.kv_ship.stats())
        stats["node_ships"] = sum(n.kv_ships for n in self.nodes.values())
        stats["node_fallbacks"] = sum(
            n.kv_ship_fallbacks for n in self.nodes.values()
        )
        return stats

    def client_bytes_up(self) -> int:
        return self.network.bytes_for_tag(CLIENT_UP_TAG)

    def run_until_quiet(self, max_ms: float = 1e9) -> float:
        """Drive the submit/await event loop to quiescence: every in-flight
        ticket (uplinks, consistency-read retries, queued/batched inference,
        downlinks, chained session turns) and all replication is processed
        in timestamp order, interleaving concurrent tenants on the shared
        clock. Returns the final sim time."""
        return self.network.run_until_quiet(max_ms)

    def run_until(self, cond: Callable[[], bool], max_ms: float = 1e9) -> float:
        """Drive the event loop until ``cond()`` holds (e.g. one ticket's
        ``done``), leaving later events pending."""
        return self.network.run_until(cond, max_ms)

    def converge(self) -> None:
        """Drain in-flight replication (end-of-experiment barrier)."""
        self.network.run_until_quiet()

    # -- failure model (docs/architecture.md, "Failure model") -------------
    def install_faults(self, plan: FaultPlan) -> None:
        """Arm a deterministic fault schedule on the cluster's network."""
        self.network.install_faults(plan)

    def live_nodes(self) -> List[str]:
        return [nid for nid, n in self.nodes.items() if n.alive]

    def crash(self, node_id: str, *, lose_replica: bool = False) -> int:
        """Crash a node: it drops off the network (peers' replication to it
        parks in the outbox), its in-flight turns fail fast with node-down
        errors, and its volatile session-KV pool is lost. With
        ``lose_replica=True`` the node's KV *replica* is lost too (a
        non-durable store) — anti-entropy on restart re-fetches everything
        from peers. Returns the number of in-flight turns failed."""
        self.network.set_node_down(node_id, True)
        failed = self.nodes[node_id].crash()
        if lose_replica:
            self.store.drop_replica_data(node_id)
        if self.kv_ship is not None:
            # sender-side ship streams held exported page bytes in the
            # crashed process — gone; receivers re-request on restart.
            # The inbox (receiver) side is durable like the replica.
            self.kv_ship.crash(node_id)
        return failed

    def restart(self, node_id: str) -> None:
        """Bring a crashed node back: rejoin the network, re-prime the
        session pool from whatever the local replica kept, then run
        anti-entropy catch-up (peers ship only the versions this node
        missed; its own parked outbox writes ship out too) — arriving
        contexts re-prime through the normal warm-start hook."""
        self.network.set_node_down(node_id, False)
        if self.kv_ship is not None:
            # anti-entropy parity for shipped KV: drop inbox streams whose
            # replica ground truth diverged while the node was down — a
            # rejoining node never installs pages its replica can't vouch
            # for. Must run BEFORE the restart replay re-decides primes.
            self.kv_ship.reconcile(node_id)
        self.nodes[node_id].restart()
        self.store.anti_entropy(node_id)
        self.store.kick_outbox(node_id)
        if self.kv_ship is not None:
            # release parked sender streams and re-request orphaned inbox
            # streams — resume-from-watermark, only unconfirmed chunks
            # re-ship
            self.kv_ship.kick(node_id)
        # a rejoining node must re-announce itself to the fleet router —
        # its heartbeat chain died with it
        bus = getattr(self.router, "bus", None)
        if bus is not None:
            bus.kick()

    def converged(self) -> bool:
        """Do all *live* replicas of every keygroup hold identical
        (version, content) state? The post-churn acceptance check."""
        live = set(self.live_nodes())
        return all(
            self.store.replicas_converged(
                name, [n for n in self.store.keygroup(name).members if n in live]
            )
            for name in self.store.keygroup_names()
        )
