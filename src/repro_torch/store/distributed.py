"""FReD-like geo-distributed KV store (paper §2.2.1/§3.3).

The port's copy of ``repro.store.distributed``: the same names and behaviour,
on numpy and the standard library.

Implements the storage layer of a DisCEdge deployment — the component the
paper realizes with FReD keygroups (see docs/architecture.md, "Replication
and keygroups"):

- *Keygroups*: one per language model; context replicates only among nodes
  serving that model (paper §3.3).
- Peer-to-peer asynchronous replication over the network simulator; arrival
  times depend on value size → tokenized contexts genuinely sync faster than
  raw text (the paper's Fig. 5 effect).
- TTL per keygroup for automatic stale-context cleanup; explicit delete for
  the client-requested path (§3.3), propagated as *tombstones* so an
  in-flight stale put cannot resurrect a deleted context.
- Replication mode ``full`` ships the whole value on every write (what the
  paper's prototype does); ``delta`` is our beyond-paper optimization that
  ships only the token suffix since the peer's last known version
  (LLM context grows monotonically — §2.2.2).
- *Notify-on-apply*: a node can subscribe to replicated writes landing on
  its local replica (:meth:`DistributedKVStore.on_apply`). EdgeNode uses
  this as the migration warm-start hook — on context-replication arrival it
  pre-warms the serving engine's session KV pool so a roaming client's
  first turn on this node prefills only its new tokens
  (docs/architecture.md, "Migration warm-start").

Replication is *durable*, not fire-and-forget (docs/architecture.md,
"Failure model"): every write enters a per-peer outbox and stays there until
the peer acknowledges receipt. Two watermarks track each (keygroup, key,
src, dst) stream:

- ``_peer_sent`` — highest version optimistically shipped; sizes delta
  payloads so back-to-back writes pipeline without waiting a round trip.
- ``_peer_acked`` — highest version the peer has *confirmed*. Advanced only
  by an ack message (tag :data:`ACK_TAG`), never at send time.

When a send fails (peer down, link partitioned, message dropped — the
network reports all of these visibly), ``_peer_sent`` rolls back to
``_peer_acked`` and the item retries with capped exponential backoff; the
retried delta re-ships the whole unacknowledged gap, so a lost message can
never permanently diverge a delta-mode peer. A peer that is manually down
(crash with no known restart time) parks the item instead of polling;
:meth:`kick_outbox` on restart releases it. :meth:`anti_entropy` performs
rejoin catch-up by diffing actual replica versions (not watermarks — the
rejoining node may have lost its replica) and shipping only missed versions
and tombstones.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

from .kvstore import Replica, VersionedValue
from .network import Network

SizeFn = Callable[[Any], int]
DeltaSizeFn = Callable[[Any, int], int]

SYNC_TAG = "fred-peer-sync"  # the port the paper tcpdumps
ACK_TAG = "fred-peer-ack"    # delivery confirmations (not context payload)
ACK_BYTES = 24
DELETE_BYTES = 48


@dataclass
class Keygroup:
    name: str
    members: List[str]
    size_fn: SizeFn
    delta_size_fn: Optional[DeltaSizeFn] = None
    ttl_ms: Optional[float] = None


@dataclass
class OutboxPolicy:
    base_backoff_ms: float = 20.0
    max_backoff_ms: float = 2000.0

    def backoff_ms(self, attempt: int) -> float:
        return min(self.base_backoff_ms * (2 ** attempt), self.max_backoff_ms)


@dataclass
class OutboxItem:
    """Latest unconfirmed write for one (keygroup, key, src, dst) stream.
    Superseded in place by newer local writes — the outbox never ships a
    version older than the newest the peer is owed."""

    keygroup: str
    key: str
    src: str
    dst: str
    version: int
    value: Any
    deleted: bool = False
    attempt: int = 0
    inflight: int = 0
    parked: bool = False
    retry_token: int = 0
    retry_scheduled: bool = False


def _default_size(value: Any) -> int:
    if hasattr(value, "wire_bytes"):
        try:
            return int(value.wire_bytes())
        except TypeError:
            pass
    if isinstance(value, (bytes, bytearray)):
        return len(value)
    if isinstance(value, str):
        return len(value.encode("utf-8"))
    return 64


def _digest_value(value: Any) -> Any:
    """Stable, content-based key for convergence checks."""
    if value is None:
        return None
    if hasattr(value, "ids"):  # TokenizedContext
        return ("tok", getattr(value, "turn", 0), tuple(value.ids))
    if hasattr(value, "text"):  # RawContext
        return ("raw", getattr(value, "turn", 0), value.text)
    if isinstance(value, (str, bytes, int, float, tuple)):
        return value
    return repr(value)


class DistributedKVStore:
    """The storage layer of a DisCEdge deployment."""

    def __init__(
        self,
        network: Network,
        replication: str = "full",
        outbox_policy: Optional[OutboxPolicy] = None,
    ) -> None:
        assert replication in ("full", "delta")
        self.network = network
        self.replication = replication
        self.outbox_policy = outbox_policy or OutboxPolicy()
        self._keygroups: Dict[str, Keygroup] = {}
        self._replicas: Dict[Tuple[str, str], Replica] = {}
        # (keygroup, key, src, dst) -> last version confirmed by the peer
        self._peer_acked: Dict[Tuple[str, str, str, str], int] = {}
        # (keygroup, key, src, dst) -> last version optimistically shipped
        # (delta sizing base; rolled back to acked on failure)
        self._peer_sent: Dict[Tuple[str, str, str, str], int] = {}
        self._outbox: Dict[Tuple[str, str, str, str], OutboxItem] = {}
        # node -> hooks fired when a replicated write applies on that node's
        # replica (the EdgeNode warm-start subscription)
        self._apply_hooks: Dict[str, List[Callable[[str, str, VersionedValue], None]]] = {}
        self.replicated_writes = 0
        self.dropped_stale_applies = 0
        self.outbox_retries = 0
        self.failed_replications = 0
        self.delta_gaps = 0
        self.anti_entropy_ships = 0
        self.prime_failures = 0

    # -- keygroups ----------------------------------------------------------
    def create_keygroup(
        self,
        name: str,
        members: List[str],
        size_fn: Optional[SizeFn] = None,
        delta_size_fn: Optional[DeltaSizeFn] = None,
        ttl_ms: Optional[float] = None,
    ) -> Keygroup:
        kg = Keygroup(name, list(members), size_fn or _default_size, delta_size_fn, ttl_ms)
        self._keygroups[name] = kg
        for n in members:
            self._replicas[(n, name)] = Replica(n, name)
        return kg

    def keygroup(self, name: str) -> Keygroup:
        return self._keygroups[name]

    def keygroup_names(self) -> List[str]:
        return list(self._keygroups)

    def replica(self, node: str, keygroup: str) -> Replica:
        return self._replicas[(node, keygroup)]

    def has_replica(self, node: str, keygroup: str) -> bool:
        return (node, keygroup) in self._replicas

    def keygroups_of(self, node: str) -> List[Keygroup]:
        return [kg for kg in self._keygroups.values() if node in kg.members]

    # -- replication-arrival subscription ------------------------------------
    def on_apply(
        self, node: str, hook: Callable[[str, str, VersionedValue], None]
    ) -> None:
        """Subscribe ``hook(keygroup, key, value)`` to replicated writes that
        successfully apply on ``node``'s local replica. Fired *after* the
        last-writer-wins version check — stale deliveries never notify.
        Local writes by ``node`` itself do not notify either (the writing
        node already holds whatever state the hook would rebuild).

        This is where the ship-vs-recompute decision lives: EdgeNode's hook
        either token-recompute-primes the serving engine (the warm start)
        or asks the KV-ship layer (:mod:`repro_torch.store.kv_ship`) to pull the
        origin's KV pages, per the measured cost model."""
        self._apply_hooks.setdefault(node, []).append(hook)

    def _notify_apply(self, node: str, keygroup: str, key: str, vv: VersionedValue) -> None:
        # One hook raising must not poison the apply or the other hooks —
        # the replica update already happened; a warm-start failure is a
        # performance event, not a correctness one.
        for hook in self._apply_hooks.get(node, ()):
            try:
                hook(keygroup, key, vv)
            except Exception:
                self.prime_failures += 1

    # -- client-facing ops (called by the Context Manager, paper §3.3) -------
    def get(self, node: str, keygroup: str, key: str) -> Optional[VersionedValue]:
        return self.replica(node, keygroup).get(key, self.network.clock.now_ms)

    def put(
        self, node: str, keygroup: str, key: str, value: Any, version: int,
    ) -> Dict[str, float]:
        """Local write + async replication to keygroup peers through the
        outbox. Returns {peer: arrival_ms} for peers the payload could be
        shipped to immediately; unreachable peers are retried in the
        background and omitted from the dict. The local write is immediate
        (in-memory)."""
        kg = self._keygroups[keygroup]
        now = self.network.clock.now_ms
        self.replica(node, keygroup).put(
            key, value, version, now, ttl_ms=kg.ttl_ms, origin=node
        )
        # Capture a snapshot for delivery; the writer may keep mutating its
        # local object (the Context Manager appends turns in place).
        snapshot = value.copy() if hasattr(value, "copy") else value
        arrivals: Dict[str, float] = {}
        for peer in kg.members:
            if peer == node:
                continue
            item = self._supersede(keygroup, key, node, peer, version, snapshot, False)
            arrival = self._try_ship(item)
            if arrival is not None:
                arrivals[peer] = arrival
        return arrivals

    def delete(
        self, node: str, keygroup: str, key: str, version: Optional[int] = None
    ) -> None:
        """Client-requested context deletion (paper §3.3) — propagated as a
        tombstone through the outbox, so an in-flight stale put cannot
        resurrect the context on any replica. Pass the client's turn
        counter as ``version`` when available: it is the supremum of every
        write the session ever caused, so the tombstone dominates in-flight
        puts this node hasn't even seen yet."""
        kg = self._keygroups[keygroup]
        r = self.replica(node, keygroup)
        version = max(r.version_of(key), version or 0)
        r.delete(key, version=version)
        for peer in kg.members:
            if peer == node:
                continue
            item = self._supersede(keygroup, key, node, peer, version, None, True)
            self._try_ship(item)

    # -- outbox internals -----------------------------------------------------
    def _supersede(
        self, keygroup: str, key: str, src: str, dst: str,
        version: int, value: Any, deleted: bool,
    ) -> OutboxItem:
        """Create or update in place the outbox item for this stream. A
        newer local write replaces an unconfirmed older one — the peer only
        ever needs the newest version."""
        obk = (keygroup, key, src, dst)
        item = self._outbox.get(obk)
        if item is None:
            item = OutboxItem(keygroup, key, src, dst, version, value, deleted)
            self._outbox[obk] = item
        elif version >= item.version:
            item.version = version
            item.value = value
            item.deleted = deleted
        return item

    def _try_ship(self, item: OutboxItem) -> Optional[float]:
        """Ship now if the peer is reachable; otherwise schedule a retry (or
        park if the peer is manually down). Returns the arrival time of the
        shipped payload, or None if it could not be shipped."""
        if self.network.reachable(item.src, item.dst):
            return self._ship(item)
        self.failed_replications += 1
        self._schedule_retry(item)
        return None

    def _ship(self, item: OutboxItem) -> float:
        obk = (item.keygroup, item.key, item.src, item.dst)
        wm = (item.keygroup, item.key, item.src, item.dst)
        kg = self._keygroups[item.keygroup]
        base = self._peer_sent.get(wm, 0)
        if item.deleted:
            payload = DELETE_BYTES
        elif self.replication == "delta" and kg.delta_size_fn is not None:
            payload = kg.delta_size_fn(item.value, base)
        else:
            payload = kg.size_fn(item.value)
        self._peer_sent[wm] = max(base, item.version)
        item.inflight += 1
        item.parked = False
        item.retry_token += 1  # cancel any pending retry event
        item.retry_scheduled = False
        self.replicated_writes += 1

        now = self.network.clock.now_ms
        shipped_version = item.version
        shipped_deleted = item.deleted
        shipped = (
            None if item.deleted
            else VersionedValue(item.value, item.version, now, kg.ttl_ms, item.src)
        )
        src, dst, g, k = item.src, item.dst, item.keygroup, item.key

        def deliver() -> None:
            self._on_payload_delivered(
                g, k, src, dst, shipped_version, shipped, shipped_deleted, base
            )

        def failed(reason: str) -> None:
            self._on_send_failed(g, k, src, dst, reason)

        return self.network.send_async(
            src, dst, payload, SYNC_TAG, deliver, on_failure=failed
        )

    def _on_payload_delivered(
        self, keygroup: str, key: str, src: str, dst: str,
        version: int, shipped: Optional[VersionedValue], deleted: bool,
        delta_base: int,
    ) -> None:
        r = self.replica(dst, keygroup)
        confirmed = r.version_of(key)
        if (
            not deleted
            and self.replication == "delta"
            and delta_base > confirmed
        ):
            # The delta assumed tokens this replica never received (an
            # earlier message was lost and this one overtook the retry). A
            # real peer could not decode it — refuse and let the ack carry
            # the replica's actual version so the sender re-ships the gap.
            self.delta_gaps += 1
        elif deleted:
            r.delete(key, version=version)
            confirmed = r.version_of(key)
        else:
            if r.apply_replicated(key, shipped):
                self._notify_apply(dst, keygroup, key, shipped)
            else:
                self.dropped_stale_applies += 1
            # applied, stale, or tombstoned — either way the peer has now
            # *seen* this version; the stream is confirmed through it
            confirmed = max(r.version_of(key), version)

        def ack() -> None:
            self._on_ack(keygroup, key, src, dst, confirmed)

        def ack_lost(reason: str) -> None:
            self._on_send_failed(keygroup, key, src, dst, reason)

        self.network.send_async(dst, src, ACK_BYTES, ACK_TAG, ack, on_failure=ack_lost)

    def _on_ack(
        self, keygroup: str, key: str, src: str, dst: str, confirmed: int
    ) -> None:
        wm = (keygroup, key, src, dst)
        acked = max(self._peer_acked.get(wm, 0), confirmed)
        self._peer_acked[wm] = acked
        item = self._outbox.get(wm)
        if item is None:
            return
        item.inflight = max(0, item.inflight - 1)
        if acked >= item.version:
            # peer confirmed the newest version we owe it — stream is clean
            del self._outbox[wm]
            return
        # Partial confirmation: the item was superseded mid-flight, or the
        # peer reported a delta gap. Re-ship the newest version from the
        # confirmed base (once the remaining in-flight copies settle).
        if acked < self._peer_sent.get(wm, 0):
            self._peer_sent[wm] = acked
        if item.inflight == 0:
            self.outbox_retries += 1
            self._try_ship(item)

    def _on_send_failed(
        self, keygroup: str, key: str, src: str, dst: str, reason: str
    ) -> None:
        wm = (keygroup, key, src, dst)
        self.failed_replications += 1
        # Roll the optimistic watermark back so the retry re-ships the whole
        # unacknowledged gap — the fix for the schedule-time-ack divergence.
        self._peer_sent[wm] = self._peer_acked.get(wm, 0)
        item = self._outbox.get(wm)
        if item is None:
            return
        item.inflight = max(0, item.inflight - 1)
        if item.inflight == 0:
            self._schedule_retry(item)

    def _schedule_retry(self, item: OutboxItem) -> None:
        """Capped exponential backoff while the peer is unreachable. If the
        peer is manually down (crash — no restart time known), park instead
        of polling; :meth:`kick_outbox` releases parked items on restart."""
        if item.retry_scheduled:
            return
        reachable_at = self.network.next_reachable_at(item.src, item.dst)
        if reachable_at is None:
            item.parked = True
            return
        now = self.network.clock.now_ms
        at = max(now + self.outbox_policy.backoff_ms(item.attempt), reachable_at)
        item.attempt += 1
        item.retry_token += 1
        item.retry_scheduled = True
        token = item.retry_token
        obk = (item.keygroup, item.key, item.src, item.dst)

        def fire() -> None:
            live = self._outbox.get(obk)
            if live is not item or item.retry_token != token or item.inflight > 0:
                return  # confirmed, superseded-and-shipped, or re-scheduled
            item.retry_scheduled = False
            self.outbox_retries += 1
            self._try_ship(item)

        self.network.schedule(at, fire)

    def context_ids(
        self, node: str, keygroup: str, key: str
    ) -> Optional[List[int]]:
        """Token ids of ``node``'s *current* replica value for ``key``, or
        None if absent / not tokenized. The KV-ship layer uses this as the
        receiver-side ground truth: shipped page digests are verified
        against the replica's own tokens, never against anything that
        crossed the wire with the pages."""
        if not self.has_replica(node, keygroup):
            return None
        vv = self.get(node, keygroup, key)
        if vv is None or not hasattr(vv.value, "ids"):
            return None
        return list(vv.value.ids)

    # -- churn handling -------------------------------------------------------
    def kick_outbox(self, node: str) -> int:
        """Release parked/backing-off outbox items touching ``node`` (called
        on restart). Returns the number of items kicked."""
        kicked = 0
        for item in list(self._outbox.values()):
            if node not in (item.src, item.dst) or item.inflight > 0:
                continue
            item.parked = False
            item.retry_token += 1  # cancel any pending backoff event
            item.retry_scheduled = False
            kicked += 1
            self._try_ship(item)
        return kicked

    def drop_replica_data(self, node: str) -> int:
        """Crash with a non-durable replica: lose all of ``node``'s local
        KV data (anti-entropy on rejoin re-fetches from peers)."""
        n = 0
        for kg in self.keygroups_of(node):
            n += self.replica(node, kg.name).drop_data()
        return n

    def anti_entropy(self, node: str) -> int:
        """Rejoin catch-up: diff *actual* replica versions (not watermarks —
        ``node`` may have lost its replica) against every keygroup peer and
        enqueue only the versions each side missed, tombstones included.
        Watermarks for repaired streams reset to the receiver's real version
        so delta mode re-ships exactly the gap. Returns items enqueued."""
        shipped = 0
        for kg in self.keygroups_of(node):
            mine = self.replica(node, kg.name)
            for peer in kg.members:
                if peer == node:
                    continue
                theirs = self.replica(peer, kg.name)
                shipped += self._repair(kg, theirs, mine)   # peer -> node
                shipped += self._repair(kg, mine, theirs)   # node -> peer
        self.anti_entropy_ships += shipped
        return shipped

    def _repair(self, kg: Keygroup, src_r: Replica, dst_r: Replica) -> int:
        shipped = 0
        for key, vv in list(src_r.items()):
            if dst_r.version_of(key) >= vv.version:
                continue
            shipped += self._repair_one(
                kg, src_r.node, dst_r.node, key, vv.version, vv.value, False, dst_r
            )
        for key, ts in list(src_r.tombstones()):
            if dst_r.version_of(key) >= ts:
                continue
            shipped += self._repair_one(
                kg, src_r.node, dst_r.node, key, ts, None, True, dst_r
            )
        return shipped

    def _repair_one(
        self, kg: Keygroup, src: str, dst: str, key: str,
        version: int, value: Any, deleted: bool, dst_r: Replica,
    ) -> int:
        wm = (kg.name, key, src, dst)
        actual = dst_r.version_of(key)
        self._peer_acked[wm] = min(self._peer_acked.get(wm, 0), actual)
        self._peer_sent[wm] = self._peer_acked[wm]
        snapshot = value.copy() if hasattr(value, "copy") else value
        item = self._supersede(kg.name, key, src, dst, version, snapshot, deleted)
        if item.inflight == 0:
            self._try_ship(item)
        return 1

    # -- convergence ----------------------------------------------------------
    def replica_digest(self, node: str, keygroup: str) -> Dict[str, Any]:
        """Content digest of one replica: key -> (version, content). Two
        replicas with equal digests hold byte-identical context state."""
        r = self.replica(node, keygroup)
        return {k: (vv.version, _digest_value(vv.value)) for k, vv in r.items()}

    def replicas_converged(
        self, keygroup: str, nodes: Optional[Iterable[str]] = None
    ) -> bool:
        """True iff every given replica (default: all members) holds
        identical (version, content) state for the keygroup."""
        members = list(nodes) if nodes is not None else self._keygroups[keygroup].members
        if len(members) <= 1:
            return True
        first = self.replica_digest(members[0], keygroup)
        return all(self.replica_digest(n, keygroup) == first for n in members[1:])

    # -- observability ---------------------------------------------------------
    def outbox_size(self, node: Optional[str] = None) -> int:
        if node is None:
            return len(self._outbox)
        return sum(1 for i in self._outbox.values() if node in (i.src, i.dst))

    def sync_bytes(self) -> int:
        """Total inter-node synchronization traffic (paper Fig. 5)."""
        return self.network.bytes_for_tag(SYNC_TAG)

    def sync_messages(self) -> int:
        return self.network.messages_for_tag(SYNC_TAG)

    def ack_bytes(self) -> int:
        return self.network.bytes_for_tag(ACK_TAG)

    def ack_messages(self) -> int:
        return self.network.messages_for_tag(ACK_TAG)
