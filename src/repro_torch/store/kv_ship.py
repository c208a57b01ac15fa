"""KV-page shipping between edge nodes — digest-verified, crash-safe.

The port's copy of ``repro.store.kv_ship``: the same names and behaviour,
on numpy and the standard library.

Context replication (:mod:`repro_torch.store.distributed`) moves *tokens*
and re-prefills on arrival. For long sessions landing on weak edge nodes,
shipping the KV pages themselves beats recompute; for short ones it cannot —
so this module builds both and makes the choice a *measured cost model*
(compute-per-token vs link bytes-per-token, per node pair), decided at
replication-apply time in ``EdgeNode._on_replicated_context``.

Protocol (pull-based; the receiver drives):

1. **Decide** — a replicated tokenized context applies on the receiver's
   replica. :meth:`KVShipper.maybe_ship` compares the estimated recompute
   time (delta tokens x the receiver's measured ms/token) against the
   estimated ship time (control round trip + serialized chunk transfers at
   the link's *current* — possibly degraded — latency/bandwidth + partial
   tail-page recompute). Short histories recompute; long histories on slow
   compute ship; O(1) SSM/hybrid state (``NodeShipProfile.state_is_o1``)
   always ships.
2. **Request** — the receiver opens an :class:`_InboxStream` and sends a
   small control message to the origin carrying the stream id, the page
   range ``[have, want)`` it needs, and the chained page digest
   (:func:`page_digests`) at ``want`` computed from its OWN replica's token
   ids. Token ids never cross the wire in this protocol — the digest is the
   only commitment, and it binds the pages to the receiver's ground truth.
3. **Stream** — the sender exports its resident pages, verifies they match
   the requested digest (else NACK -> receiver falls back to token
   recompute), and ships them in page chunks (``chunk_pages`` per DATA
   message, stop-and-wait) so one multi-MB stream cannot monopolize a
   degraded link. Every chunk carries the per-page token digests plus a
   payload checksum.
4. **Apply** — the receiver verifies each chunk (checksum + digests against
   the expectation frozen at request time), buffers it durably, advances a
   contiguous watermark, and ACKs the watermark. A corrupted, reordered, or
   stale chunk is counted and *not* buffered — the unchanged ACK makes the
   sender retry with backoff; retries exhausting aborts the stream into the
   token-recompute fallback. When the watermark reaches the end, the
   receiver re-verifies its replica still holds the committed prefix and
   installs the pages through the node's service.
5. **Churn** — the inbox (buffered chunks + watermark) is durable like the
   KV replica: a receiver crash mid-stream resumes *from the watermark*
   after restart (same stream id, ``from_chunk`` in the re-request — no
   chunk is applied twice). Sender-side streams hold exported page bytes in
   process memory and die with a sender crash; the receiver re-requests on
   the sender's restart (``kick``). ``reconcile`` drops inbox streams whose
   replica ground truth diverged while the node was down.

Every failed ship ends in exactly one visible outcome: ``installed``,
``fallbacks`` (token recompute fired), or ``superseded`` — nothing fails
silently, and ``active_streams()`` returning 0 after a drained run is the
no-hung-streams invariant benches assert.
"""

from __future__ import annotations

import hashlib
import itertools
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .distributed import DistributedKVStore, OutboxPolicy
from .network import Network

KV_SHIP_DATA_TAG = "kv-ship-data"   # chunked page payloads
KV_SHIP_CTRL_TAG = "kv-ship-ctrl"   # request / nack / abort
KV_SHIP_ACK_TAG = "kv-ship-ack"     # chunk watermark confirmations

CTRL_BYTES = 96          # stream id, key hash, page range, digest, version
ACK_BYTES = 24
CHUNK_HEADER_BYTES = 64  # stream id, seq, page count, payload checksum
DIGEST_BYTES = 16        # one chained page digest per shipped page


def page_digests(
    token_ids: Sequence[int], page_size: int, limit: Optional[int] = None
) -> List[bytes]:
    """Chained content digests of the page-aligned full blocks of
    ``token_ids``: digest ``i`` commits to tokens ``[0, (i+1)*page_size)``,
    not just block ``i``, so two sequences share digest ``i`` iff their
    entire prefixes through page ``i`` are identical — exactly the
    condition under which their KV pages are interchangeable (KV depends on
    the full causal prefix and absolute positions, and the paged layout
    pins slot == position). Only *full* pages are digested; a partial tail
    page is never shareable. ``limit`` caps the number of digests.

    The one definition of the port's prefix-page digest (re-exported by
    ``repro_torch.serving.paged_kv``); it doubles as the KV-ship wire
    protocol's per-page integrity commitment, and lives here so the store
    and echo layers can verify streams without importing the serving
    stack. It hashes the same ``np.int64`` blocks as
    ``repro.store.kv_ship.page_digests``, so a JAX node and a torch node
    agree on every digest and can ship pages to each other."""
    n_full = len(token_ids) // page_size
    if limit is not None:
        n_full = min(n_full, max(0, limit))
    out: List[bytes] = []
    h = hashlib.blake2b(digest_size=16)
    for i in range(n_full):
        block = np.asarray(
            token_ids[i * page_size : (i + 1) * page_size], np.int64
        )
        h.update(block.tobytes())
        out.append(h.digest())
    return out


def _checksum(payloads: Sequence[bytes]) -> bytes:
    h = hashlib.blake2b(digest_size=16)
    for p in payloads:
        h.update(p)
    return h.digest()


@dataclass(frozen=True)
class NodeShipProfile:
    """One node's measured shipping constants: how big a page is on the
    wire and how fast the node prefills — the two sides of the cost model.
    ``state_is_o1`` marks O(1)-size recurrent state (SSM/hybrid snapshots):
    shipping is then a constant-size transfer vs O(tokens) recompute, so it
    always wins (ROADMAP, "Beyond dense full-width caches")."""

    page_size: int
    page_wire_bytes: int
    prefill_ms_per_token: float
    state_is_o1: bool = False


@dataclass
class PageShipment:
    """A sender-side export: the token ids whose KV the pages hold (ground
    truth for digest validation — they stay on the sender) and one payload
    per resident *full* page, index-aligned from page 0."""

    token_ids: List[int]
    payloads: List[bytes]


@dataclass
class ShipEstimate:
    """One cost-model evaluation for a (src, dst, history) triple."""

    src: str
    dst: str
    n_tokens: int
    have_pages: int
    want_pages: int
    delta_tokens: int      # tokens a recompute prime would prefill
    tail_tokens: int       # partial-tail tokens shipped streams still prefill
    wire_bytes: int        # total DATA payload + framing for the ship path
    recompute_ms: float
    ship_ms: float
    decision: str          # "ship" | "recompute"


@dataclass
class _SenderStream:
    """Sender side of one stream: exported chunks + the stop-and-wait
    pump's state. Mirrors the replication outbox's retry discipline
    (backoff, park on manually-down peers, token-cancelled retries)."""

    stream_id: int
    keygroup: str
    key: str
    src: str
    dst: str
    have: int
    want: int
    chunks: List[Dict]
    acked: int = 0          # contiguous chunks the receiver confirmed
    inflight: int = 0
    attempt: int = 0
    parked: bool = False
    retry_token: int = 0
    retry_scheduled: bool = False


@dataclass
class _InboxStream:
    """Receiver side: the durable apply queue for one stream. Survives a
    receiver crash like the KV replica does — buffered chunks and the
    watermark are what resume-from-watermark restores."""

    stream_id: int
    keygroup: str
    key: str
    src: str
    dst: str
    token_ids: List[int]
    have: int
    want: int
    page_size: int
    expected_digests: List[bytes]   # [0, want), frozen at request time
    chunk_pages: int
    n_chunks: int
    buffered: Dict[int, List[bytes]] = field(default_factory=dict)
    watermark: int = 0              # contiguous chunks verified + buffered
    req_pending: bool = False
    requested_at_ms: float = 0.0
    resumed: bool = False


class KVShipper:
    """Cluster-level KV-page shipping fabric (one instance per cluster,
    like :class:`~repro_torch.store.distributed.DistributedKVStore`). Nodes
    register duck-typed hooks; all cross-node traffic runs through the
    simulated network with its failure semantics (crash, partition, drop)."""

    def __init__(
        self,
        network: Network,
        store: DistributedKVStore,
        *,
        chunk_pages: int = 4,
        policy: Optional[OutboxPolicy] = None,
        max_stream_retries: int = 8,
        force: Optional[str] = None,
    ) -> None:
        assert chunk_pages > 0
        assert force in (None, "ship", "recompute"), force
        self.network = network
        self.store = store
        self.chunk_pages = chunk_pages
        self.policy = policy or OutboxPolicy()
        self.max_stream_retries = max_stream_retries
        # benches force one path per cell to *measure* both sides of the
        # crossover; None lets the cost model decide (production mode)
        self.force = force
        self._nodes: Dict[str, Dict[str, Callable]] = {}
        self._senders: Dict[int, _SenderStream] = {}
        self._inbox: Dict[int, _InboxStream] = {}
        self._inbox_by_key: Dict[Tuple[str, str, str], int] = {}
        # stream id -> (src, dst, n_chunks): ACK tombstones so a retried
        # chunk whose final ACK was lost still completes the sender side
        self._completed: Dict[int, Tuple[str, str, int]] = {}
        self._stream_seq = itertools.count(1)
        # deterministic in-flight payload corruption for tests: called at
        # chunk delivery with (stream_id, seq, payloads) -> payloads | None
        self._tamper: Optional[Callable] = None
        # decision + completion logs for the crossover bench
        self.decisions: List[ShipEstimate] = []
        self.completed_log: List[Dict] = []
        # counters — every requested stream resolves into exactly one of
        # installed / fallbacks / superseded (the resolution invariant)
        self.requested = 0
        self.resumed = 0
        self.coalesced = 0
        self.installed = 0
        self.installed_pages = 0
        self.fallbacks = 0
        self.rejected = 0
        self.superseded = 0
        self.nacks = 0
        self.aborted = 0
        self.decide_ship = 0
        self.decide_recompute = 0
        self.chunks_sent = 0
        self.chunk_retries = 0
        self.corrupt_chunks = 0
        self.stale_chunks = 0
        self.duplicate_chunks = 0
        self.install_failures = 0
        self.reconciled_dropped = 0

    # -- registration -------------------------------------------------------
    def register_node(
        self,
        node_id: str,
        keygroup: str,
        *,
        profile: Callable[[], Optional[NodeShipProfile]],
        exporter: Callable[[str], Optional[PageShipment]],
        installer: Callable[[str, List[int], List[bytes], int], bool],
        fallback: Callable[[str, List[int], str], None],
        coverage: Callable[[str, List[int]], int],
    ) -> None:
        """Register one node's shipping hooks. ``profile`` returns the
        node's measured constants (None: node can't ship right now);
        ``exporter(key)`` serializes resident full pages; ``installer(key,
        token_ids, payloads, have_pages)`` installs verified pages into the
        session pool (False: pool can't take them — caller falls back);
        ``fallback(key, token_ids, reason)`` runs the token-recompute
        prime; ``coverage(key, token_ids)`` reports already-resident full
        prefix pages so deltas ship only the gap."""
        self._nodes[node_id] = {
            "keygroup": keygroup,
            "profile": profile,
            "exporter": exporter,
            "installer": installer,
            "fallback": fallback,
            "coverage": coverage,
        }

    def registered(self, node_id: str) -> bool:
        return node_id in self._nodes

    # -- cost model ---------------------------------------------------------
    def estimate(
        self, src: str, dst: str, n_tokens: int, have_pages: int = 0
    ) -> Optional[ShipEstimate]:
        """Measured per-node-pair crossover: recompute cost is the
        receiver's ms/token over the delta it would prefill; ship cost is
        the control round trip plus the chunked stream *serialized* over
        the link at its current (possibly degraded) latency/bandwidth —
        stop-and-wait pays one data transfer + one ACK per chunk — plus the
        receiver prefilling the partial tail page. None when either end
        can't ship (unregistered, or profile unavailable)."""
        reg_s, reg_d = self._nodes.get(src), self._nodes.get(dst)
        if reg_s is None or reg_d is None:
            return None
        sp, dp = reg_s["profile"](), reg_d["profile"]()
        if sp is None or dp is None or sp.page_size != dp.page_size:
            return None
        ps = dp.page_size
        want = n_tokens // ps
        have = max(0, min(have_pages, want))
        delta_tokens = n_tokens - have * ps
        tail_tokens = n_tokens - want * ps
        pages = want - have
        recompute_ms = delta_tokens * dp.prefill_ms_per_token
        net = self.network
        ship_ms = net.transfer_ms(dst, src, CTRL_BYTES)
        wire_bytes = CTRL_BYTES
        for lo in range(0, pages, self.chunk_pages):
            n = min(self.chunk_pages, pages - lo)
            chunk_wire = (
                CHUNK_HEADER_BYTES + n * DIGEST_BYTES + n * sp.page_wire_bytes
            )
            ship_ms += net.transfer_ms(src, dst, chunk_wire)
            ship_ms += net.transfer_ms(dst, src, ACK_BYTES)
            wire_bytes += chunk_wire + ACK_BYTES
        ship_ms += tail_tokens * dp.prefill_ms_per_token
        if self.force is not None:
            decision = self.force if pages >= 1 else "recompute"
        elif pages < 1:
            decision = "recompute"
        elif sp.state_is_o1:
            decision = "ship"
        else:
            decision = "ship" if ship_ms < recompute_ms else "recompute"
        return ShipEstimate(
            src=src, dst=dst, n_tokens=n_tokens, have_pages=have,
            want_pages=want, delta_tokens=delta_tokens,
            tail_tokens=tail_tokens, wire_bytes=wire_bytes,
            recompute_ms=recompute_ms, ship_ms=ship_ms, decision=decision,
        )

    # -- receiver: decide + request -----------------------------------------
    def maybe_ship(
        self, keygroup: str, key: str, src: str, dst: str, token_ids: List[int]
    ) -> bool:
        """The replication-apply decision point. True: the shipper owns
        this prime — it will end in an install or a visible fallback, and
        the caller must NOT recompute now. False: recompute (cost model
        said so, or shipping isn't available for this pair)."""
        if src == dst or src not in self._nodes or dst not in self._nodes:
            return False
        est_probe = self.estimate(src, dst, len(token_ids), 0)
        if est_probe is None:
            return False
        ps = self._nodes[dst]["profile"]().page_size
        digs = page_digests(token_ids, ps)
        want = len(digs)

        # An active stream for this key: resume or coalesce rather than
        # double-ship. Chained digests make the check exact — the old
        # stream is still valid iff its expectation is a prefix of the new
        # context's digests.
        sid = self._inbox_by_key.get((dst, keygroup, key))
        if sid is not None:
            stream = self._inbox[sid]
            if (
                stream.want <= want
                and digs[: stream.want] == stream.expected_digests
            ):
                if sid in self._senders or stream.req_pending:
                    self.coalesced += 1  # already pumping; ride along
                else:
                    self._send_request(stream, resume=True)
                return True
            self.superseded += 1
            self._drop_stream(sid)
            # fall through to a fresh decision for the diverged context

        have = max(0, min(self._nodes[dst]["coverage"](key, token_ids), want))
        est = self.estimate(src, dst, len(token_ids), have)
        if est is None:
            return False
        self.decisions.append(est)
        if est.decision != "ship":
            self.decide_recompute += 1
            return False
        self.decide_ship += 1
        pages = want - have
        stream = _InboxStream(
            stream_id=next(self._stream_seq),
            keygroup=keygroup, key=key, src=src, dst=dst,
            token_ids=list(token_ids), have=have, want=want, page_size=ps,
            expected_digests=digs[:want], chunk_pages=self.chunk_pages,
            n_chunks=-(-pages // self.chunk_pages),
        )
        self._inbox[stream.stream_id] = stream
        self._inbox_by_key[(dst, keygroup, key)] = stream.stream_id
        self.requested += 1
        self._send_request(stream, resume=False)
        return True

    def _send_request(self, stream: _InboxStream, resume: bool) -> None:
        if stream.req_pending:
            return
        stream.req_pending = True
        stream.requested_at_ms = self.network.clock.now_ms
        if resume:
            stream.resumed = True
            self.resumed += 1
        sid = stream.stream_id

        def deliver() -> None:
            self._on_request(sid)

        def failed(reason: str) -> None:
            st = self._inbox.get(sid)
            if st is not None:
                st.req_pending = False
            self._fallback_stream(sid, f"request-failed: {reason}")

        self.network.send_async(
            stream.dst, stream.src, CTRL_BYTES, KV_SHIP_CTRL_TAG,
            deliver, on_failure=failed,
        )

    # -- sender: validate + chunk + pump ------------------------------------
    def _on_request(self, stream_id: int) -> None:
        stream = self._inbox.get(stream_id)
        if stream is None:
            return  # stream was dropped while the request was in flight
        src, dst = stream.src, stream.dst
        reg = self._nodes.get(src)
        if reg is None:
            self._nack(stream_id, "sender-unregistered")
            return
        shipment = reg["exporter"](stream.key)
        if shipment is None or len(shipment.payloads) < stream.want:
            self._nack(stream_id, "not-resident")
            return
        digs = page_digests(shipment.token_ids, stream.page_size, stream.want)
        # One chained digest proves the whole prefix: the sender's pages
        # match the receiver's ground truth iff digest[want-1] matches.
        if len(digs) < stream.want or digs[-1] != stream.expected_digests[-1]:
            self._nack(stream_id, "stale")
            return
        chunks: List[Dict] = []
        for seq, lo in enumerate(
            range(stream.have, stream.want, stream.chunk_pages)
        ):
            hi = min(stream.want, lo + stream.chunk_pages)
            payloads = [bytes(p) for p in shipment.payloads[lo:hi]]
            chunks.append({
                "seq": seq,
                "payloads": payloads,
                "digests": digs[lo:hi],
                "checksum": _checksum(payloads),
                "wire_bytes": (
                    CHUNK_HEADER_BYTES
                    + (hi - lo) * DIGEST_BYTES
                    + sum(len(p) for p in payloads)
                ),
            })
        sender = _SenderStream(
            stream_id=stream_id, keygroup=stream.keygroup, key=stream.key,
            src=src, dst=dst, have=stream.have, want=stream.want,
            chunks=chunks, acked=min(stream.watermark, len(chunks)),
        )
        self._senders[stream_id] = sender
        self._pump(sender)

    def _pump(self, stream: _SenderStream) -> None:
        """Ship the next unacknowledged chunk (stop-and-wait: one DATA
        message in flight per stream, so a multi-MB page stream interleaves
        with other traffic on a degraded link instead of monopolizing
        it)."""
        if stream.acked >= len(stream.chunks):
            # nothing left to ship — a resumed stream whose receiver already
            # holds every chunk finalizes straight away
            self._senders.pop(stream.stream_id, None)
            inbox = self._inbox.get(stream.stream_id)
            if inbox is not None and inbox.watermark >= inbox.n_chunks:
                self._finalize(inbox)
            return
        if stream.inflight > 0:
            return
        if not self.network.reachable(stream.src, stream.dst):
            self._schedule_retry(stream)
            return
        chunk = stream.chunks[stream.acked]
        stream.inflight += 1
        stream.parked = False
        stream.retry_token += 1  # cancel any pending retry event
        stream.retry_scheduled = False
        self.chunks_sent += 1
        sid, seq = stream.stream_id, chunk["seq"]
        payloads, digests = chunk["payloads"], chunk["digests"]
        checksum = chunk["checksum"]

        def deliver() -> None:
            self._on_chunk(sid, seq, payloads, digests, checksum)

        def failed(reason: str) -> None:
            self._on_chunk_failed(sid, reason)

        self.network.send_async(
            stream.src, stream.dst, chunk["wire_bytes"], KV_SHIP_DATA_TAG,
            deliver, on_failure=failed,
        )

    # -- receiver: verify + buffer + ack ------------------------------------
    def _on_chunk(
        self,
        stream_id: int,
        seq: int,
        payloads: List[bytes],
        digests: List[bytes],
        checksum: bytes,
    ) -> None:
        if self._tamper is not None:
            tampered = self._tamper(stream_id, seq, list(payloads))
            if tampered is not None:
                payloads = tampered
        stream = self._inbox.get(stream_id)
        if stream is None:
            self.stale_chunks += 1
            done = self._completed.get(stream_id)
            if done is not None:
                # the install already happened; re-ACK the full watermark so
                # a sender retrying a lost final ACK can complete
                src, dst, n_chunks = done
                self._send_ack(src, dst, stream_id, n_chunks)
            return
        stream.req_pending = False
        lo = stream.have + seq * stream.chunk_pages
        hi = min(stream.want, lo + stream.chunk_pages)
        ok = (
            0 <= seq < stream.n_chunks
            and _checksum(payloads) == checksum
            and list(digests) == stream.expected_digests[lo:hi]
            and len(payloads) == hi - lo
        )
        if not ok:
            self.corrupt_chunks += 1
        elif seq in stream.buffered or seq < stream.watermark:
            self.duplicate_chunks += 1  # verified duplicate: already held
        else:
            stream.buffered[seq] = payloads
            while stream.watermark in stream.buffered:
                stream.watermark += 1
        wm = stream.watermark
        if wm >= stream.n_chunks:
            self._finalize(stream)
        self._send_ack(stream.src, stream.dst, stream_id, wm)

    def _send_ack(self, src: str, dst: str, stream_id: int, wm: int) -> None:
        def deliver() -> None:
            self._on_ack(stream_id, wm)

        def lost(reason: str) -> None:
            # models the sender's retransmit timeout, like the replication
            # outbox's ack-loss path: the chunk is treated as failed and the
            # whole unacknowledged gap re-ships
            self._on_chunk_failed(stream_id, reason)

        self.network.send_async(
            dst, src, ACK_BYTES, KV_SHIP_ACK_TAG, deliver, on_failure=lost
        )

    # -- sender: ack / failure / retry --------------------------------------
    def _on_ack(self, stream_id: int, wm: int) -> None:
        stream = self._senders.get(stream_id)
        if stream is None:
            return
        stream.inflight = max(0, stream.inflight - 1)
        progressed = wm > stream.acked
        if progressed:
            stream.acked = wm
            stream.attempt = 0  # forward progress resets the backoff
        if stream.acked >= len(stream.chunks):
            del self._senders[stream_id]
            return
        if stream.inflight > 0:
            return
        if progressed:
            self._pump(stream)
            return
        # no progress: the receiver saw the chunk but refused it (corrupt /
        # out of expectation) — retry with backoff, give up visibly
        stream.attempt += 1
        if stream.attempt > self.max_stream_retries:
            self._abort(stream_id, "retries-exhausted")
            return
        self.chunk_retries += 1
        self._schedule_retry(stream)

    def _on_chunk_failed(self, stream_id: int, reason: str) -> None:
        stream = self._senders.get(stream_id)
        if stream is None:
            return
        stream.inflight = max(0, stream.inflight - 1)
        if stream.inflight > 0:
            return
        stream.attempt += 1
        if stream.attempt > self.max_stream_retries:
            self._abort(stream_id, f"retries-exhausted: {reason}")
            return
        self.chunk_retries += 1
        self._schedule_retry(stream)

    def _schedule_retry(self, stream: _SenderStream) -> None:
        """Capped exponential backoff while the peer is unreachable; park
        (don't poll) when an endpoint is manually down — ``kick`` on
        restart releases the stream, mirroring the replication outbox."""
        if stream.retry_scheduled:
            return
        reachable_at = self.network.next_reachable_at(stream.src, stream.dst)
        if reachable_at is None:
            stream.parked = True
            return
        now = self.network.clock.now_ms
        at = max(now + self.policy.backoff_ms(stream.attempt), reachable_at)
        stream.retry_token += 1
        stream.retry_scheduled = True
        token = stream.retry_token

        def fire() -> None:
            live = self._senders.get(stream.stream_id)
            if (
                live is not stream
                or stream.retry_token != token
                or stream.inflight > 0
            ):
                return
            stream.retry_scheduled = False
            self._pump(stream)

        self.network.schedule(at, fire)

    # -- control-plane outcomes ---------------------------------------------
    def _nack(self, stream_id: int, reason: str) -> None:
        self.nacks += 1
        stream = self._inbox.get(stream_id)
        if stream is None:
            return

        def deliver() -> None:
            self._fallback_stream(stream_id, f"nack: {reason}")

        def lost(_r: str) -> None:
            # the receiver's request timeout fires the same outcome — a
            # stream the sender refused can never install
            self._fallback_stream(stream_id, f"nack: {reason}")

        self.network.send_async(
            stream.src, stream.dst, CTRL_BYTES, KV_SHIP_CTRL_TAG,
            deliver, on_failure=lost,
        )

    def _abort(self, stream_id: int, reason: str) -> None:
        self.aborted += 1
        self._senders.pop(stream_id, None)
        if stream_id in self._inbox:
            self._fallback_stream(stream_id, f"abort: {reason}")

    def _fallback_stream(self, stream_id: int, reason: str) -> None:
        """Resolve a stream into the token-recompute prime. The
        degradation is graceful *and* visible: counters + the node hook."""
        stream = self._inbox.pop(stream_id, None)
        if stream is None:
            return
        self._inbox_by_key.pop((stream.dst, stream.keygroup, stream.key), None)
        self._senders.pop(stream_id, None)
        self.fallbacks += 1
        reg = self._nodes.get(stream.dst)
        if reg is not None:
            reg["fallback"](stream.key, stream.token_ids, reason)

    def _drop_stream(self, stream_id: int) -> None:
        stream = self._inbox.pop(stream_id, None)
        if stream is not None:
            self._inbox_by_key.pop(
                (stream.dst, stream.keygroup, stream.key), None
            )
        self._senders.pop(stream_id, None)

    # -- receiver: durable apply --------------------------------------------
    def _finalize(self, stream: _InboxStream) -> None:
        """All chunks verified and buffered: re-check the replica ground
        truth *at apply time* (the context may have been superseded or
        deleted while the stream ran), then install through the node's
        service. Any mismatch degrades to token recompute — a corrupt or
        stale page stream is never installed."""
        sid = stream.stream_id
        current = self.store.context_ids(stream.dst, stream.keygroup, stream.key)
        fresh = (
            current is not None
            and len(current) >= stream.want * stream.page_size
            and page_digests(current, stream.page_size, stream.want)[-1:]
            == stream.expected_digests[-1:]
        ) if stream.want > 0 else current is not None
        if not fresh:
            self.rejected += 1
            self._fallback_stream(sid, "stale-at-apply")
            return
        payloads: List[bytes] = []
        for seq in range(stream.n_chunks):
            payloads.extend(stream.buffered[seq])
        reg = self._nodes.get(stream.dst)
        ok = False
        if reg is not None:
            try:
                ok = bool(reg["installer"](
                    stream.key, stream.token_ids, payloads, stream.have
                ))
            except Exception:
                ok = False
        if not ok:
            self.install_failures += 1
            self._fallback_stream(sid, "install-failed")
            return
        now = self.network.clock.now_ms
        self.installed += 1
        self.installed_pages += stream.want - stream.have
        self._completed[sid] = (stream.src, stream.dst, stream.n_chunks)
        self.completed_log.append({
            "key": stream.key, "src": stream.src, "dst": stream.dst,
            "pages": stream.want - stream.have, "n_chunks": stream.n_chunks,
            "requested_at_ms": stream.requested_at_ms,
            "installed_at_ms": now,
            "ship_ms": now - stream.requested_at_ms,
            "resumed": stream.resumed,
        })
        self._inbox.pop(sid, None)
        self._inbox_by_key.pop((stream.dst, stream.keygroup, stream.key), None)
        # the sender stream is closed by the final watermark ACK

    # -- churn --------------------------------------------------------------
    def crash(self, node: str) -> int:
        """Process crash on ``node``: sender-side streams hold exported
        page bytes in the crashed process's memory — drop them (the
        receiver re-requests on restart). Inbox streams are durable and
        survive, like the KV replica. Returns sender streams dropped."""
        dropped = 0
        for sid, s in list(self._senders.items()):
            if s.src == node:
                del self._senders[sid]
                dropped += 1
        return dropped

    def reconcile(self, node: str) -> int:
        """Restart-time anti-entropy parity: drop inbox streams on
        ``node`` whose replica ground truth no longer matches the stream's
        digest commitment (replica lost or superseded while down) — a
        rejoining node must never install pages its own replica can't
        vouch for. The restart replay then re-decides fresh. Returns
        streams dropped."""
        dropped = 0
        for sid, stream in list(self._inbox.items()):
            if stream.dst != node:
                continue
            current = self.store.context_ids(node, stream.keygroup, stream.key)
            fresh = (
                current is not None
                and len(current) >= stream.want * stream.page_size
                and page_digests(current, stream.page_size, stream.want)[-1:]
                == stream.expected_digests[-1:]
            )
            if not fresh:
                self._drop_stream(sid)
                self.reconciled_dropped += 1
                dropped += 1
        return dropped

    def kick(self, node: str) -> int:
        """Restart release: un-park sender streams touching ``node`` and
        re-request inbox streams whose sender side died with a crash —
        resume-from-watermark, so only unconfirmed chunks re-ship.
        Returns streams kicked."""
        kicked = 0
        for stream in list(self._senders.values()):
            if node not in (stream.src, stream.dst) or stream.inflight > 0:
                continue
            stream.parked = False
            stream.retry_token += 1
            stream.retry_scheduled = False
            kicked += 1
            self._pump(stream)
        for stream in list(self._inbox.values()):
            if node not in (stream.src, stream.dst):
                continue
            if stream.stream_id in self._senders or stream.req_pending:
                continue
            kicked += 1
            self._send_request(stream, resume=True)
        return kicked

    # -- observability -------------------------------------------------------
    def active_streams(self) -> int:
        """Unresolved streams. 0 after a drained run with all nodes up is
        the no-hung-streams invariant."""
        return len(self._inbox)

    def data_bytes(self) -> int:
        return self.network.bytes_for_tag(KV_SHIP_DATA_TAG)

    def data_messages(self) -> int:
        return self.network.messages_for_tag(KV_SHIP_DATA_TAG)

    def ctrl_bytes(self) -> int:
        return self.network.bytes_for_tag(KV_SHIP_CTRL_TAG) + \
            self.network.bytes_for_tag(KV_SHIP_ACK_TAG)

    def stats(self) -> Dict[str, int]:
        return {
            "requested": self.requested,
            "resumed": self.resumed,
            "coalesced": self.coalesced,
            "installed": self.installed,
            "installed_pages": self.installed_pages,
            "fallbacks": self.fallbacks,
            "rejected": self.rejected,
            "superseded": self.superseded,
            "nacks": self.nacks,
            "aborted": self.aborted,
            "decide_ship": self.decide_ship,
            "decide_recompute": self.decide_recompute,
            "chunks_sent": self.chunks_sent,
            "chunk_retries": self.chunk_retries,
            "corrupt_chunks": self.corrupt_chunks,
            "stale_chunks": self.stale_chunks,
            "duplicate_chunks": self.duplicate_chunks,
            "install_failures": self.install_failures,
            "reconciled_dropped": self.reconciled_dropped,
            "active_streams": self.active_streams(),
            "data_bytes": self.data_bytes(),
            "data_messages": self.data_messages(),
        }
