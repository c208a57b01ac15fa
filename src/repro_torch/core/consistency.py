"""The DisCEdge turn-counter consistency protocol (paper §3.1/§3.3).

The port's copy of ``repro.core.consistency``: the same names and behaviour,
on numpy and the standard library.

The KV store is eventually consistent. Strong per-session consistency comes
from a lightweight, client-driven protocol: the client maintains a monotone
turn counter; the Context Manager compares its replica's version against the
client's counter and, if stale, retries the local read with backoff —
effectively waiting for replication from the previous node to land.

Paper settings: retry count 3, 10 ms backoff each; the paper observes ≤2
retries ever needed. Both knobs are configurable here.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence

from ..store.distributed import DistributedKVStore
from ..store.kvstore import VersionedValue
from .protocol import ConsistencyPolicy, StaleContextError


@dataclass(frozen=True)
class RetryPolicy:
    max_retries: int = 3
    backoff_ms: float = 10.0


@dataclass
class ReadResult:
    value: Optional[VersionedValue]
    retries: int
    wait_ms: float
    stale: bool  # True only under AVAILABLE policy when still behind


def read_with_turn_check(
    store: DistributedKVStore,
    node: str,
    keygroup: str,
    key: str,
    required_turn: int,
    policy: ConsistencyPolicy = ConsistencyPolicy.STRONG,
    retry: RetryPolicy = RetryPolicy(),
) -> ReadResult:
    """Read `key` from `node`'s local replica, retrying until its version
    (the stored turn counter) reaches the client's `required_turn`.

    Each backoff advances the simulated clock and pumps the network event
    queue, so in-flight replication from the previous node can land — exactly
    the paper's 'retry the read, effectively waiting for replication'.
    """
    net = store.network
    def behind_turn(v) -> bool:
        # a missing value is only "behind" if the client has completed turns
        return (v.version if v is not None else 0) < required_turn

    vv = store.get(node, keygroup, key)
    retries = 0
    wait_ms = 0.0
    while behind_turn(vv) and retries < retry.max_retries:
        retries += 1
        wait_ms += retry.backoff_ms
        net.advance(retry.backoff_ms)  # backoff; pumps pending replication
        vv = store.get(node, keygroup, key)

    if behind_turn(vv) and required_turn > 0:
        if policy is ConsistencyPolicy.STRONG:
            raise StaleContextError(
                f"replica {node}/{keygroup}/{key} at turn "
                f"{getattr(vv, 'version', None)} < client turn {required_turn} "
                f"after {retries} retries"
            )
        return ReadResult(vv, retries, wait_ms, stale=True)
    return ReadResult(vv, retries, wait_ms, stale=False)


def read_with_turn_check_async(
    store: DistributedKVStore,
    node: str,
    keygroup: str,
    key: str,
    required_turn: int,
    on_ready: Callable[[ReadResult], None],
    policy: ConsistencyPolicy = ConsistencyPolicy.STRONG,
    retry: RetryPolicy = RetryPolicy(),
) -> None:
    """Event-driven twin of :func:`read_with_turn_check` for the submit/await
    serving path: instead of *advancing* the shared clock during backoff
    (which would fast-forward every other tenant's in-flight turn), each
    retry is a scheduled event ``backoff_ms`` in the future. Replication
    deliveries that arrive inside the backoff window are applied by the event
    loop in timestamp order before the retry fires — the same 'wait for
    replication to land' semantics, now overlapping with other tenants' work.

    ``on_ready`` fires with the :class:`ReadResult`; a STRONG-policy miss
    after the retry budget is reported as ``ReadResult(stale=True)`` with
    ``value`` possibly behind — the caller converts it to the protocol error
    (the split keeps this function exception-free inside event callbacks).
    """
    net = store.network

    def behind_turn(v) -> bool:
        return (v.version if v is not None else 0) < required_turn

    def attempt(retries: int, wait_ms: float) -> None:
        vv = store.get(node, keygroup, key)
        if behind_turn(vv) and retries < retry.max_retries:
            net.schedule(
                net.clock.now_ms + retry.backoff_ms,
                lambda: attempt(retries + 1, wait_ms + retry.backoff_ms),
            )
            return
        stale = behind_turn(vv) and required_turn > 0
        on_ready(ReadResult(vv, retries, wait_ms, stale=stale))

    attempt(0, 0.0)


# ---------------------------------------------------------------------------
# Guarantee checkers — used by property tests to validate the protocol.
# (Bermbach et al.'s client-centric guarantees, moved server-side per §3.3.)
# ---------------------------------------------------------------------------

def check_monotonic_reads(versions_read: Sequence[int]) -> bool:
    """A session must never observe a context version older than one it
    already observed."""
    return all(b >= a for a, b in zip(versions_read, versions_read[1:]))


def check_read_your_writes(
    writes: Sequence[int], reads_after_write: Sequence[int]
) -> bool:
    """Every read issued after the client's n-th turn must see version >= n."""
    return all(r >= w for w, r in zip(writes, reads_after_write))
