"""Single-replica in-memory versioned KV store.

The port's copy of ``repro.store.kvstore``: the same names and behaviour,
on numpy and the standard library.

Models one FReD node's local replica (paper §3.3 / §4.1): in-memory reads and
writes, per-key version stamps (the session turn counter), TTL-based expiry,
and last-writer-wins on version for replicated applies. Asynchronous disk
persistence exists in FReD but the paper evaluates memory-only — so do we.

Deletes leave a *tombstone* (key -> version at deletion time) so a stale
replicated put that was in flight when the client deleted its context cannot
resurrect it (paper §3.3 privacy path; docs/architecture.md, "Failure
model"). A genuinely newer write — the session continuing past the deleted
turn — clears the tombstone.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Iterator, Optional, Tuple


@dataclass
class VersionedValue:
    value: Any
    version: int            # DisCEdge: the session turn counter
    written_at_ms: float
    ttl_ms: Optional[float] = None
    origin: str = ""        # node that produced this version

    def expired(self, now_ms: float) -> bool:
        return self.ttl_ms is not None and now_ms - self.written_at_ms > self.ttl_ms


class Replica:
    """One node's local replica of one keygroup."""

    def __init__(self, node: str, keygroup: str) -> None:
        self.node = node
        self.keygroup = keygroup
        self._data: Dict[str, VersionedValue] = {}
        self._tombstones: Dict[str, int] = {}  # key -> version deleted at
        self.reads = 0
        self.writes = 0
        self.stale_reads = 0
        self.tombstone_rejections = 0

    def get(self, key: str, now_ms: float) -> Optional[VersionedValue]:
        self.reads += 1
        vv = self._data.get(key)
        if vv is None:
            return None
        if vv.expired(now_ms):
            del self._data[key]
            return None
        return vv

    def put(
        self, key: str, value: Any, version: int, now_ms: float,
        ttl_ms: Optional[float] = None, origin: str = "",
    ) -> VersionedValue:
        self.writes += 1
        vv = VersionedValue(value, version, now_ms, ttl_ms, origin or self.node)
        self._data[key] = vv
        # a fresh local write supersedes any prior delete of this key
        self._tombstones.pop(key, None)
        return vv

    def apply_replicated(self, key: str, vv: VersionedValue) -> bool:
        """Apply a peer's write. Last-writer-wins on version — the turn counter
        is monotone per session, so a lower version is always stale. Writes at
        or below a tombstone's version are the paper's privacy hazard (a
        stale in-flight put arriving after the client deleted the context)
        and are rejected; a strictly newer write clears the tombstone."""
        ts = self._tombstones.get(key)
        if ts is not None:
            if vv.version <= ts:
                self.tombstone_rejections += 1
                return False
            del self._tombstones[key]
        cur = self._data.get(key)
        if cur is not None and cur.version >= vv.version:
            self.stale_reads += 1
            return False
        self._data[key] = vv
        return True

    def delete(self, key: str, version: Optional[int] = None) -> bool:
        """Remove ``key`` and leave a tombstone at ``version`` (defaults to
        the deleted value's version, 0 if the key was absent)."""
        vv = self._data.pop(key, None)
        at = version if version is not None else (vv.version if vv else 0)
        self._tombstones[key] = max(self._tombstones.get(key, 0), at)
        return vv is not None

    def tombstone_version(self, key: str) -> Optional[int]:
        return self._tombstones.get(key)

    def version_of(self, key: str) -> int:
        """Highest version this replica has seen for ``key`` — live value or
        tombstone, whichever is newer; 0 if never seen. Anti-entropy uses
        this to decide which versions a rejoining peer missed."""
        vv = self._data.get(key)
        live = vv.version if vv is not None else 0
        return max(live, self._tombstones.get(key, 0))

    def drop_data(self) -> int:
        """Lose all volatile state (crash with non-durable replica). Returns
        the number of entries dropped."""
        n = len(self._data) + len(self._tombstones)
        self._data.clear()
        self._tombstones.clear()
        return n

    def sweep_expired(self, now_ms: float) -> int:
        dead = [k for k, v in self._data.items() if v.expired(now_ms)]
        for k in dead:
            del self._data[k]
        return len(dead)

    def items(self) -> Iterator[Tuple[str, VersionedValue]]:
        return iter(self._data.items())

    def tombstones(self) -> Iterator[Tuple[str, int]]:
        return iter(self._tombstones.items())

    def __contains__(self, key: str) -> bool:
        return key in self._data

    def __len__(self) -> int:
        return len(self._data)
