"""Session-scoped KV-cache pool (beyond-paper: §4.1 one level down) — the
port's copy of ``repro.serving.session_cache`` (framework-free). The port
serves only the paged route, so with an allocator bound its entries are
always paged: a dense entry put into a paged pool (the JAX package's
dense-route store/materialize) raises NotImplementedError until the dense
route is ported (ROADMAP, Queue 1 item 6).

DisCEdge stores session context *pre-tokenized* so the request path never
re-tokenizes history; this pool extends the same idea to the KV state: the
decode caches produced while serving a turn are kept, keyed by the session's
context key, so the next turn only prefills its *new* tokens
(:func:`repro.models.prefill_append`) instead of re-running the full prefill
over the stored history — per-turn prefill cost drops from O(history) to
O(new tokens).

The pool is a capacity-bounded LRU. Correctness never depends on a hit: an
entry is only reused when its stored token prefix exactly matches the head
of the incoming ``context_ids + prompt_ids`` (longest-common-prefix check);
any mismatch — stale replica, edited history, truncated context — drops the
entry and falls back to a from-scratch prefill.

Entries carry their provenance (``source``): ``"serve"`` for caches left
behind by a turn served on this node, ``"prime"`` for caches installed by
the migration warm-start hook (:meth:`repro.serving.engine.InferenceEngine.
prime` — the replication-arrival path that pre-warms a keygroup peer before
a roaming client's first turn lands there). A prime that *extends* an
existing entry keeps that entry's provenance and LRU position: warm-start
must never demote or relabel the node's own hot serve entries. See
docs/architecture.md, "Migration warm-start", for the full request
lifecycle.

With an attached :class:`~repro_torch.serving.paged_kv.PagedKVAllocator`
(``allocator``), entries are stored *paged*: ``put`` adopts a paged
entry's pages zero-copy (the engine's write-back), eviction is
page-budgeted rather than entry-counted (``reclaim``), and an entry costs
``ceil(tokens / page_size)`` pages instead of a full ``max_len``-width
lane — the many-tenant memory win (docs/architecture.md, "Paged session
KV").
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Dict, List, Optional, Sequence, Tuple

if TYPE_CHECKING:  # circular-import guard: paged_kv never imports us back
    from .paged_kv import PagedKVAllocator


def longest_common_prefix(a: Sequence[int], b: Sequence[int]) -> int:
    n = min(len(a), len(b))
    for i in range(n):
        if a[i] != b[i]:
            return i
    return n


# Entry provenance -> Timing.kv_warm_source label: how a warm start happened.
# "serve" entries are the node's own hot sessions — reusing them is a plain
# cache hit, not a warm start.
WARM_SOURCES = {"prime": "tokens", "ship": "pages"}


def warm_source_of(source: str) -> str:
    """Map a cache entry's provenance to the warm-start provenance label
    reported in :class:`repro.core.protocol.Timing` ("tokens" | "pages" |
    "none")."""
    return WARM_SOURCES.get(source, "none")


@dataclass
class CacheEntry:
    """KV state for the token prefix ``token_ids``. Exactly one of two
    storage forms is live: ``caches`` — the dense models-layer cache pytree
    with kv_pos trimmed to ``pos`` — or ``pages`` — a list of physical page
    ids in the owning pool's allocator (paged mode; the entry owns one ref
    per page). ``source`` records how the entry got here: ``"serve"`` (left
    behind by a turn served on this node), ``"prime"`` (installed by the
    migration warm-start hook via token recompute on context-replication
    arrival), or ``"ship"`` (installed from digest-verified KV pages shipped
    by the origin node — docs/architecture.md, "KV page shipping")."""

    token_ids: List[int]
    caches: Optional[List[Dict]] = None
    source: str = "serve"
    pages: Optional[List[int]] = None

    @property
    def pos(self) -> int:
        """Slots [0, pos) of the stored KV hold exactly `token_ids`."""
        return len(self.token_ids)

    @property
    def paged(self) -> bool:
        return self.pages is not None


@dataclass
class SessionCachePool:
    """LRU pool of per-session decode caches, keyed by context key."""

    capacity: int = 4
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    invalidations: int = 0
    primes: int = 0  # warm-start installs/extensions via InferenceEngine.prime
    rejects: int = 0  # paged inserts dropped for lack of page budget
    # cross-session shared-prefix accounting: admissions that reused another
    # session's resident pages via the content-hash index (bumped by the
    # engine's admission), and the tokens they did not have to re-prefill
    shared_hits: int = 0
    shared_tokens: int = 0
    allocator: Optional["PagedKVAllocator"] = None
    _entries: "OrderedDict[str, CacheEntry]" = field(
        default_factory=OrderedDict, repr=False
    )

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: str) -> bool:
        return key in self._entries

    def match(self, key: str, token_ids: Sequence[int]) -> Tuple[Optional[CacheEntry], int]:
        """Look up ``key`` and prefix-match ``token_ids`` against the cached
        prefix. Returns ``(entry, usable)`` where ``usable`` is the number of
        leading tokens whose KV can be reused (0 => full prefill).

        At least one token is always left to (re)compute so the caller gets
        last-position logits. A *divergent* prefix (stale/edited history)
        invalidates the entry; incoming ids that are a strict prefix of the
        cached tokens (client retry/resend) still reuse — the caller must
        trim kv_pos to ``usable`` whenever ``usable < entry.pos`` (the paged
        engine starts its kv_pos at ``usable`` and copies a partial tail
        page)."""
        entry = self._entries.get(key)
        if entry is None:
            self.misses += 1
            return None, 0
        n = len(token_ids)
        lcp = longest_common_prefix(entry.token_ids, token_ids)
        if lcp < entry.pos and lcp < n:
            # genuine divergence: the cache beyond lcp is for wrong tokens
            self.invalidations += 1
            self.misses += 1
            self._release(entry)
            del self._entries[key]
            return None, 0
        usable = min(entry.pos, n - 1)
        if usable <= 0:
            self.misses += 1
            return None, 0
        self._entries.move_to_end(key)
        self.hits += 1
        return entry, usable

    def put(self, key: str, entry: CacheEntry, low_priority: bool = False) -> None:
        """Insert/replace an entry. With an ``allocator``, a paged entry —
        the engine's finished write-back — is adopted zero-copy: the pool
        takes over its page refs.

        ``low_priority`` (the warm-start prime path) is best-effort storage:
        a *fresh* insert goes to the LRU end instead of the MRU end, and in
        paged mode it never reclaims pages from other entries — a prime for
        a session that *might* roam here must never evict or displace this
        node's hot serve entries; on a full pool the prime is the next
        victim (or is dropped outright when no pages are free). Updating a
        key that already exists keeps its current LRU position: extending a
        hot entry off the hot path must not demote it to eviction victim.
        The first serving hit promotes a kept prime to MRU like any other
        entry."""
        if self.capacity <= 0:
            self._release(entry)  # adopted page refs must not leak
            return
        if self.allocator is not None and not entry.paged:
            raise NotImplementedError(
                "storing a dense cache entry into a paged pool is the dense "
                "route (ROADMAP, Queue 1 item 6), not ported yet"
            )
        if self.allocator is not None:
            # adopted write-back pages are at rest now — index their full
            # pages so later admissions of the same prefix can share them
            # (no-op for pages that came from the index in the first place)
            self.allocator.register_pages(entry.token_ids, entry.pages)
        old = self._entries.get(key)
        existed = old is not None
        self._entries[key] = entry
        if existed and old is not entry:
            self._release(old)
        if not existed:
            self._entries.move_to_end(key, last=not low_priority)
        elif not low_priority:
            self._entries.move_to_end(key)
        while len(self._entries) > self.capacity:
            _, victim = self._entries.popitem(last=False)
            self._release(victim)
            self.evictions += 1

    def resident_keys(self) -> Dict[str, int]:
        """Cache key -> resident token count, for fleet telemetry
        (docs/architecture.md, "Fleet layer"): the node's heartbeat
        publishes this map so the router can score keygroup members by KV
        residency. Read-only — no LRU or counter side effects."""
        return {k: e.pos for k, e in self._entries.items()}

    def peek(self, key: str) -> Optional[CacheEntry]:
        """Return the entry for ``key`` without touching LRU order or the
        hit/miss counters — the warm-start prime path uses this to decide
        between a fresh prefill and a delta extension of what is already
        cached, without polluting serving-path statistics."""
        return self._entries.get(key)

    def invalidate(self, key: str) -> None:
        entry = self._entries.pop(key, None)
        if entry is not None:
            self._release(entry)

    def clear(self) -> None:
        for entry in self._entries.values():
            self._release(entry)
        self._entries.clear()

    # -- paged storage --------------------------------------------------
    def _release(self, entry: CacheEntry) -> None:
        """Drop the pool's ownership of an entry's storage (paged entries:
        one page ref each; shared pages survive while a slot still holds
        them)."""
        if entry.paged and self.allocator is not None:
            self.allocator.decref(entry.pages)
            entry.pages = None

    def reclaim(self, n_pages: int, exclude: Optional[str] = None) -> bool:
        """Page-budgeted eviction: pop LRU entries (never ``exclude``) until
        the allocator has ``n_pages`` free or nothing evictable remains.
        Freed counts may lag when a live slot still shares an evicted
        entry's pages — those pages return to the free list when the slot
        releases them."""
        if self.allocator is None:
            return True
        while self.allocator.n_free < n_pages:
            victim_key = next(
                (k for k in self._entries if k != exclude), None
            )
            if victim_key is None:
                return False
            self._release(self._entries.pop(victim_key))
            self.evictions += 1
        return True

    @property
    def pages_in_use(self) -> int:
        """Pages referenced by pool entries (a shared page counts once per
        holding entry; compare against allocator.used_pages only when the
        pool is the allocator's sole client)."""
        if self.allocator is None:
            return 0
        return sum(
            len(e.pages) for e in self._entries.values() if e.paged
        )

    def stats(self) -> Dict[str, int]:
        s = {
            "entries": len(self._entries),
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "invalidations": self.invalidations,
            "primes": self.primes,
        }
        if self.allocator is not None:
            s["rejects"] = self.rejects
            s["pages_in_use"] = self.pages_in_use
            s["free_pages"] = self.allocator.n_free
            # cross-session sharing: logical pages held vs distinct physical
            # pages backing them — the gap is the storage dedup win
            uniq: set = set()
            for e in self._entries.values():
                if e.paged:
                    uniq.update(e.pages)
            s["unique_pages"] = len(uniq)
            s["shared_hits"] = self.shared_hits
            s["shared_tokens"] = self.shared_tokens
        return s
