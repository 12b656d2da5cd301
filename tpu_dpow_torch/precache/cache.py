"""PrecacheCache: the bounded budget of speculative work.

The seed decides "is this confirmation worth solving?" with an unbounded
scatter of ``account:{account}`` frontier keys — every known account's
every confirmation is worth a dispatch, forever. At population scale that
is a budget with no bound and no priority: the Zipf tail eats the window
and the head's hit ratio collapses under exactly the load that makes
precaching matter.

This cache IS the budget. ``capacity`` entries, each a block hash the
pipeline has decided to speculatively solve, ranked by the owning
account's activity score (scorer.py):

  * below ``watermark * capacity`` occupancy a confirmation is admitted
    whenever its score clears ``min_score`` — cheap speculation while the
    budget is slack;
  * inside the watermark zone (and at capacity) a newcomer must BEAT the
    lowest-scored resident; at the hard bound the loser is evicted and
    its dispatch retired. Admission pressure therefore converges on "the
    hottest ``capacity`` accounts' frontiers", which is the whole point;
  * entries are ``pending`` (dispatched, no proof yet) until the winner
    path marks them ``ready``; pending entries whose admission lease
    lapsed are reaped by the pipeline's run loop (reason
    ``lease_lapse``) so a dead dispatch can't squat in the budget.

Hit accounting: ``note_request`` records whether an on-demand request
was served from precached work (work_type == precache ⇒ hit). The ratio
over a sliding ``hit_window`` is exported as ``dpow_precache_hit_ratio``
— the autoscaler's precache signal (autoscale/signals.py) and the
headline number of docs/precache.md.

Synchronization contract: every method here is synchronous — the
pipeline calls ``precheck`` and ``insert`` with NO awaits in between,
so an admission verdict cannot be invalidated by a concurrent
confirmation's interleaved insert (single event loop, no locks needed).
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, Optional, Tuple

from .. import obs
from ..resilience.clock import Clock, SystemClock

PENDING = "pending"
READY = "ready"

#: admission refusal reasons (dpow_precache_admission_refused_total)
REFUSE_DUPLICATE = "duplicate"
REFUSE_SCORE_FLOOR = "score_floor"
REFUSE_BELOW_CACHED = "below_cached"

#: eviction/removal reasons (dpow_precache_evictions_total)
EVICT_CAPACITY = "capacity"
EVICT_SUPERSEDED = "superseded"
EVICT_LEASE_LAPSE = "lease_lapse"
EVICT_SHED = "shed"
EVICT_STALE = "stale"
EVICT_DUPLICATE = "duplicate"
EVICT_SERVED = "served"


@dataclass
class CacheEntry:
    block_hash: str
    account: str
    score: float
    state: str = PENDING
    born: float = 0.0


class PrecacheCache:
    def __init__(
        self,
        *,
        capacity: int = 512,
        watermark: float = 0.9,
        min_score: float = 0.0,
        hit_window: float = 300.0,
        clock: Optional[Clock] = None,
    ):
        self.capacity = max(int(capacity), 1)
        self.watermark = min(max(watermark, 0.0), 1.0)
        self.min_score = min_score
        self.hit_window = hit_window
        self.clock = clock or SystemClock()
        self._entries: Dict[str, CacheEntry] = {}
        # (t, was_hit) samples for the sliding hit-ratio window
        self._requests: Deque[Tuple[float, bool]] = deque()
        reg = obs.get_registry()
        self._m_entries = reg.gauge(
            "dpow_precache_cache_entries",
            "Precached-work cache occupancy by entry state",
            ("state",))
        self._m_hit_ratio = reg.gauge(
            "dpow_precache_hit_ratio",
            "Fraction of recent on-demand requests served from precached "
            "work (sliding window; the speculative budget's yield)")
        self._m_requests = reg.counter(
            "dpow_precache_requests_total",
            "Work requests classified by precache outcome",
            ("outcome",))
        self._m_evictions = reg.counter(
            "dpow_precache_evictions_total",
            "Cache entries removed, by reason",
            ("reason",))
        self._m_refused = reg.counter(
            "dpow_precache_admission_refused_total",
            "Confirmations refused admission to the cache, by reason",
            ("reason",))
        self._update_gauges()

    # -- introspection --------------------------------------------------

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, block_hash: str) -> bool:
        return block_hash in self._entries

    def get(self, block_hash: str) -> Optional[CacheEntry]:
        return self._entries.get(block_hash)

    def entries(self):
        return list(self._entries.values())

    def _lowest(self) -> Optional[CacheEntry]:
        if not self._entries:
            return None
        return min(self._entries.values(), key=lambda e: (e.score, e.born))

    def _update_gauges(self) -> None:
        pending = sum(1 for e in self._entries.values() if e.state == PENDING)
        self._m_entries.set(float(pending), PENDING)
        self._m_entries.set(float(len(self._entries) - pending), READY)

    # -- admission ------------------------------------------------------

    def precheck(
        self, block_hash: str, score: float, *, force: bool = False
    ) -> Optional[str]:
        """Admission verdict BEFORE any store/dispatch cost is paid.
        Returns a refusal reason, or None to admit. ``force`` (debug mode)
        bypasses score policy but never the duplicate check or the hard
        bound's evict-the-lowest discipline."""
        if block_hash in self._entries:
            self._m_refused.inc(1, REFUSE_DUPLICATE)
            return REFUSE_DUPLICATE
        if force:
            return None
        if score < self.min_score:
            self._m_refused.inc(1, REFUSE_SCORE_FLOOR)
            return REFUSE_SCORE_FLOOR
        if len(self._entries) >= int(self.watermark * self.capacity):
            lowest = self._lowest()
            if lowest is not None and score <= lowest.score:
                self._m_refused.inc(1, REFUSE_BELOW_CACHED)
                return REFUSE_BELOW_CACHED
        return None

    def insert(
        self, block_hash: str, account: str, score: float
    ) -> Tuple[CacheEntry, Optional[CacheEntry]]:
        """Admit an entry the caller already precheck()ed. Returns
        (entry, evicted): at the hard bound the lowest-scored resident is
        evicted and returned so the caller can retire its dispatch."""
        evicted: Optional[CacheEntry] = None
        if len(self._entries) >= self.capacity:
            lowest = self._lowest()
            if lowest is not None:
                evicted = self._entries.pop(lowest.block_hash)
                self._m_evictions.inc(1, EVICT_CAPACITY)
        entry = CacheEntry(
            block_hash=block_hash,
            account=account,
            score=score,
            born=self.clock.time(),
        )
        self._entries[block_hash] = entry
        self._update_gauges()
        return entry, evicted

    # -- lifecycle ------------------------------------------------------

    def mark_ready(self, block_hash: str) -> bool:
        entry = self._entries.get(block_hash)
        if entry is None:
            return False
        entry.state = READY
        self._update_gauges()
        return True

    def remove(self, block_hash: str, reason: str) -> Optional[CacheEntry]:
        entry = self._entries.pop(block_hash, None)
        if entry is not None:
            self._m_evictions.inc(1, reason)
            self._update_gauges()
        return entry

    # -- hit accounting -------------------------------------------------

    def note_request(self, hit: bool) -> None:
        """Record one on-demand request's precache outcome and refresh
        the sliding-window hit ratio."""
        now = self.clock.time()
        self._requests.append((now, hit))
        self._m_requests.inc(1, "hit" if hit else "miss")
        self._m_hit_ratio.set(self._ratio(now))

    def hit_ratio(self) -> Optional[float]:
        """Sliding-window hit ratio; None with no recent requests."""
        now = self.clock.time()
        ratio = self._ratio(now)
        self._m_hit_ratio.set(ratio)
        if not self._requests:
            return None
        return ratio

    def _ratio(self, now: float) -> float:
        cutoff = now - self.hit_window
        while self._requests and self._requests[0][0] < cutoff:
            self._requests.popleft()
        if not self._requests:
            return 0.0
        hits = sum(1 for _, was_hit in self._requests if was_hit)
        return hits / len(self._requests)
