"""FairQueue: weighted priority ordering with per-service fair share.

Orders admitted-but-waiting work for the dispatch window (sched/window.py).
Three concerns, strictly layered:

  1. CLASS dominates — on-demand work (a service is actively waiting on an
     open request) always outranks precache (speculative warm-up that can
     be regenerated); within a class, in-quota work outranks over-quota
     (sched/quota.py's soft verdict).
  2. FAIR SHARE across services — grants round-robin over the services
     holding work of the best available (class, quota) tier, so one noisy
     tenant with 100 queued requests cannot starve a quiet one with 1: the
     quiet service gets every other grant while both have work queued.
  3. Within one service, least deadline slack first (the request closest
     to timing out dispatches first), hardest difficulty breaking ties
     (harder work needs the head start).

Shedding walks the same ordering from the other end: the victim is the
globally WORST ticket — precache before over-quota before the most-slack
entry (it has the most budget left to retry).

Pure in-memory data structure, single event loop, no awaits; the async
choreography (futures, Busy, leases) lives in window.py.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional

ONDEMAND = "ondemand"
PRECACHE = "precache"
_CLASS_RANK = {ONDEMAND: 0, PRECACHE: 1}


class Ticket:
    """One admission: a unit of work asking for a dispatch-window slot."""

    __slots__ = (
        "key", "service", "work_class", "difficulty", "deadline",
        "over_quota", "enqueued_at", "future", "granted_at",
    )

    def __init__(
        self,
        key: str,
        service: str,
        *,
        work_class: str = ONDEMAND,
        difficulty: int = 0,
        deadline: float = float("inf"),
        over_quota: bool = False,
        enqueued_at: float = 0.0,
    ):
        if work_class not in _CLASS_RANK:
            raise ValueError(f"unknown work class {work_class!r}")
        self.key = key
        self.service = service
        self.work_class = work_class
        self.difficulty = difficulty
        self.deadline = deadline
        self.over_quota = over_quota
        self.enqueued_at = enqueued_at
        self.future = None  # set iff the ticket waits in the queue
        self.granted_at = None  # stamped by the window at grant time

    @property
    def class_rank(self) -> int:
        return _CLASS_RANK[self.work_class]

    def order_key(self):
        """Ascending = more urgent. Class, quota standing, deadline slack
        (an earlier deadline IS less slack), difficulty (harder first)."""
        return (self.class_rank, self.over_quota, self.deadline, -self.difficulty)

    def __repr__(self):  # pragma: no cover - debugging aid
        return (f"Ticket({self.key!r}, {self.service!r}, {self.work_class}, "
                f"oq={self.over_quota}, deadline={self.deadline})")


class FairQueue:
    """Per-service sorted lanes + a round-robin grant rotation."""

    def __init__(self):
        self._lanes: Dict[str, List[Ticket]] = {}  # service → best-first
        self._rr: List[str] = []  # least-recently-granted first

    def __len__(self) -> int:
        return sum(len(lane) for lane in self._lanes.values())

    def depth(self, work_class: str) -> int:
        return sum(
            1 for lane in self._lanes.values() for t in lane
            if t.work_class == work_class
        )

    def push(self, ticket: Ticket) -> None:
        lane = self._lanes.setdefault(ticket.service, [])
        bisect.insort(lane, ticket, key=Ticket.order_key)
        if ticket.service not in self._rr:
            self._rr.append(ticket.service)

    def remove(self, ticket: Ticket) -> bool:
        lane = self._lanes.get(ticket.service)
        if not lane:
            return False
        try:
            lane.remove(ticket)
        except ValueError:
            return False
        if not lane:
            del self._lanes[ticket.service]
        return True

    def pop_best(self) -> Optional[Ticket]:
        """Next grant: best (class, quota) tier anywhere, then the
        least-recently-granted service within that tier, then that
        service's most urgent ticket."""
        best_tier = None
        for lane in self._lanes.values():
            tier = (lane[0].class_rank, lane[0].over_quota)
            if best_tier is None or tier < best_tier:
                best_tier = tier
        if best_tier is None:
            return None
        for service in self._rr:
            lane = self._lanes.get(service)
            if not lane:
                continue
            if (lane[0].class_rank, lane[0].over_quota) == best_tier:
                ticket = lane.pop(0)
                if not lane:
                    del self._lanes[service]
                # Most-recently-granted moves to the back of the rotation.
                self._rr.remove(service)
                self._rr.append(service)
                return ticket
        return None  # unreachable while _rr covers every lane

    def shed_victim(self, holdings: Optional[Dict[str, int]] = None) -> Optional[Ticket]:
        """Remove and return the globally worst ticket (load-shedding
        order: precache → over-quota → most deadline slack).

        ``holdings``: current in-flight slot counts per service (from the
        window). It breaks slack ties toward the tenant holding the most
        capacity overall (in-flight + queued) — without it, a burst of
        equal-deadline requests would shed whichever service's lane the
        dict happens to visit first, starving a quiet tenant for being
        early; with it, shedding equalizes per-tenant holdings, which IS
        the fair-share guarantee under a saturating burst.
        """
        holdings = holdings or {}
        worst = None
        worst_key = None
        for service, lane in self._lanes.items():
            candidate = lane[-1]  # worst within its service
            key = (candidate.class_rank, candidate.over_quota,
                   candidate.deadline, holdings.get(service, 0) + len(lane))
            if worst is None or key > worst_key:
                worst, worst_key = candidate, key
        if worst is not None:
            self.remove(worst)
        return worst

    def expired(self, now: float) -> List[Ticket]:
        """Remove and return every ticket whose deadline has passed."""
        out = []
        for lane in list(self._lanes.values()):
            out.extend(t for t in lane if t.deadline <= now)
        for t in out:
            self.remove(t)
        return out
