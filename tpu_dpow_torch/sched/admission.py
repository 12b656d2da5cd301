"""AdmissionController: the one object the server's dispatch path asks.

Composes the three sched primitives — QuotaLedger (who has budget),
FairQueue-backed DispatchWindow (who goes next, who gets shed) — behind
the API server/app.py calls, and owns ALL of the subsystem's /metrics
families so every admit/reject/shed decision is visible per class and per
service (docs/admission.md has the catalogue and the 429 contract).

Decision accounting is exhaustive and disjoint: every admission request
ends in exactly one of ``admitted`` / ``rejected`` / ``shed``, so the
three counters sum to the offered load (the overload acceptance test
pins a 50-request burst to exactly 50 across the three).
"""

from __future__ import annotations

import asyncio
from typing import Dict, Optional

from .. import obs
from ..resilience.clock import Clock, SystemClock
from ..utils.logging import get_logger
from .queue import ONDEMAND, PRECACHE, Ticket
from .quota import QuotaLedger
from .window import Busy, DispatchWindow

logger = get_logger("tpu_dpow_torch.sched")

#: label used for precache admissions — block arrivals have no service.
NODE_SERVICE = "node"


class AdmissionController:
    def __init__(
        self,
        store,
        *,
        clock: Optional[Clock] = None,
        window: int = 0,
        queue_limit: int = 64,
        quota_rate: float = 0.0,
        quota_burst: float = 20.0,
        quota_hard: bool = False,
        precache_lease: float = 30.0,
        precache_window_fraction: float = 1.0,
        busy_retry_after: float = 1.0,
    ):
        self.clock = clock or SystemClock()
        self.quota_hard = quota_hard
        # Rate shaping for speculative work: precache may hold at most this
        # fraction of a bounded window's slots, so a confirmation storm can
        # never crowd on-demand admission below (1 - fraction) of capacity.
        # 1.0 (or an unbounded window) disables the carve-out — the seed
        # behavior, where only the shed-on-full rule protects on-demand.
        self.precache_fraction = min(max(precache_window_fraction, 0.0), 1.0)
        self.ledger = QuotaLedger(
            store, rate=quota_rate, burst=quota_burst, clock=self.clock
        )
        self.window = DispatchWindow(
            capacity=window,
            queue_limit=queue_limit,
            clock=self.clock,
            lease=precache_lease,
            retry_after=busy_retry_after,
            on_event=self._event,
        )
        # Precache leases by block hash: released when the worker result
        # lands (or the frontier retires the hash), expired by the sweep.
        self._leases: Dict[str, Ticket] = {}
        # Autoscale lever (docs/loadgen.md): while True, every precache
        # admission is shed on arrival — precache is speculative capacity
        # the controller reclaims first under a p95 breach. On-demand
        # admission is untouched.
        self.shed_precache = False

        reg = obs.get_registry()
        self._m_admitted = reg.counter(
            "dpow_sched_admitted_total",
            "Work granted a dispatch slot, by class and service",
            ("work_class", "service"))
        self._m_rejected = reg.counter(
            "dpow_sched_rejected_total",
            "Admissions refused on arrival (backpressure full or hard "
            "over-quota), by class and service", ("work_class", "service"))
        self._m_shed = reg.counter(
            "dpow_sched_shed_total",
            "Admitted work evicted under load (policy order: precache, "
            "over-quota, most slack), by class and service",
            ("work_class", "service"))
        self._m_over_quota = reg.counter(
            "dpow_sched_over_quota_total",
            "Requests that found their service's token bucket empty",
            ("service",))
        self._m_queue_depth = reg.gauge(
            "dpow_sched_queue_depth",
            "Admitted work waiting for a window slot, by class",
            ("work_class",))
        self._m_queue_wait = reg.histogram(
            "dpow_sched_queue_wait_seconds",
            "Queue entry to window grant, by class", ("work_class",))
        self._m_inflight = reg.gauge(
            "dpow_sched_inflight", "Dispatches holding a window slot")
        self._m_capacity = reg.gauge(
            "dpow_sched_window_capacity",
            "Configured in-flight window (0 = unbounded)")
        self._m_capacity.set(float(window))
        self._m_inflight.set(0.0)

    # -- event sink (metrics) -----------------------------------------

    def _event(self, event: str, ticket: Ticket) -> None:
        if event == "admitted":
            self._m_admitted.inc(1, ticket.work_class, ticket.service)
            if ticket.granted_at is not None:
                # enqueued_at is always stamped by this controller; 0.0 is
                # a legitimate clock reading (FakeClock starts there), so
                # no falsy-zero guard on it.
                self._m_queue_wait.observe(
                    max(ticket.granted_at - ticket.enqueued_at, 0.0),
                    ticket.work_class,
                )
        elif event == "rejected":
            self._m_rejected.inc(1, ticket.work_class, ticket.service)
        elif event == "shed":
            self._m_shed.inc(1, ticket.work_class, ticket.service)
        self._sync_gauges()

    def _sync_gauges(self) -> None:
        self._m_inflight.set(float(self.window.inflight))
        for work_class in (ONDEMAND, PRECACHE):
            self._m_queue_depth.set(
                float(self.window.queue.depth(work_class)), work_class
            )

    # -- the server-facing API ----------------------------------------

    async def consume_quota(self, service: str) -> bool:
        """One request's token. Returns the over-quota flag (soft mode);
        raises Busy carrying the refill wait in hard mode."""
        verdict = await self.ledger.consume(service)
        if verdict.allowed:
            return False
        self._m_over_quota.inc(1, service)
        if self.quota_hard:
            # Hard rejection is an arrival refusal: count it here (the
            # ticket never reaches the window).
            self._m_rejected.inc(
                1, ONDEMAND, service)
            raise Busy(verdict.retry_after, reason="over quota")
        return True

    async def acquire_dispatch(
        self,
        key: str,
        service: str,
        *,
        difficulty: int,
        deadline: float,
        over_quota: bool = False,
    ) -> Ticket:
        """Admit one on-demand dispatch; may wait for a window slot.
        Raises Busy when rejected or shed under load."""
        ticket = Ticket(
            key, service,
            work_class=ONDEMAND,
            difficulty=difficulty,
            deadline=deadline,
            over_quota=over_quota,
            enqueued_at=self.clock.time(),
        )
        await self.window.acquire(ticket)
        return ticket

    def try_acquire_precache(self, key: str, *, difficulty: int = 0) -> Optional[Ticket]:
        """Admit one precache dispatch iff the window has room right now;
        a full system sheds precache first (never queues it)."""
        existing = self._leases.get(key)
        if existing is not None and self.window.holds(existing):
            # Replayed confirmation for a hash whose lease is still live
            # (e.g. a node ws reconnect re-delivering): one slot per hash —
            # granting a second would strand the first until its lapse.
            # Not a new admission decision, so no counter moves.
            return existing
        ticket = Ticket(
            key, NODE_SERVICE,
            work_class=PRECACHE,
            difficulty=difficulty,
            enqueued_at=self.clock.time(),
        )
        if self.shed_precache:
            # the autoscaler closed precache admission: account the shed
            # (the admitted/rejected/shed sum stays exhaustive) and refuse
            self._event("shed", ticket)
            return None
        if (
            self.window.capacity > 0
            and self.precache_fraction < 1.0
            and self.precache_inflight
            >= max(1, int(self.precache_fraction * self.window.capacity))
        ):
            # Precache's window share is spent: shed exactly as a full
            # window would (same counter, same "next confirmation retries"
            # contract) while on-demand admission still sees free slots.
            self._event("shed", ticket)
            return None
        if self.window.try_acquire(ticket):
            self._leases[key] = ticket
            return ticket
        return None

    @property
    def precache_inflight(self) -> int:
        """Window slots currently held by live precache leases."""
        return sum(
            1 for t in self._leases.values() if self.window.holds(t)
        )

    def has_lease(self, key: str) -> bool:
        """Is a precache lease for this block hash still holding a slot?
        (False once the lease lapsed or a result released it — the
        precache pipeline's reaper keys its cache eviction on this.)"""
        ticket = self._leases.get(key)
        return ticket is not None and self.window.holds(ticket)

    def release(self, ticket: Ticket) -> None:
        # Identity-guarded: an on-demand dispatch and a precache lease can
        # coexist for the SAME hash (service request for a still-pending
        # precached block) — releasing the dispatch must not orphan the
        # lease's entry, or its slot stays pinned until the lease lapses.
        if self._leases.get(ticket.key) is ticket:
            del self._leases[ticket.key]
        self.window.release(ticket)
        self._sync_gauges()

    def release_key(self, key: str) -> None:
        """Release a precache lease by block hash (result landed, or the
        frontier retired the hash). Unknown keys are a no-op."""
        ticket = self._leases.pop(key, None)
        if ticket is not None:
            self.window.release(ticket)
            self._sync_gauges()

    # -- clock-driven sweep -------------------------------------------

    def poll(self) -> None:
        """Lapse precache leases + expire queued waiters past deadline."""
        now = self.clock.time()
        self.window.expire(now)
        for key, ticket in list(self._leases.items()):
            if ticket not in self.window._inflight:
                self._leases.pop(key, None)
        self._sync_gauges()

    async def run(self, interval: float = 0.5) -> None:
        while True:
            await self.clock.sleep(interval)
            self.poll()
