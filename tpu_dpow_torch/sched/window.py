"""DispatchWindow: bounded in-flight dispatches with backpressure.

The hub's actual capacity is the worker fleet's launch pipeline; flooding
it past that point only grows every queue in the system (broker session
queues, engine job tables) without raising throughput. The window is the
single admission point the server's dispatch path routes through:

  * at most ``capacity`` dispatches in flight (0 = unbounded — admission
    still meters, never blocks: the seed behavior);
  * when the window is full, ON-DEMAND work waits in the FairQueue
    (sched/queue.py) up to ``queue_limit`` deep — the backpressure signal.
    Past that, load is shed in policy order (precache → over-quota → most
    slack) and the evicted caller gets :class:`Busy` carrying the
    Retry-After hint;
  * PRECACHE work never waits: a full window sheds it on arrival (it is
    speculative — the next block confirmation regenerates it), and a
    granted precache slot is a LEASE that expires after ``lease`` seconds
    if no worker result ever lands, so dead precache publishes cannot
    pin the window shut.

Every timestamp and expiry runs on the injectable resilience Clock, so
scheduling tests advance hours in milliseconds (FakeClock, no real
sleeps). The window emits events ("admitted", "queued", "rejected",
"shed") through a callback; the AdmissionController (sched/admission.py)
turns those into the /metrics families.
"""

from __future__ import annotations

import asyncio
from typing import Callable, Dict, Optional

from ..obs.ledger import LEDGER
from ..resilience.clock import Clock, SystemClock
from .queue import FairQueue, PRECACHE, Ticket


def _ledger_kind(ticket: Ticket) -> str:
    """LeakLedger kind for a window slot: a granted precache slot is a
    LEASE (sweep-expirable), an on-demand slot is a TICKET (explicit
    release only). One seam covers every grant/release/lapse path —
    including acquire()'s cancellation handler — so the runtime ledger
    (obs/ledger.py, dpowsan zero-outstanding invariant) cannot drift
    from the admission bookkeeping."""
    return "lease" if ticket.work_class == PRECACHE else "ticket"


class Busy(Exception):
    """Admission refused under load; retry after ``retry_after`` seconds.

    Maps to HTTP 429 + ``Retry-After`` on the POST face and a structured
    ``busy`` error frame on the websocket face (server/api.py).
    """

    def __init__(self, retry_after: float, reason: str = "overloaded"):
        super().__init__(reason)
        self.retry_after = max(retry_after, 0.0)
        self.reason = reason


class DispatchWindow:
    def __init__(
        self,
        *,
        capacity: int,
        queue_limit: int,
        clock: Optional[Clock] = None,
        lease: float = 30.0,
        retry_after: float = 1.0,
        on_event: Optional[Callable[[str, Ticket], None]] = None,
    ):
        self.capacity = capacity
        self.queue_limit = max(queue_limit, 0)
        self.clock = clock or SystemClock()
        self.lease = lease
        self.retry_after_hint = retry_after
        self.on_event = on_event or (lambda event, ticket: None)
        self.queue = FairQueue()
        # ticket → lease expiry (+inf for on-demand: released explicitly
        # by the dispatch teardown, never by the sweep).
        self._inflight: Dict[Ticket, float] = {}
        # service → slots currently held; feeds the shed tie-break so
        # saturation equalizes per-tenant holdings (fair share).
        self._inflight_by_service: Dict[str, int] = {}

    # -- state ---------------------------------------------------------

    @property
    def inflight(self) -> int:
        return len(self._inflight)

    @property
    def queued(self) -> int:
        return len(self.queue)

    def holds(self, ticket: Ticket) -> bool:
        """Is this ticket currently occupying a window slot?"""
        return ticket in self._inflight

    def _has_room(self) -> bool:
        return self.capacity <= 0 or len(self._inflight) < self.capacity

    # -- grant / fail plumbing ----------------------------------------

    def _grant(self, ticket: Ticket) -> None:
        expiry = (
            self.clock.time() + self.lease
            if ticket.work_class == PRECACHE
            else float("inf")
        )
        self._inflight[ticket] = expiry
        LEDGER.acquire(_ledger_kind(ticket), ticket)
        self._inflight_by_service[ticket.service] = (
            self._inflight_by_service.get(ticket.service, 0) + 1
        )
        ticket.granted_at = self.clock.time()
        if ticket.future is not None and not ticket.future.done():
            ticket.future.set_result(True)
        self.on_event("admitted", ticket)

    def _fail(self, ticket: Ticket, event: str, retry_after: float) -> None:
        self.on_event(event, ticket)
        if ticket.future is not None and not ticket.future.done():
            ticket.future.set_exception(Busy(retry_after))

    def _grant_next(self) -> None:
        while self._has_room():
            ticket = self.queue.pop_best()
            if ticket is None:
                return
            self._grant(ticket)

    # -- the three admission paths ------------------------------------

    async def acquire(self, ticket: Ticket) -> Ticket:
        """On-demand admission: immediate grant, a queued wait, or Busy."""
        self.expire(self.clock.time())
        if self._has_room() and len(self.queue) == 0:
            self._grant(ticket)
            return ticket
        ticket.future = asyncio.get_running_loop().create_future()
        ticket.enqueued_at = self.clock.time()
        self.queue.push(ticket)
        self.on_event("queued", ticket)
        # Backpressure: past the bound, evict the policy-worst entry. If
        # that is the arriving ticket itself, the caller is REJECTED (the
        # system never owed it anything); an older evicted entry was
        # admitted to the queue and is SHED.
        while len(self.queue) > self.queue_limit:
            victim = self.queue.shed_victim(self._inflight_by_service)
            if victim is None:
                break
            self._fail(
                victim,
                "rejected" if victim is ticket else "shed",
                self.retry_after_hint,
            )
            if victim is ticket:
                break
        try:
            await ticket.future
        except asyncio.CancelledError:
            # Waiter torn down (client dropped the connection): if the
            # grant already landed the slot must go back, otherwise just
            # leave the queue.
            if ticket in self._inflight:
                self.release(ticket)
            elif self.queue.remove(ticket):
                self.on_event("shed", ticket)
            if ticket.future.done() and not ticket.future.cancelled():
                ticket.future.exception()  # a racing Busy: mark retrieved
            raise
        return ticket

    def try_acquire(self, ticket: Ticket) -> bool:
        """Precache admission: grant iff there is room NOW, else shed
        (precache is first in the load-shedding order by construction —
        it never displaces queued on-demand work)."""
        self.expire(self.clock.time())
        if self._has_room() and len(self.queue) == 0:
            self._grant(ticket)
            return True
        self._fail(ticket, "shed", self.retry_after_hint)
        return False

    def release(self, ticket: Ticket) -> None:
        if self._inflight.pop(ticket, None) is not None:
            LEDGER.discharge(_ledger_kind(ticket), ticket)
            self._drop_holding(ticket)
            self._grant_next()

    def _drop_holding(self, ticket: Ticket) -> None:
        left = self._inflight_by_service.get(ticket.service, 1) - 1
        if left <= 0:
            self._inflight_by_service.pop(ticket.service, None)
        else:
            self._inflight_by_service[ticket.service] = left

    # -- clock-driven maintenance -------------------------------------

    def expire(self, now: float) -> None:
        """Lapse precache leases and fail queued tickets whose deadline
        passed (their waiter's budget is gone; Busy beats a silent hang)."""
        lapsed = [t for t, expiry in self._inflight.items() if expiry <= now]
        for ticket in lapsed:
            del self._inflight[ticket]
            LEDGER.discharge(_ledger_kind(ticket), ticket, op="lapse")
            self._drop_holding(ticket)
        for ticket in self.queue.expired(now):
            self._fail(ticket, "shed", self.retry_after_hint)
        if lapsed:
            self._grant_next()
