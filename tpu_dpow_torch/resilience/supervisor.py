"""DispatchSupervisor: re-dispatch and hedging for in-flight work.

The server's work publishes ride QoS 0 by design (a stale duplicate
delivered minutes later would waste lanes), so a publish that fires while
every worker is dead, mid-reconnect, or wedged simply evaporates — the
reference strands those waiters until timeout (reference dpow_server.py has
no analog). The supervisor owns the heal:

  * every on-demand dispatch is ``track``ed with the requesting waiter's
    DEADLINE (now + service timeout); later waiters joining the same hash
    extend it. Retries never outlive the slowest waiter's budget.
  * any publish for the hash (``dispatched``) or any worker result arriving
    for it (``activity``) re-arms the grace window;
  * a hash silent for a full ``grace`` window is re-published through the
    server-provided callback. From the ``hedge_after``-th attempt on the
    re-dispatch is HEDGED: the callback also publishes to the secondary
    work topic, recruiting workers outside the hash's own pool (a
    precache-only fleet will grind an on-demand hash rather than let the
    request die).

States are exported via obs:
  dpow_server_supervised_dispatches       gauge: tracked in-flight hashes
  dpow_server_redispatch_total{mode}      republish | hedged
  dpow_server_redispatch_abandoned_total  dispatches whose deadline passed
                                          with the future still unresolved
"""

from __future__ import annotations

import traceback
from typing import Awaitable, Callable, Dict, Optional

from .. import obs
from ..utils.logging import get_logger
from .clock import Clock, SystemClock

logger = get_logger("tpu_dpow_torch.resilience")

# republish callback: (block_hash, hedged) -> bool (True iff it published)
RepublishFn = Callable[[str, bool], Awaitable[bool]]


class _Dispatch:
    __slots__ = (
        "deadline", "last_signal", "attempts", "published", "abandoned",
        "hedged",
    )

    def __init__(self, deadline: float, now: float):
        self.deadline = deadline
        self.last_signal = now
        self.attempts = 0  # re-dispatches fired so far
        self.published = False  # first publish seen? (guards mid-dispatch)
        self.abandoned = False  # deadline passed (metric fired once)
        self.hedged = False  # ever hedged onto the secondary work topic?


class DispatchSupervisor:
    def __init__(
        self,
        *,
        grace: float,
        republish: RepublishFn,
        hedge_after: int = 2,
        clock: Optional[Clock] = None,
        on_abandon: Optional[Callable[[str], None]] = None,
    ):
        self.grace = grace
        self.hedge_after = max(hedge_after, 1)
        self.republish = republish
        self.clock = clock or SystemClock()
        # Fired once (sync) when a dispatch's deadline expires with the
        # future unresolved. Waiterless dispatches — a replica's ADOPTED
        # takeovers (tpu_dpow_torch/replica/) — have no request coroutine whose
        # teardown would ever reap them; this hook is their reaper.
        self.on_abandon = on_abandon
        self._dispatches: Dict[str, _Dispatch] = {}
        reg = obs.get_registry()
        self._m_tracked = reg.gauge(
            "dpow_server_supervised_dispatches",
            "In-flight dispatches under supervisor watch")
        self._m_redispatch = reg.counter(
            "dpow_server_redispatch_total",
            "Supervisor re-dispatches, by mode", ("mode",))
        self._m_abandoned = reg.counter(
            "dpow_server_redispatch_abandoned_total",
            "Dispatches whose deadline expired while still unresolved")

    # -- state fed by the server --------------------------------------

    def track(self, block_hash: str, deadline: float) -> None:
        """Begin (or extend) supervision: ``deadline`` is the caller's
        now + service timeout; the latest waiter's budget wins."""
        d = self._dispatches.get(block_hash)
        if d is None:
            self._dispatches[block_hash] = _Dispatch(deadline, self.clock.time())
            self._m_tracked.set(len(self._dispatches))
            return
        if deadline > d.deadline:
            d.deadline = deadline
            d.abandoned = False  # a fresh budget revives a stalled entry

    def dispatched(self, block_hash: str) -> None:
        """A work publish went out for this hash (initial, re-target, or
        re-dispatch): re-arm the grace window."""
        d = self._dispatches.get(block_hash)
        if d is not None:
            d.published = True
            d.last_signal = self.clock.time()

    def activity(self, block_hash: str) -> None:
        """A worker signal arrived for this hash (any parseable result):
        the swarm is alive on it, hold the re-dispatch."""
        d = self._dispatches.get(block_hash)
        if d is not None:
            d.last_signal = self.clock.time()

    def untrack(self, block_hash: str) -> None:
        if self._dispatches.pop(block_hash, None) is not None:
            self._m_tracked.set(len(self._dispatches))

    def tracked(self, block_hash: str) -> bool:
        return block_hash in self._dispatches

    def deadline_of(self, block_hash: str) -> Optional[float]:
        """The latest waiter deadline under supervision (None when
        untracked) — what a replica re-journals for its takeover record."""
        d = self._dispatches.get(block_hash)
        return d.deadline if d is not None else None

    def was_hedged(self, block_hash: str) -> bool:
        """Did this dispatch ever go out hedged? The winner's cancel must
        then fan out to the secondary work topic too, or the recruited
        workers (subscribed only there) grind the resolved hash forever."""
        d = self._dispatches.get(block_hash)
        return d is not None and d.hedged

    # -- the loop ------------------------------------------------------

    async def run(self) -> None:
        # Half-grace ticks bound the worst-case heal latency at 1.5x grace
        # (the old republish loop's full-interval tick gave 2x).
        tick = max(self.grace / 2.0, 0.01)
        while True:
            await self.clock.sleep(tick)
            await self.poll()

    async def poll(self) -> None:
        """One supervision pass. Public so fake-clock tests (and the chaos
        demo) can drive it without racing the run() loop."""
        now = self.clock.time()
        for block_hash, d in list(self._dispatches.items()):
            if self._dispatches.get(block_hash) is not d:
                continue  # untracked while we awaited an earlier republish
            if now >= d.deadline:
                # Every waiter's wait_for has expired (or is about to):
                # re-dispatching would have workers grind a hash whose
                # waiters are all gone. Keep the entry — teardown untracks
                # it, and a NEW waiter joining the still-live future
                # revives supervision by extending the deadline.
                if not d.abandoned:
                    d.abandoned = True
                    self._m_abandoned.inc()
                    logger.info(
                        "dispatch %s outlived its deadline; re-dispatch stopped",
                        block_hash,
                    )
                    if self.on_abandon is not None:
                        try:
                            self.on_abandon(block_hash)
                        except Exception:
                            logger.exception(
                                "abandon callback failed for %s", block_hash
                            )
                continue
            if not d.published:
                continue  # dispatcher still mid-publish; it will stamp
            if now - d.last_signal < self.grace:
                continue
            hedged = d.attempts + 1 >= self.hedge_after
            try:
                published = await self.republish(block_hash, hedged)
            except Exception:
                # Transient store/broker trouble: leave last_signal alone so
                # the next tick retries immediately.
                logger.warning(
                    "re-dispatch failed for %s:\n%s",
                    block_hash, traceback.format_exc(),
                )
                continue
            if published and self._dispatches.get(block_hash) is d:
                d.attempts += 1
                d.last_signal = self.clock.time()
                if hedged:
                    d.hedged = True
                self._m_redispatch.inc(1, "hedged" if hedged else "republish")
