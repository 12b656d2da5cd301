"""Injectable time: the seam that keeps every timer of the port testable.

The port's own copy of ``tpu_dpow/resilience/clock.py``. Components read
time and sleep through a ``Clock`` object instead of calling
``time.monotonic``/``asyncio.sleep`` directly (the persistent run mode's
``LaunchControl`` stamps polls and command deliveries on it). Production
code gets :class:`SystemClock`; tests get :class:`FakeClock`, whose time
only moves when the test calls ``advance()`` — so a poll-to-effect latency
plays out deterministically, with no real sleeps.
"""

from __future__ import annotations

import asyncio
import heapq
import itertools
import time


class Clock:
    """Monotonic time + async sleep, as one injectable object."""

    def time(self) -> float:
        raise NotImplementedError

    async def sleep(self, delay: float) -> None:
        raise NotImplementedError


class SystemClock(Clock):
    """The real thing: time.monotonic + asyncio.sleep."""

    def time(self) -> float:
        return time.monotonic()

    async def sleep(self, delay: float) -> None:
        await asyncio.sleep(delay)


class FakeClock(Clock):
    """Manually advanced clock: sleepers wake only via ``advance()``.

    Sleepers are woken in deadline order, and the loop is yielded to after
    each wake so a woken task can run — and schedule its NEXT sleep — before
    a later deadline inside the same ``advance()`` window fires. That makes
    a periodic loop (``while True: await clock.sleep(tick)``) tick the
    expected number of times for one large ``advance()``.
    """

    def __init__(self, start: float = 0.0):
        self._now = float(start)
        self._seq = itertools.count()  # FIFO tiebreak for equal deadlines
        self._sleepers: list = []  # heap of (deadline, seq, future)

    def time(self) -> float:
        return self._now

    async def sleep(self, delay: float) -> None:
        if delay <= 0:
            await asyncio.sleep(0)
            return
        fut = asyncio.get_running_loop().create_future()
        heapq.heappush(self._sleepers, (self._now + delay, next(self._seq), fut))
        await fut

    async def advance(self, delta: float) -> None:
        """Move time forward, waking due sleepers in deadline order."""
        target = self._now + float(delta)
        while self._sleepers and self._sleepers[0][0] <= target:
            deadline, _, fut = heapq.heappop(self._sleepers)
            if fut.done():  # a cancelled sleeper (task torn down mid-sleep)
                continue
            self._now = max(self._now, deadline)
            fut.set_result(None)
            await self._drain()
        self._now = target
        await self._drain()

    async def _drain(self, rounds: int = 12) -> None:
        # A bounded burst of yields: enough for a woken task to run through
        # several awaits (store ops, publishes) and re-arm its next sleep.
        # Anything longer-running is the test's job to await explicitly.
        for _ in range(rounds):
            await asyncio.sleep(0)
