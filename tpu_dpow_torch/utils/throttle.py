"""Async rate limiter (per-service request throttle).

Replacement for the reference's ``asyncio_throttle.Throttler`` dependency
(reference server/dpow_server.py:45, config default 1 req/s at
server/dpow/config.py:17): an async context manager that DELAYS entry until
the sliding-window rate allows it, rather than rejecting.
"""

from __future__ import annotations

import asyncio
import time
from collections import deque


class Throttler:
    """Admit ``rate_limit`` entries per sliding ``period`` seconds.

    Same parameter semantics as asyncio_throttle.Throttler: rate_limit is a
    COUNT per period, not a per-second rate (Throttler(10, 60) = 10 requests
    per minute). A fractional rate_limit < 1 scales the window instead —
    Throttler(0.5) admits one request per 2 s, not one per second (the
    sub-1 --throttle values the server's min of 0.1 explicitly allows).
    """

    def __init__(
        self,
        rate_limit: float,
        period: float = 1.0,
        clock=time.monotonic,
        sleep=asyncio.sleep,
    ):
        if rate_limit <= 0:
            raise ValueError("rate_limit must be positive")
        self.rate_limit = rate_limit
        self.period = period
        self._sleep = sleep
        # Integral admit count; the window scales so ANY fractional rate is
        # honored exactly (0.5 → 1 per 2·period; 1.5 → 1 per period/1.5),
        # not floor-truncated.
        self._capacity = max(1, int(rate_limit))
        self._window = period * self._capacity / rate_limit
        self._clock = clock
        self._starts: deque = deque()

    def _prune(self, now: float) -> None:
        horizon = now - self._window
        while self._starts and self._starts[0] <= horizon:
            self._starts.popleft()

    async def __aenter__(self):
        while True:
            now = self._clock()
            self._prune(now)
            if len(self._starts) < self._capacity:
                self._starts.append(now)
                return self
            # Sleep until the oldest start slides out of the window (the
            # sleep seam pairs with the clock one: inject both or neither).
            await self._sleep(max(self._starts[0] + self._window - now, 0.001))

    async def __aexit__(self, *exc):
        return False
