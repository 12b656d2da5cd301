"""QuotaLedger: store-backed token buckets keyed by service.

The reference hub accepts every authenticated request unconditionally; the
only brake in this repo before the sched layer was the per-service
Throttler (utils/throttle.py), which DELAYS entry and keeps no state across
restarts — a restart hands every noisy tenant a fresh unthrottled window.
The ledger is the durable half of admission control: one token bucket per
service, its state (token count + refill stamp) persisted through the
``Store`` protocol, so it behaves identically on memory, sqlite and redis
backends and survives both server restarts (sqlite/redis) and a
``degraded+`` store failover (the DegradedStore mirror carries the bucket
into the fallback; tests/test_quota_contract.py pins all of it).

Semantics:
  * ``rate`` tokens/second refill, ``burst`` capacity; each request
    consumes one token. ``rate == 0`` disables metering entirely (no store
    I/O on the hot path).
  * consumption is SOFT by default: an empty bucket marks the request
    over-quota rather than rejecting it — over-quota work is simply first
    in line for load shedding when the dispatch window fills
    (sched/window.py). Callers wanting hard 429-on-empty enforce it
    themselves from the returned verdict (server/config.py ``quota_hard``).
  * time comes from the injectable resilience Clock. Stamps are stored in
    that clock's timebase; a stamp from the future (a restart reset the
    monotonic clock) resets the refill anchor to "now" and keeps the
    persisted token count — conservative, never a free burst.

In-process concurrency is serialized per service (one asyncio.Lock each);
cross-process deployments sharing one redis get last-writer-wins on the
bucket record, which under-counts at worst one burst per writer — the
window bound downstream is the hard guarantee, the ledger is the fairness
signal.
"""

from __future__ import annotations

import asyncio
from typing import Dict, Optional, Tuple

from ..resilience.clock import Clock, SystemClock


class QuotaVerdict:
    """Outcome of one ``consume()``: allowed-with-tokens, or over-quota
    with the refill wait a caller should advertise as Retry-After."""

    __slots__ = ("allowed", "retry_after", "tokens")

    def __init__(self, allowed: bool, retry_after: float, tokens: float):
        self.allowed = allowed
        self.retry_after = retry_after
        self.tokens = tokens

    def __repr__(self):  # pragma: no cover - debugging aid
        return (f"QuotaVerdict(allowed={self.allowed}, "
                f"retry_after={self.retry_after:.3f}, tokens={self.tokens:.3f})")


class QuotaLedger:
    """Per-service token buckets persisted under ``quota:{service}``."""

    PREFIX = "quota:"

    def __init__(
        self,
        store,
        *,
        rate: float,
        burst: float,
        clock: Optional[Clock] = None,
    ):
        if burst < 1 and rate > 0:
            raise ValueError("burst must admit at least one request")
        self.store = store
        self.rate = rate
        self.burst = burst
        self.clock = clock or SystemClock()
        self._locks: Dict[str, asyncio.Lock] = {}

    def _lock(self, service: str) -> asyncio.Lock:
        return self._locks.setdefault(service, asyncio.Lock())

    async def _load(self, service: str) -> Tuple[float, float]:
        """(tokens, stamp) for a service; a fresh bucket starts full."""
        state = await self.store.hgetall(f"{self.PREFIX}{service}")
        now = self.clock.time()
        try:
            tokens = float(state["tokens"])
            stamp = float(state["stamp"])
        except (KeyError, ValueError):
            return self.burst, now
        if stamp > now:
            # Clock went backwards (restart reset the monotonic timebase):
            # keep the persisted token count, restart refill from now.
            stamp = now
        return tokens, stamp

    async def consume(self, service: str, tokens: float = 1.0) -> QuotaVerdict:
        """Take ``tokens`` from the service's bucket.

        Always records the consumption (an over-quota service keeps digging
        into its refill debt is NOT what happens — the bucket floors at 0 so
        one burst of rejections doesn't punish the service for minutes).
        """
        if self.rate <= 0:
            return QuotaVerdict(True, 0.0, float("inf"))
        async with self._lock(service):
            have, stamp = await self._load(service)
            now = self.clock.time()
            have = min(self.burst, have + (now - stamp) * self.rate)
            if have >= tokens:
                have -= tokens
                allowed, retry_after = True, 0.0
            else:
                allowed = False
                retry_after = (tokens - have) / self.rate
            # dpowlint: disable=DPOW1005 — documented last-writer-wins: the per-service asyncio.Lock serializes in-process RMW, and cross-process sharing under-counts at worst one burst per writer (module docstring); the window bound downstream is the hard guarantee
            await self.store.hset(
                f"{self.PREFIX}{service}",
                {"tokens": f"{have:.6f}", "stamp": f"{now:.6f}"},
            )
            return QuotaVerdict(allowed, retry_after, have)

    async def peek(self, service: str) -> float:
        """Current token balance (refilled to now) without consuming."""
        if self.rate <= 0:
            return float("inf")
        have, stamp = await self._load(service)
        return min(self.burst, have + (self.clock.time() - stamp) * self.rate)
