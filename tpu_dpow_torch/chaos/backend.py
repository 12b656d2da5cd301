"""FaultyBackend: fault injection at the work-engine seam.

Wraps any :class:`~tpu_dpow_torch.backend.WorkBackend`. ``generate`` consults the
schedule with op "generate" and subject = the block hash:

  error      — raise WorkError without touching the engine (a crashed
               work server);
  hang       — block until ``cancel()`` for the hash arrives (then raise
               WorkCancelled, the engine contract for an aborted scan) or
               the task is torn down: a worker that died mid-scan, as the
               server sees it;
  wrong_work — return a nonce deterministically chosen to FAIL validation
               at the request's difficulty (a buggy or malicious engine);
  delay      — clock.sleep(rule.delay), then the real engine.

``setup`` honors error rules too (op "setup"), so a fallback chain can be
tested against an engine that never comes up.
"""

from __future__ import annotations

import asyncio
from typing import Dict

from ..backend import WorkBackend, WorkCancelled, WorkError
from ..models import WorkRequest
from ..utils import nanocrypto as nc
from .schedule import DELAY, ERROR, HANG, WRONG_WORK, FaultSchedule


def invalid_work_for(block_hash: str, difficulty: int) -> str:
    """The first nonce whose value does NOT meet ``difficulty`` — a
    deterministic wrong answer regardless of how easy the target is."""
    nonce = 0
    while nc.work_value(block_hash, f"{nonce:016x}") >= difficulty:
        nonce += 1
    return f"{nonce:016x}"


class FaultyBackend(WorkBackend):
    def __init__(self, inner: WorkBackend, schedule: FaultSchedule, *, clock=None):
        from ..resilience.clock import SystemClock

        self.inner = inner
        self.schedule = schedule
        self.clock = clock or SystemClock()
        self._hangs: Dict[str, asyncio.Event] = {}

    async def setup(self) -> None:
        rule = self.schedule.decide("setup", "")
        if rule is not None and rule.action == ERROR:
            raise WorkError("chaos: injected setup failure")
        await self.inner.setup()

    async def close(self) -> None:
        await self.inner.close()

    async def generate(self, request: WorkRequest) -> str:
        block_hash = request.block_hash
        rule = self.schedule.decide("generate", block_hash)
        if rule is not None:
            if rule.action == ERROR:
                raise WorkError(f"chaos: injected failure for {block_hash}")
            if rule.action == HANG:
                event = self._hangs.setdefault(block_hash, asyncio.Event())
                try:
                    await event.wait()
                finally:
                    if self._hangs.get(block_hash) is event:
                        del self._hangs[block_hash]
                raise WorkCancelled(block_hash)
            if rule.action == WRONG_WORK:
                return invalid_work_for(block_hash, request.difficulty)
            if rule.action == DELAY:
                await self.clock.sleep(rule.delay)
        return await self.inner.generate(request)

    async def cancel(self, block_hash: str) -> None:
        event = self._hangs.get(block_hash)
        if event is not None:
            event.set()  # release the hung generate as WorkCancelled
        await self.inner.cancel(block_hash)

    async def raise_difficulty(self, block_hash: str, difficulty: int) -> bool:
        if block_hash in self._hangs:
            return False  # a hung scan cannot retarget
        return await self.inner.raise_difficulty(block_hash, difficulty)
