"""FaultyStore: fault injection at the state-store seam.

Wraps any :class:`~tpu_dpow_torch.store.Store`; before each operation the
schedule is consulted with op = the method name (``get``, ``set``,
``setnx``, ...; rules usually just use op ``"*"``) and subject = the key:

  error — raise ConnectionError, the exact shape DegradedStore treats as
          "backend unreachable" (so an outage script is: error times=N,
          recovery is the rule exhausting);
  delay — clock.sleep(rule.delay) first, then run the real op;
  hang  — clock.sleep(rule.delay or 3600) first: a wedged-but-connected
          backend, distinguishable from a refused connection.
"""

from __future__ import annotations

from typing import Dict, Optional

from ..store import Store
from .schedule import DELAY, ERROR, HANG, FaultSchedule


class FaultyStore(Store):
    def __init__(self, inner: Store, schedule: FaultSchedule, *, clock=None):
        from ..resilience.clock import SystemClock

        self.inner = inner
        self.schedule = schedule
        self.clock = clock or SystemClock()

    async def _guard(self, op: str, key: str) -> None:
        rule = self.schedule.decide(op, key)
        if rule is None:
            return
        if rule.action == ERROR:
            raise ConnectionError(f"chaos: injected {op} failure for {key!r}")
        if rule.action == DELAY:
            await self.clock.sleep(rule.delay)
        elif rule.action == HANG:
            await self.clock.sleep(rule.delay or 3600.0)

    async def setup(self) -> None:
        await self._guard("setup", "")
        await self.inner.setup()

    async def close(self) -> None:
        await self.inner.close()

    async def get(self, key: str):
        await self._guard("get", key)
        return await self.inner.get(key)

    async def set(self, key: str, value: str, expire: Optional[float] = None) -> None:
        await self._guard("set", key)
        return await self.inner.set(key, value, expire)

    async def setnx(self, key: str, value: str, expire: Optional[float] = None) -> bool:
        await self._guard("setnx", key)
        return await self.inner.setnx(key, value, expire)

    async def getset(self, key: str, value: str, expire: Optional[float] = None):
        await self._guard("getset", key)
        return await self.inner.getset(key, value, expire)

    async def delete(self, *keys: str) -> int:
        await self._guard("delete", keys[0] if keys else "")
        return await self.inner.delete(*keys)

    async def exists(self, key: str) -> bool:
        await self._guard("exists", key)
        return await self.inner.exists(key)

    async def incrby(self, key: str, amount: int = 1) -> int:
        await self._guard("incrby", key)
        return await self.inner.incrby(key, amount)

    async def hset(self, key: str, mapping: Dict[str, str]) -> None:
        await self._guard("hset", key)
        return await self.inner.hset(key, mapping)

    async def hget(self, key: str, field: str):
        await self._guard("hget", key)
        return await self.inner.hget(key, field)

    async def hgetall(self, key: str) -> Dict[str, str]:
        await self._guard("hgetall", key)
        return await self.inner.hgetall(key)

    async def hincrby(self, key: str, field: str, amount: int = 1) -> int:
        await self._guard("hincrby", key)
        return await self.inner.hincrby(key, field, amount)

    async def sadd(self, key: str, *members: str) -> None:
        await self._guard("sadd", key)
        return await self.inner.sadd(key, *members)

    async def srem(self, key: str, *members: str) -> None:
        await self._guard("srem", key)
        return await self.inner.srem(key, *members)

    async def smembers(self, key: str) -> set:
        await self._guard("smembers", key)
        return await self.inner.smembers(key)

    async def keys(self, pattern: str = "*") -> list:
        await self._guard("keys", pattern)
        return await self.inner.keys(pattern)
