"""Redis-backed Store.

Deployment parity with the reference's aioredis pool (reference
server/dpow/redis_db.py:12-16): same operation surface as MemoryStore, so the
server code is oblivious to which one it got.

The ``redis`` package import is deferred to :meth:`setup` and the client is
injectable, so the full Store contract suite runs against this class through
an in-process fake (tests/fake_redis.py) even where no redis package or
server exists — the get/setnx/hincrby/TTL semantics the server depends on
are pinned for all three store implementations.
"""

from __future__ import annotations

from typing import Dict, Optional

from . import Store


def _translate_wrongtype(e: Exception) -> None:
    """Re-raise redis WRONGTYPE as the Store contract's TypeError.

    MemoryStore/SqliteStore raise TypeError when an op hits a key of
    another kind; server code relying on that must see the same class from
    a redis deployment (drop-in parity includes error behavior).
    """
    if "WRONGTYPE" in str(e):
        raise TypeError(str(e)) from e
    raise


class RedisStore(Store):
    def __init__(
        self,
        uri: str = "redis://localhost",
        *,
        pool_size: int = 15,
        client=None,  # injectable redis.asyncio-compatible client (tests)
    ):
        self._uri = uri
        self._pool_size = pool_size
        self._client_override = client
        self._redis = None

    async def setup(self) -> None:
        if self._client_override is not None:
            self._redis = self._client_override
        else:  # pragma: no cover - needs the redis package + a live server
            try:
                import redis.asyncio as aredis
            except ImportError as e:
                raise ImportError(
                    "RedisStore requires the 'redis' package (pip install redis)"
                ) from e
            self._redis = aredis.from_url(
                self._uri, max_connections=self._pool_size, decode_responses=True
            )
        await self._redis.ping()

    async def close(self) -> None:
        # Detach-then-await (dpowlint DPOW801): a concurrent close() must
        # find the slot empty instead of double-closing the pool.
        redis, self._redis = self._redis, None
        if redis is not None:
            await redis.aclose()

    async def _c(self, coro):
        """Await a redis op, translating WRONGTYPE into TypeError."""
        try:
            return await coro
        except (TypeError, AttributeError):
            raise
        except Exception as e:
            _translate_wrongtype(e)

    async def get(self, key: str) -> Optional[str]:
        return await self._c(self._redis.get(key))

    @staticmethod
    def _px(expire: Optional[float]) -> Optional[int]:
        """Float-seconds TTL → redis px milliseconds.

        The Store contract takes float seconds (sub-second TTLs included —
        the suite pins expire=0.05); ex=int(expire) truncated those to 0,
        which Redis rejects outright. Clamp to >=1 ms.
        """
        if expire is None:
            return None
        # expire=0 must behave as already-expired (MemoryStore/Sqlite
        # parity: deadline = now+0), not as "no TTL": clamp to 1 ms.
        return max(1, int(expire * 1000))

    async def set(self, key: str, value: str, expire: Optional[float] = None) -> None:
        await self._c(self._redis.set(key, value, px=self._px(expire)))

    async def setnx(self, key: str, value: str, expire: Optional[float] = None) -> bool:
        ok = await self._c(self._redis.set(key, value, nx=True, px=self._px(expire)))
        return bool(ok)

    async def getset(self, key: str, value: str, expire: Optional[float] = None) -> Optional[str]:
        # SET ... GET (redis >= 6.2) is the atomic swap; the deprecated
        # GETSET command has no TTL argument.
        return await self._c(
            self._redis.set(key, value, px=self._px(expire), get=True)
        )

    async def delete(self, *keys: str) -> int:
        return await self._c(self._redis.delete(*keys))

    async def exists(self, key: str) -> bool:
        return bool(await self._c(self._redis.exists(key)))

    async def incrby(self, key: str, amount: int = 1) -> int:
        return await self._c(self._redis.incrby(key, amount))

    async def hset(self, key: str, mapping: Dict[str, str]) -> None:
        await self._c(self._redis.hset(key, mapping=mapping))

    async def hget(self, key: str, field: str) -> Optional[str]:
        return await self._c(self._redis.hget(key, field))

    async def hgetall(self, key: str) -> Dict[str, str]:
        return await self._c(self._redis.hgetall(key))

    async def hincrby(self, key: str, field: str, amount: int = 1) -> int:
        return await self._c(self._redis.hincrby(key, field, amount))

    async def sadd(self, key: str, *members: str) -> None:
        await self._c(self._redis.sadd(key, *members))

    async def srem(self, key: str, *members: str) -> None:
        await self._c(self._redis.srem(key, *members))

    async def smembers(self, key: str) -> set:
        return set(await self._c(self._redis.smembers(key)))

    async def keys(self, pattern: str = "*") -> list:
        # SCAN, never KEYS: the replica registry polls this every
        # heartbeat tick against the shared production store, and KEYS is
        # a single blocking O(total-keyspace) walk that stalls every other
        # client for its duration. SCAN amortizes the same walk into
        # bounded steps the server interleaves with real traffic.
        out = []
        async for key in self._redis.scan_iter(match=pattern, count=500):
            out.append(key)
        return out
