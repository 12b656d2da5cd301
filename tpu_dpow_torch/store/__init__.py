"""Async state store: the rebuild's Redis seam.

The port's own copy of ``tpu_dpow/store/``, with the same class, function,
metric family and label names; only the imports point at tpu_dpow_torch.

The reference keeps ALL durable state in Redis behind a thin async wrapper
(reference server/dpow/redis_db.py:9-105): block→work mappings with TTLs,
account frontiers, the winner-election setnx lock, per-client work counters,
and service records. This module defines the same operation surface as an
injectable protocol with two implementations:

  * :class:`MemoryStore` — in-process, TTL-correct, with JSON
    snapshot/restore (the checkpoint/resume capability; the reference's
    equivalent is "all state lives in Redis", SURVEY.md §5.4). This is also
    the test seam the reference never had.
  * :class:`~tpu_dpow_torch.store.redis_store.RedisStore` — real Redis, gated on
    the ``redis`` package being installed.
  * :class:`~tpu_dpow_torch.store.degraded.DegradedStore` — availability wrapper
    (``degraded+`` URI prefix): serves from an in-memory fallback while the
    primary's backend is unreachable, journals writes, reconciles on
    recovery (the resilience layer's store seam, docs/resilience.md).

Key schema parity (reference dpow_server.py:142,193-205,289,308-319;
scripts/services.py:97-102):
  block:{hash} → work hex or the pending marker    (TTL block_expiry)
  block-lock:{hash} → winner election lock         (TTL 5 s)
  block-difficulty:{hash} → hex difficulty         (TTL 120 s)
  work-type:{hash} → precache|ondemand             (TTL block_expiry)
  account:{account} → frontier hash                (TTL account_expiry)
  client:{addr} → hash of counters; clients set
  service:{name} → hash of service record; services set
  stats:{precache,ondemand} → totals
"""

from __future__ import annotations

import abc
import asyncio
import fnmatch
import json
import os
import time
from typing import Callable, Dict, Iterable, Optional


class Store(abc.ABC):
    """Flat async key/value + hash + set store with TTLs."""

    async def setup(self) -> None:
        return None

    async def close(self) -> None:
        return None

    # strings ----------------------------------------------------------
    @abc.abstractmethod
    async def get(self, key: str) -> Optional[str]: ...

    @abc.abstractmethod
    async def set(self, key: str, value: str, expire: Optional[float] = None) -> None: ...

    @abc.abstractmethod
    async def setnx(self, key: str, value: str, expire: Optional[float] = None) -> bool:
        """Set iff absent (the winner-election lock, reference
        redis_db.py:60-70 / dpow_server.py:138). Returns True if we won."""

    @abc.abstractmethod
    async def getset(self, key: str, value: str, expire: Optional[float] = None) -> Optional[str]:
        """Atomic swap: set the key and return the PREVIOUS live value
        (None if absent/expired). The account-frontier advance rests on
        this (server block_arrival path): get-then-set across awaits is a
        cross-replica lost-update window, and whichever replica's swap
        returns a given old frontier is the exactly-one owner of retiring
        it."""

    @abc.abstractmethod
    async def delete(self, *keys: str) -> int: ...

    @abc.abstractmethod
    async def exists(self, key: str) -> bool: ...

    @abc.abstractmethod
    async def incrby(self, key: str, amount: int = 1) -> int: ...

    # hashes -----------------------------------------------------------
    @abc.abstractmethod
    async def hset(self, key: str, mapping: Dict[str, str]) -> None: ...

    @abc.abstractmethod
    async def hget(self, key: str, field: str) -> Optional[str]: ...

    @abc.abstractmethod
    async def hgetall(self, key: str) -> Dict[str, str]: ...

    @abc.abstractmethod
    async def hincrby(self, key: str, field: str, amount: int = 1) -> int: ...

    # sets -------------------------------------------------------------
    @abc.abstractmethod
    async def sadd(self, key: str, *members: str) -> None: ...

    @abc.abstractmethod
    async def srem(self, key: str, *members: str) -> None: ...

    @abc.abstractmethod
    async def smembers(self, key: str) -> set: ...

    # scanning ---------------------------------------------------------
    @abc.abstractmethod
    async def keys(self, pattern: str = "*") -> list: ...


class MemoryStore(Store):
    """Dict-backed store with real TTL semantics and snapshot/restore.

    TTLs use an injectable clock so tests can drive expiry deterministically
    instead of sleeping.

    ``shared=True`` marks ONE instance deliberately handed to several
    embedded servers in the same process (replica tests, benchmarks): a
    replicated DpowServer refuses a plain MemoryStore at construction —
    per-process memory would split the quota ledger and replica registry —
    but a shared instance IS a shared store (docs/replication.md).
    """

    def __init__(self, clock: Callable[[], float] = time.monotonic, shared: bool = False):
        self._clock = clock
        self.shared = shared
        self._data: Dict[str, object] = {}
        self._expiry: Dict[str, float] = {}
        self._lock = asyncio.Lock()

    # -- expiry --------------------------------------------------------

    def _alive(self, key: str) -> bool:
        deadline = self._expiry.get(key)
        if deadline is not None and self._clock() >= deadline:
            self._data.pop(key, None)
            self._expiry.pop(key, None)
            return False
        return key in self._data

    def _set_expiry(self, key: str, expire: Optional[float]) -> None:
        if expire is None:
            self._expiry.pop(key, None)
        else:
            self._expiry[key] = self._clock() + expire

    def sweep(self) -> int:
        """Drop every expired key; returns how many were removed."""
        dead = [k for k in list(self._data) if not self._alive(k)]
        return len(dead)

    # -- strings -------------------------------------------------------

    async def get(self, key: str) -> Optional[str]:
        if not self._alive(key):
            return None
        value = self._data[key]
        if not isinstance(value, str):
            raise TypeError(f"{key} holds {type(value).__name__}, not string")
        return value

    async def set(self, key: str, value: str, expire: Optional[float] = None) -> None:
        async with self._lock:
            self._data[key] = str(value)
            self._set_expiry(key, expire)

    async def setnx(self, key: str, value: str, expire: Optional[float] = None) -> bool:
        async with self._lock:
            if self._alive(key):
                return False
            self._data[key] = str(value)
            self._set_expiry(key, expire)
            return True

    async def getset(self, key: str, value: str, expire: Optional[float] = None) -> Optional[str]:
        async with self._lock:
            old = None
            if self._alive(key):
                prior = self._data[key]
                if not isinstance(prior, str):
                    raise TypeError(f"{key} holds {type(prior).__name__}, not string")
                old = prior
            self._data[key] = str(value)
            self._set_expiry(key, expire)
            return old

    async def delete(self, *keys: str) -> int:
        removed = 0
        async with self._lock:
            for key in keys:
                if self._alive(key):
                    removed += 1
                self._data.pop(key, None)
                self._expiry.pop(key, None)
        return removed

    async def exists(self, key: str) -> bool:
        return self._alive(key)

    async def incrby(self, key: str, amount: int = 1) -> int:
        async with self._lock:
            current = int(self._data[key]) if self._alive(key) else 0
            current += amount
            self._data[key] = str(current)
            return current

    # -- hashes --------------------------------------------------------

    def _hash(self, key: str) -> Dict[str, str]:
        if not self._alive(key):
            self._data[key] = {}
        value = self._data[key]
        if not isinstance(value, dict):
            raise TypeError(f"{key} holds {type(value).__name__}, not hash")
        return value

    async def hset(self, key: str, mapping: Dict[str, str]) -> None:
        async with self._lock:
            self._hash(key).update({k: str(v) for k, v in mapping.items()})

    async def hget(self, key: str, field: str) -> Optional[str]:
        if not self._alive(key):
            return None
        return self._hash(key).get(field)

    async def hgetall(self, key: str) -> Dict[str, str]:
        if not self._alive(key):
            return {}
        return dict(self._hash(key))

    async def hincrby(self, key: str, field: str, amount: int = 1) -> int:
        async with self._lock:
            h = self._hash(key)
            value = int(h.get(field, "0")) + amount
            h[field] = str(value)
            return value

    # -- sets ----------------------------------------------------------

    def _setval(self, key: str) -> set:
        if not self._alive(key):
            self._data[key] = set()
        value = self._data[key]
        if not isinstance(value, set):
            raise TypeError(f"{key} holds {type(value).__name__}, not set")
        return value

    async def sadd(self, key: str, *members: str) -> None:
        async with self._lock:
            self._setval(key).update(str(m) for m in members)

    async def srem(self, key: str, *members: str) -> None:
        async with self._lock:
            self._setval(key).difference_update(members)

    async def smembers(self, key: str) -> set:
        if not self._alive(key):
            return set()
        return set(self._setval(key))

    async def keys(self, pattern: str = "*") -> list:
        return [k for k in list(self._data) if self._alive(k) and fnmatch.fnmatchcase(k, pattern)]

    # -- checkpoint / resume ------------------------------------------

    def snapshot(self) -> str:
        """Serialize live state (with remaining TTLs) to a JSON string."""
        now = self._clock()
        entries = []
        for key in list(self._data):
            if not self._alive(key):
                continue
            value = self._data[key]
            if isinstance(value, set):
                kind, payload = "set", sorted(value)
            elif isinstance(value, dict):
                kind, payload = "hash", value
            else:
                kind, payload = "str", value
            ttl = self._expiry.get(key)
            entries.append(
                {
                    "key": key,
                    "kind": kind,
                    "value": payload,
                    "ttl": None if ttl is None else max(ttl - now, 0.0),
                }
            )
        return json.dumps({"version": 1, "entries": entries})

    def restore(self, blob: str) -> None:
        """Make the store exactly the snapshot's state (replace, not merge)."""
        data = json.loads(blob)
        now = self._clock()
        self._data.clear()
        self._expiry.clear()
        for entry in data["entries"]:
            key, kind, value = entry["key"], entry["kind"], entry["value"]
            if kind == "set":
                self._data[key] = set(value)
            elif kind == "hash":
                self._data[key] = dict(value)
            else:
                self._data[key] = str(value)
            if entry["ttl"] is not None:
                self._expiry[key] = now + entry["ttl"]

    def save(self, path: str) -> None:
        atomic_write(path, self.snapshot())

    def load(self, path: str) -> None:
        with open(path) as f:
            self.restore(f.read())


def atomic_write(path: str, blob: str) -> None:
    """Durable atomic replace: a crash/ENOSPC mid-write must never truncate
    the only durable copy (the periodic checkpoint overwrites in place).

    Split out of :meth:`MemoryStore.save` so the server can take the
    snapshot ON the event loop (atomic w.r.t. coroutines — snapshot()
    iterates live dicts) and push only this blocking fsync'd write to a
    thread.
    """
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        f.write(blob)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def get_store(uri: Optional[str] = None, **kwargs) -> Store:
    """'memory' / None → MemoryStore; 'sqlite:///path' → SqliteStore
    (durable, stdlib-only); 'redis://...' → RedisStore (if installed).

    A ``degraded+`` prefix (e.g. ``degraded+redis://host``) wraps the inner
    store in :class:`~tpu_dpow_torch.store.degraded.DegradedStore`: on connection
    errors the stack keeps serving from an in-memory fallback, journaling
    writes and reconciling them when the backend returns.
    """
    if uri is not None and uri.startswith("degraded+"):
        from .degraded import DegradedStore

        return DegradedStore(get_store(uri[len("degraded+"):], **kwargs))
    if uri is None or uri == "memory":
        return MemoryStore(**kwargs)
    if uri.startswith("sqlite://"):
        from .sqlite_store import SqliteStore

        # sqlite:///abs/path.db → "/abs/path.db"; sqlite://rel.db → "rel.db"
        return SqliteStore(uri[len("sqlite://"):] or "tpu_dpow.db", **kwargs)
    if uri.startswith("redis://"):
        from .redis_store import RedisStore

        return RedisStore(uri, **kwargs)
    raise ValueError(f"unknown store uri: {uri!r}")


# Deferred import: DegradedStore's module imports names defined above.
from .degraded import DegradedStore  # noqa: E402, F401
