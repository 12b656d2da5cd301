"""SQLite-backed Store: durable state with zero external dependencies.

The reference's durable state is Redis, an external C server the operator
must install and run (reference server/README.md:6, dpow/redis_db.py). The
rebuild's deployment ladder:

  * ``memory``          — in-process, optional JSON checkpoints (default);
  * ``sqlite:///path``  — THIS module: stdlib ``sqlite3``, full durability
    (every write committed), no extra process — right for single-server
    deployments that must survive restarts without operating Redis;
  * ``redis://...``     — drop-in for existing Redis deployments.

Same operation surface and key schema as the other stores (block:{hash},
account:{account}, service:{name}, client:{addr}, ... with TTLs — SURVEY.md
§5.4), so the server is oblivious to which it got.

Concurrency model: sqlite3 calls run on the event loop thread — each
operation is a few microseconds against a local file, far below this
store's call rates; the GIL-released filesystem commit is the only real
cost. TTLs are stored as absolute unix deadlines, filtered on read and
swept opportunistically.
"""

from __future__ import annotations

import fnmatch
import sqlite3
import time
from typing import Dict, Optional

from . import Store

_SCHEMA = """
CREATE TABLE IF NOT EXISTS kv (
    key TEXT PRIMARY KEY,
    value TEXT NOT NULL,
    expires_at REAL
);
CREATE TABLE IF NOT EXISTS hashes (
    key TEXT NOT NULL,
    field TEXT NOT NULL,
    value TEXT NOT NULL,
    PRIMARY KEY (key, field)
);
CREATE TABLE IF NOT EXISTS sets_ (
    key TEXT NOT NULL,
    member TEXT NOT NULL,
    PRIMARY KEY (key, member)
);
"""

_SWEEP_EVERY = 256  # opportunistic expired-row sweep cadence (writes)


class SqliteStore(Store):
    def __init__(self, path: str = "tpu_dpow.db"):
        self.path = path
        self._db: Optional[sqlite3.Connection] = None
        self._writes = 0

    async def setup(self) -> None:
        if self._db is not None:
            return  # idempotent: server setup() may run after a caller's
        # dpowlint: disable=DPOW201 — one-time local-file open at startup; the connection must be born on the loop thread it serves (check_same_thread)
        self._db = sqlite3.connect(self.path)
        self._db.executescript(_SCHEMA)
        # WAL: readers never block the writer; fits the single-writer
        # asyncio process with ops CLIs peeking at the same file.
        self._db.execute("PRAGMA journal_mode=WAL")
        # LIKE is ASCII-case-insensitive by default, but keys() uses it as
        # a prefix filter that must match the case-SENSITIVE fnmatch
        # fallback and the Memory/Redis stores — e.g. two replica ids
        # differing only by case must not read each other's journal slice.
        self._db.execute("PRAGMA case_sensitive_like=ON")
        self._db.commit()

    async def close(self) -> None:
        if self._db is not None:
            self._db.commit()
            self._db.close()
            self._db = None

    # -- helpers ---------------------------------------------------------

    def _commit(self) -> None:
        self._db.commit()
        self._writes += 1
        if self._writes % _SWEEP_EVERY == 0:
            self.sweep()

    def _begin_immediate(self) -> None:
        """Take the WRITE lock before reading: the read-modify-write ops
        (incrby, setnx, hincrby) are the atomic primitives the replica
        ring's epoch allocator, adoption election, and quota ledger rest
        on, and several server PROCESSES may share one sqlite file
        (docs/replication.md). Within one process the single event loop
        already serializes them; across processes two connections can both
        read the same prior state under DEFERRED isolation and lose an
        update — observed as two replicas allocating the SAME epoch.
        BEGIN IMMEDIATE serializes at the database (WAL + the stdlib's
        default 5 s busy timeout handles contention)."""
        if not self._db.in_transaction:
            self._db.execute("BEGIN IMMEDIATE")

    def sweep(self) -> int:
        """Purge expired kv rows; returns how many were removed."""
        cur = self._db.execute(
            "DELETE FROM kv WHERE expires_at IS NOT NULL AND expires_at <= ?",
            (time.time(),),
        )
        self._db.commit()
        return cur.rowcount

    def _get_row(self, key: str):
        row = self._db.execute(
            "SELECT value, expires_at FROM kv WHERE key = ?", (key,)
        ).fetchone()
        if row is None:
            return None
        value, expires_at = row
        if expires_at is not None and expires_at <= time.time():
            self._db.execute("DELETE FROM kv WHERE key = ?", (key,))
            self._db.commit()
            return None
        return value

    @staticmethod
    def _deadline(expire: Optional[float]) -> Optional[float]:
        return time.time() + expire if expire is not None else None

    def _expect_type(self, key: str, table: str) -> None:
        """MemoryStore/Redis parity: one key, one type — a string op on a
        hash key (or any cross-type mix) must raise, not fork the key into
        parallel lives in two tables. Expired-but-unswept kv rows do not
        count (MemoryStore parity: an expired key is simply gone)."""
        others = {"kv": "string", "hashes": "hash", "sets_": "set"}
        now = time.time()
        for t, name in others.items():
            if t == table:
                continue
            if t == "kv":
                row = self._db.execute(
                    "SELECT 1 FROM kv WHERE key = ? AND "
                    "(expires_at IS NULL OR expires_at > ?) LIMIT 1",
                    (key, now),
                ).fetchone()
            else:
                row = self._db.execute(
                    f"SELECT 1 FROM {t} WHERE key = ? LIMIT 1", (key,)
                ).fetchone()
            if row is not None:
                raise TypeError(f"{key!r} holds a {name}, wrong operation type")

    # -- kv --------------------------------------------------------------

    async def get(self, key: str) -> Optional[str]:
        # Reads enforce the one-key-one-type rule too (MemoryStore raises on
        # get of a hash key; Redis raises WRONGTYPE even for reads).
        self._expect_type(key, "kv")
        return self._get_row(key)

    async def set(self, key: str, value: str, expire: Optional[float] = None) -> None:
        self._expect_type(key, "kv")
        self._db.execute(
            "INSERT INTO kv (key, value, expires_at) VALUES (?, ?, ?) "
            "ON CONFLICT(key) DO UPDATE SET value = excluded.value, "
            "expires_at = excluded.expires_at",
            (key, value, self._deadline(expire)),
        )
        self._commit()

    async def setnx(self, key: str, value: str, expire: Optional[float] = None) -> bool:
        self._begin_immediate()
        try:
            self._expect_type(key, "kv")
            # Liveness checked in SQL, NOT via _get_row: its lazy
            # expired-row DELETE commits, which would end the IMMEDIATE
            # transaction and let a concurrent process win the same
            # election before our INSERT. The upsert below overwrites an
            # expired row, so it needs no delete first.
            row = self._db.execute(
                "SELECT 1 FROM kv WHERE key = ? AND "
                "(expires_at IS NULL OR expires_at > ?) LIMIT 1",
                (key, time.time()),
            ).fetchone()
            if row is not None:
                self._db.rollback()
                return False
            self._db.execute(
                "INSERT INTO kv (key, value, expires_at) VALUES (?, ?, ?) "
                "ON CONFLICT(key) DO UPDATE SET value = excluded.value, "
                "expires_at = excluded.expires_at",
                (key, value, self._deadline(expire)),
            )
        except BaseException:
            self._db.rollback()
            raise
        self._commit()
        return True

    async def getset(self, key: str, value: str, expire: Optional[float] = None) -> Optional[str]:
        self._begin_immediate()
        try:
            self._expect_type(key, "kv")
            # Liveness in SQL, not _get_row: its lazy expired-row DELETE
            # commits, ending the IMMEDIATE transaction mid-swap (the same
            # hazard setnx documents). An expired row reads as None and
            # the upsert below overwrites it either way.
            row = self._db.execute(
                "SELECT value FROM kv WHERE key = ? AND "
                "(expires_at IS NULL OR expires_at > ?) LIMIT 1",
                (key, time.time()),
            ).fetchone()
            old = row[0] if row else None
            self._db.execute(
                "INSERT INTO kv (key, value, expires_at) VALUES (?, ?, ?) "
                "ON CONFLICT(key) DO UPDATE SET value = excluded.value, "
                "expires_at = excluded.expires_at",
                (key, value, self._deadline(expire)),
            )
        except BaseException:
            self._db.rollback()
            raise
        self._commit()
        return old

    async def delete(self, *keys: str) -> int:
        n = 0
        for key in keys:
            removed = False
            if self._get_row(key) is not None:
                self._db.execute("DELETE FROM kv WHERE key = ?", (key,))
                removed = True
            if self._db.execute("DELETE FROM hashes WHERE key = ?", (key,)).rowcount:
                removed = True
            if self._db.execute("DELETE FROM sets_ WHERE key = ?", (key,)).rowcount:
                removed = True
            n += int(removed)
        self._commit()
        return n

    async def exists(self, key: str) -> bool:
        # Any-type existence (Redis EXISTS / MemoryStore _alive parity):
        # a key holding a hash or set exists just as much as a string key.
        if self._get_row(key) is not None:
            return True
        for t in ("hashes", "sets_"):
            if self._db.execute(
                f"SELECT 1 FROM {t} WHERE key = ? LIMIT 1", (key,)
            ).fetchone():
                return True
        return False

    async def incrby(self, key: str, amount: int = 1) -> int:
        self._begin_immediate()
        try:
            self._expect_type(key, "kv")
            row = self._db.execute(
                "SELECT value, expires_at FROM kv WHERE key = ?", (key,)
            ).fetchone()
            now = time.time()
            if row is None or (row[1] is not None and row[1] <= now):
                current, deadline = 0, None
            else:
                current, deadline = int(row[0]), row[1]  # TTL preserved (Redis INCRBY)
            new = current + amount
            self._db.execute(
                "INSERT INTO kv (key, value, expires_at) VALUES (?, ?, ?) "
                "ON CONFLICT(key) DO UPDATE SET value = excluded.value, "
                "expires_at = excluded.expires_at",
                (key, str(new), deadline),
            )
        except BaseException:
            self._db.rollback()
            raise
        self._commit()
        return new

    # -- hashes ----------------------------------------------------------

    async def hset(self, key: str, mapping: Dict[str, str]) -> None:
        self._expect_type(key, "hashes")
        for field, value in mapping.items():
            self._db.execute(
                "INSERT INTO hashes (key, field, value) VALUES (?, ?, ?) "
                "ON CONFLICT(key, field) DO UPDATE SET value = excluded.value",
                (key, field, str(value)),
            )
        self._commit()

    async def hget(self, key: str, field: str) -> Optional[str]:
        self._expect_type(key, "hashes")
        row = self._db.execute(
            "SELECT value FROM hashes WHERE key = ? AND field = ?", (key, field)
        ).fetchone()
        return row[0] if row else None

    async def hgetall(self, key: str) -> Dict[str, str]:
        self._expect_type(key, "hashes")
        return dict(
            self._db.execute(
                "SELECT field, value FROM hashes WHERE key = ?", (key,)
            ).fetchall()
        )

    async def hincrby(self, key: str, field: str, amount: int = 1) -> int:
        self._begin_immediate()
        try:
            current = await self.hget(key, field)
            new = int(current or 0) + amount
            await self.hset(key, {field: str(new)})
        except BaseException:
            self._db.rollback()
            raise
        return new

    # -- sets ------------------------------------------------------------

    async def sadd(self, key: str, *members: str) -> None:
        self._expect_type(key, "sets_")
        for m in members:
            self._db.execute(
                "INSERT OR IGNORE INTO sets_ (key, member) VALUES (?, ?)", (key, m)
            )
        self._commit()

    async def srem(self, key: str, *members: str) -> None:
        self._expect_type(key, "sets_")
        for m in members:
            self._db.execute(
                "DELETE FROM sets_ WHERE key = ? AND member = ?", (key, m)
            )
        self._commit()

    async def smembers(self, key: str) -> set:
        self._expect_type(key, "sets_")
        return {
            row[0]
            for row in self._db.execute(
                "SELECT member FROM sets_ WHERE key = ?", (key,)
            ).fetchall()
        }

    # -- keys ------------------------------------------------------------

    async def keys(self, pattern: str = "*") -> list:
        now = time.time()
        # Pure-prefix patterns ("replica:member:*") are filtered in SQL:
        # the replica registry polls read_members every heartbeat tick per
        # replica against the shared production store, and a Python-side
        # fnmatch over every key is O(total store keys) per tick — the
        # store is expected to hold millions of block:*/account:* rows.
        prefix = pattern[:-1] if pattern.endswith("*") else None
        if prefix is not None and not any(c in prefix for c in "*?["):
            like = (
                prefix.replace("\\", "\\\\")
                .replace("%", "\\%")
                .replace("_", "\\_")
                + "%"
            )
            out = {
                row[0]
                for row in self._db.execute(
                    "SELECT key FROM kv WHERE key LIKE ? ESCAPE '\\' "
                    "AND (expires_at IS NULL OR expires_at > ?)",
                    (like, now),
                ).fetchall()
            }
            for table in ("hashes", "sets_"):
                out.update(
                    r[0]
                    for r in self._db.execute(
                        f"SELECT DISTINCT key FROM {table} "
                        "WHERE key LIKE ? ESCAPE '\\'",
                        (like,),
                    )
                )
            return list(out)
        out = {
            row[0]
            for row in self._db.execute(
                "SELECT key FROM kv WHERE expires_at IS NULL OR expires_at > ?",
                (now,),
            ).fetchall()
        }
        out.update(r[0] for r in self._db.execute("SELECT DISTINCT key FROM hashes"))
        out.update(r[0] for r in self._db.execute("SELECT DISTINCT key FROM sets_"))
        return [k for k in out if fnmatch.fnmatchcase(k, pattern)]
