"""DegradedStore: keep serving when the primary store's backend is gone.

The reference hub dies with Redis — every handler awaits redis_db and an
outage turns into a stack of 500s (reference dpow_server.py has no fallback
path). This wrapper keeps the orchestrator alive through a store outage:

  * healthy: every op goes to the primary (e.g. RedisStore); MUTATIONS are
    additionally MIRRORED into the fallback (best-effort, in-memory, so
    the hot state — service auth records, pending blocks, counters — is
    already present if the primary dies mid-flight);
  * a CONNECTION-shaped failure flips the store into DEGRADED mode: reads
    and writes are served by the in-memory fallback, and every MUTATING op
    is also journaled (bounded queue, oldest dropped first);
  * while degraded, at most once per ``probe_interval`` an op triggers a
    cheap probe of the primary; the first successful probe REPLAYS the
    journal into the primary (reconciliation) and exits degraded mode.

Semantics under degradation are deliberately availability-over-consistency:
state that never passed through this wrapper (written by another process,
or predating it) is invisible until recovery, and winner election holds
per-process rather than globally — but the service keeps answering, and
anything THIS process wrote survives into degraded mode via the mirror.
Counter mutations (incrby/hincrby) journal their deltas, so reconciliation
adds them onto whatever the primary already held.

Mode and queue depth are exported via obs:
  dpow_store_degraded                      gauge: 1 while degraded
  dpow_store_degraded_transitions_total{to}  enter | recover
  dpow_store_journal_depth                 gauge: queued writes
  dpow_store_journal_dropped_total         writes shed at the bound
"""

from __future__ import annotations

from collections import deque
from typing import Dict, Optional, Tuple

from .. import obs
from ..utils.logging import get_logger
from . import MemoryStore, Store

logger = get_logger("tpu_dpow_torch.store")


def default_connection_errors() -> Tuple[type, ...]:
    """Exception types that mean "the store's backend is unreachable"
    (never data/type errors — those must surface). OSError covers the
    socket family incl. ConnectionError; redis's errors don't subclass it."""
    errors = [OSError, TimeoutError]
    try:  # redis is optional in this environment
        from redis import exceptions as _rex

        errors += [_rex.ConnectionError, _rex.TimeoutError]
    except Exception:
        pass
    return tuple(errors)


class DegradedStore(Store):
    def __init__(
        self,
        primary: Store,
        fallback: Optional[Store] = None,
        *,
        probe_interval: float = 5.0,
        max_journal: int = 10_000,
        reconcile_batch: int = 128,
        errors: Optional[Tuple[type, ...]] = None,
        clock=None,
    ):
        from ..resilience.clock import SystemClock

        self.primary = primary
        self.fallback = fallback if fallback is not None else MemoryStore()
        self.probe_interval = probe_interval
        self.max_journal = max_journal
        self.reconcile_batch = reconcile_batch
        self.errors = errors or default_connection_errors()
        self.clock = clock or SystemClock()
        self.degraded = False
        # (method, args) mutating ops, oldest first. A deque: the drain
        # popleft()s and the overflow shed drops from the left — a list
        # would shift up to max_journal entries per op on the hot path.
        self._journal: deque = deque()
        self._last_probe = float("-inf")
        self._draining = False  # probe succeeded; journal mid-replay
        self._reconciling = False  # a drain burst is already in flight
        reg = obs.get_registry()
        self._m_degraded = reg.gauge(
            "dpow_store_degraded", "1 while serving from the fallback store")
        self._m_transitions = reg.counter(
            "dpow_store_degraded_transitions_total",
            "Degraded-mode transitions", ("to",))
        self._m_journal_depth = reg.gauge(
            "dpow_store_journal_depth", "Writes queued for reconciliation")
        self._m_journal_dropped = reg.counter(
            "dpow_store_journal_dropped_total",
            "Journaled writes shed because the queue hit its bound")
        self._m_degraded.set(0.0)

    # -- mode transitions ---------------------------------------------

    def _enter_degraded(self, cause: BaseException) -> None:
        if self.degraded:
            return
        self.degraded = True
        self._draining = False
        self._last_probe = self.clock.time()  # just failed; wait a full interval
        self._m_degraded.set(1.0)
        self._m_transitions.inc(1, "enter")
        logger.error(
            "primary store unreachable (%s: %s); DEGRADED — serving from "
            "fallback, journaling writes", type(cause).__name__, cause,
        )

    async def _maybe_recover(self) -> None:
        if self._reconciling:
            # Another op's probe/drain is mid-flight. Entering _reconcile
            # concurrently would replay the same journal head twice and
            # pop an entry the second replay never ran — losing exactly
            # the writes the journal protects. Serve from the fallback;
            # the in-flight burst does the bookkeeping.
            return
        if not self._draining:
            now = self.clock.time()
            if now - self._last_probe < self.probe_interval:
                return
            self._last_probe = now
        self._reconciling = True
        try:
            if not self._draining:
                try:
                    await self.primary.exists("__degraded_probe__")
                except self.errors:
                    return  # still down; next probe a full interval away
                # dpowlint: disable=DPOW801 — the _reconciling latch (set with no await after its check) serializes this whole block; no second coroutine can be in here
                self._draining = True
            # dpowlint: disable=DPOW801 — same latch: only one drain burst can be in flight
            await self._reconcile()
        finally:
            # dpowlint: disable=DPOW801 — only the latch holder reaches here
            self._reconciling = False

    async def _reconcile(self) -> None:
        """Replay the journal into the recovered primary, oldest first —
        at most ``reconcile_batch`` writes per call. A long outage's
        journal (up to ``max_journal`` entries) must not stall whichever
        unlucky request happened to trigger the successful probe; the
        drain is amortized across subsequent ops (each continues it
        without waiting out another probe interval) and degraded mode
        ends when the journal is empty."""
        replayed = 0
        while self._journal and replayed < self.reconcile_batch:
            method, args = self._journal[0]
            try:
                await getattr(self.primary, method)(*args)
            except self.errors as e:
                # Relapsed mid-replay: stay degraded, keep the remainder,
                # go back to probing.
                self._draining = False
                self._m_journal_depth.set(len(self._journal))
                logger.warning(
                    "store recovery aborted after %d replayed writes: %s",
                    replayed, e,
                )
                return
            except Exception as e:
                # A write the primary now refuses (e.g. type clash) must not
                # wedge recovery behind it forever.
                logger.warning("journaled %s%r dropped on replay: %s",
                               method, args, e)
            # dpowlint: disable=DPOW801 — _maybe_recover's _reconciling latch serializes _reconcile; concurrent ops only APPEND to the journal, so the replayed head entry is still index 0 when this pops it
            self._journal.popleft()
            replayed += 1
        self._m_journal_depth.set(len(self._journal))
        if self._journal:
            return  # burst exhausted; the next op continues the drain
        self._draining = False
        self.degraded = False
        self._m_degraded.set(0.0)
        self._m_transitions.inc(1, "recover")
        logger.info("primary store recovered; journal drained (last burst "
                    "replayed %d writes)", replayed)

    def _journal_op(self, method: str, args: tuple) -> None:
        self._journal.append((method, args))
        dropped = 0
        while len(self._journal) > self.max_journal:
            self._journal.popleft()
            dropped += 1
        if dropped:
            self._m_journal_dropped.inc(dropped)
        self._m_journal_depth.set(len(self._journal))

    async def _call(self, method: str, args: tuple, mutating: bool):
        if self.degraded:
            await self._maybe_recover()
        if not self.degraded:
            try:
                result = await getattr(self.primary, method)(*args)
            except self.errors as e:
                self._enter_degraded(e)
            else:
                if mutating:
                    # Keep the fallback warm while healthy: if the primary
                    # dies mid-flight, everything this process wrote is
                    # already there. Best-effort — the mirror must never
                    # break a healthy-path op.
                    try:
                        await getattr(self.fallback, method)(*args)
                    except Exception:
                        pass
                return result
        if mutating:
            self._journal_op(method, args)
        return await getattr(self.fallback, method)(*args)

    # -- lifecycle -----------------------------------------------------

    async def setup(self) -> None:
        await self.fallback.setup()
        try:
            await self.primary.setup()
        except self.errors as e:
            self._enter_degraded(e)

    async def close(self) -> None:
        try:
            await self.primary.close()
        except self.errors:
            pass
        await self.fallback.close()

    # -- strings ---------------------------------------------------------

    async def get(self, key: str):
        return await self._call("get", (key,), mutating=False)

    async def set(self, key: str, value: str, expire=None) -> None:
        return await self._call("set", (key, value, expire), mutating=True)

    async def setnx(self, key: str, value: str, expire=None) -> bool:
        return await self._call("setnx", (key, value, expire), mutating=True)

    async def getset(self, key: str, value: str, expire=None):
        return await self._call("getset", (key, value, expire), mutating=True)

    async def delete(self, *keys: str) -> int:
        return await self._call("delete", keys, mutating=True)

    async def exists(self, key: str) -> bool:
        return await self._call("exists", (key,), mutating=False)

    async def incrby(self, key: str, amount: int = 1) -> int:
        return await self._call("incrby", (key, amount), mutating=True)

    # -- hashes ----------------------------------------------------------

    async def hset(self, key: str, mapping: Dict[str, str]) -> None:
        return await self._call("hset", (key, mapping), mutating=True)

    async def hget(self, key: str, field: str):
        return await self._call("hget", (key, field), mutating=False)

    async def hgetall(self, key: str) -> Dict[str, str]:
        return await self._call("hgetall", (key,), mutating=False)

    async def hincrby(self, key: str, field: str, amount: int = 1) -> int:
        return await self._call("hincrby", (key, field, amount), mutating=True)

    # -- sets ------------------------------------------------------------

    async def sadd(self, key: str, *members: str) -> None:
        return await self._call("sadd", (key,) + members, mutating=True)

    async def srem(self, key: str, *members: str) -> None:
        return await self._call("srem", (key,) + members, mutating=True)

    async def smembers(self, key: str) -> set:
        return await self._call("smembers", (key,), mutating=False)

    # -- scanning ---------------------------------------------------------

    async def keys(self, pattern: str = "*") -> list:
        return await self._call("keys", (pattern,), mutating=False)
