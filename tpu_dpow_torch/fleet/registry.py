"""WorkerRegistry: who is in the fleet, what can they do, are they alive.

The reference hub has no notion of its swarm's membership at all — it
broadcasts work and observes whoever answers (reference server/dpow/mqtt.py
publishes to the topic, never tracks subscribers). This registry is the
server-side half of the fleet coordination subsystem (docs/fleet.md): each
fleet-aware client announces itself on the ``fleet/announce`` topic with a
capability record (worker id, backend engine, handler concurrency, declared
hashrate) and keeps re-announcing on an interval, which doubles as the
fleet heartbeat. The registry

  * ages liveness on the injectable resilience ``Clock`` — a worker whose
    last announce is older than ``ttl`` is no longer live (chaos tests
    advance hours in milliseconds);
  * folds an EMA of MEASURED hashrate over the declared one: every sharded
    win is attributed to the shard whose range contains the winning nonce
    (fleet/cover.py), and (nonces scanned from the shard start) / (dispatch
    → result elapsed) is a real per-worker throughput sample;
  * writes every record through the ``Store`` protocol under
    ``fleet:worker:{id}`` so capabilities and learned hashrates survive a
    server restart (sqlite/redis/degraded — same durability story as the
    quota ledger, tpu_dpow_torch/sched/quota.py). Liveness is NOT trusted across
    a restart: loaded workers get one fresh ``ttl`` of grace to re-announce
    (their announce interval is a fraction of it), because the persisted
    stamp is from the dead process's monotonic clock.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

from .. import obs
from ..resilience.clock import Clock, SystemClock
from ..utils.logging import get_logger

logger = get_logger("tpu_dpow_torch.fleet")

STORE_PREFIX = "fleet:worker:"

#: Effective-hashrate floor (H/s): a worker that never declared and never
#: won still gets a non-zero partition weight instead of a zero-width shard.
MIN_HASHRATE = 1.0

#: Declared-hashrate ceiling (H/s). The announce rides the fleet's SHARED
#: broker credential (same trust model as the reference's swarm), so a
#: single libelous declaration must not be able to claim essentially the
#: whole nonce space; 1e12 comfortably covers a multi-card worker.
#: Measured EMA overrides declarations either way.
MAX_DECLARED_HASHRATE = 1e12

#: Registered-id cardinality bound: the same shared credential could mint
#: unlimited fresh ids (one in-memory record + one store hash each — an
#: unauthenticated resource-exhaustion vector). At capacity a fresh id
#: first evicts the longest-silent NON-live record; with every slot live
#: it is refused (counted under announces{kind="rejected"}).
MAX_WORKERS = 1024


@dataclass
class WorkerInfo:
    """One fleet member's capability record + liveness stamp."""

    worker_id: str
    backend: str = ""
    concurrency: int = 0
    declared_hashrate: float = 0.0  # H/s, 0 = unknown
    ema_hashrate: float = 0.0  # measured from sharded wins, 0 = no sample yet
    work_types: tuple = ("precache", "ondemand")
    last_seen: float = 0.0  # registry clock time of the last announce/win
    announces: int = 0
    #: Highest wire-codec version the worker advertised (transport/wire.py):
    #: 0 = legacy ASCII only. Re-negotiated on EVERY announce, so a worker
    #: restarted with --codec v0 downgrades its lane immediately.
    codec: int = 0

    @property
    def hashrate(self) -> float:
        """Partition weight: measured beats declared beats the floor."""
        return max(self.ema_hashrate or self.declared_hashrate, MIN_HASHRATE)

    def serves(self, work_type: str) -> bool:
        return work_type in self.work_types


class WorkerRegistry:
    def __init__(
        self,
        store,
        *,
        clock: Optional[Clock] = None,
        ttl: float = 45.0,
        ema_alpha: float = 0.3,
        max_workers: int = MAX_WORKERS,
    ):
        self.store = store
        self.clock = clock or SystemClock()
        self.ttl = ttl
        self.ema_alpha = ema_alpha
        self.max_workers = max(max_workers, 1)
        self._workers: Dict[str, WorkerInfo] = {}
        reg = obs.get_registry()
        self._m_live = reg.gauge(
            "dpow_fleet_workers_live",
            "Registered workers whose last announce is within the ttl")
        self._m_registered = reg.gauge(
            "dpow_fleet_workers_registered",
            "Workers the registry knows about (live or aged out)")
        self._m_hashrate = reg.gauge(
            "dpow_fleet_hashrate_hs",
            "Summed effective hashrate of the live fleet (H/s)")
        self._m_announces = reg.counter(
            "dpow_fleet_announces_total",
            "Capability announces accepted, by kind", ("kind",))
        self._m_expired = reg.counter(
            "dpow_fleet_workers_expired_total",
            "Workers dropped after ttl without an announce")

    # -- persistence ---------------------------------------------------

    async def load(self) -> int:
        """Rehydrate persisted records (server restart). Liveness restarts
        at one full ttl of grace — the stored stamp belongs to the previous
        process's monotonic clock and cannot be compared to ours. Records
        whose coarse wall-clock stamp is ancient (10x ttl) are deleted
        instead of loaded: default worker ids are pid-derived, so client
        churn mints fresh ids and the store would otherwise accumulate
        corpses that every restart resurrects for a ttl of dead lanes."""
        now = self.clock.time()
        # dpowlint: disable=DPOW101 — cross-restart store hygiene needs wall clock; monotonic stamps die with the process
        wall = time.time()
        count = 0
        for key in await self.store.keys(f"{STORE_PREFIX}*"):
            record = await self.store.hgetall(key)
            worker_id = key[len(STORE_PREFIX):]
            if not worker_id or not record:
                continue
            try:
                seen_wall = float(record.get("seen_wall", 0) or 0)
            except (TypeError, ValueError):
                seen_wall = 0.0
            if seen_wall and wall - seen_wall > 10 * self.ttl:
                await self.store.delete(key)
                continue
            try:
                info = WorkerInfo(
                    worker_id=worker_id,
                    backend=record.get("backend", ""),
                    concurrency=int(record.get("concurrency", 0) or 0),
                    declared_hashrate=float(record.get("declared_hashrate", 0) or 0),
                    ema_hashrate=float(record.get("ema_hashrate", 0) or 0),
                    work_types=tuple(
                        t for t in record.get("work_types", "").split("+") if t
                    ) or ("precache", "ondemand"),
                    last_seen=now,
                    announces=int(record.get("announces", 0) or 0),
                    codec=int(record.get("codec", 0) or 0),
                )
            except (TypeError, ValueError):
                logger.warning("dropping corrupt fleet record %s", key)
                continue
            self._workers[worker_id] = info
            count += 1
        self._sync_gauges()
        return count

    async def _persist(self, info: WorkerInfo) -> None:
        await self.store.hset(
            f"{STORE_PREFIX}{info.worker_id}",
            {
                "backend": info.backend,
                "concurrency": str(info.concurrency),
                "declared_hashrate": repr(info.declared_hashrate),
                "ema_hashrate": repr(info.ema_hashrate),
                "work_types": "+".join(info.work_types),
                "announces": str(info.announces),
                "codec": str(info.codec),
                # Coarse wall-clock stamp, for cross-restart store hygiene
                # only (monotonic clocks do not survive the process).
                # dpowlint: disable=DPOW101 — deliberate wall clock, see above
                "seen_wall": repr(time.time()),
            },
        )

    # -- announce / liveness -------------------------------------------

    async def handle_announce(self, payload: str) -> Optional[WorkerInfo]:
        """One ``fleet/announce`` message. Returns the updated record, or
        None when the payload is malformed / a goodbye."""
        try:
            data = json.loads(payload)
            worker_id = str(data["id"])
        except (ValueError, TypeError, KeyError):
            logger.warning("unparseable fleet announce: %.120r", payload)
            return None
        if not worker_id or any(c in worker_id for c in "/+#"):
            logger.warning("rejecting topic-unsafe worker id %r", worker_id)
            return None
        if data.get("bye"):
            # Clean shutdown: drop LIVENESS immediately, so the next
            # dispatch does not shard onto a worker that said goodbye —
            # but keep the record (in memory and in the store): learned
            # EMAs must survive restarts, and a forged bye over the shared
            # credential must not be able to erase them either.
            info = self._workers.get(worker_id)
            if info is not None:
                info.last_seen = self.clock.time() - self.ttl - 1.0
                self._m_announces.inc(1, "bye")
                self._sync_gauges()
            return None
        info = self._workers.get(worker_id)
        if info is None:
            # Capacity check-then-insert, re-validated after every await
            # (dpowlint DPOW801): the eviction suspends on the store, and
            # a concurrent announce can take the freed slot — or register
            # this very id — while we are parked. Without the loop two
            # concurrent fresh announces both pass one len() check and the
            # MAX_WORKERS bound overshoots (pinned by
            # test_fleet.test_announce_capacity_race_holds_bound).
            while (
                worker_id not in self._workers
                and len(self._workers) >= self.max_workers
            ):
                if not await self._evict_one_stale():
                    # Every slot holds a LIVE worker: refuse the fresh id
                    # rather than let announce floods grow memory/store/
                    # gauges without bound (see MAX_WORKERS).
                    self._m_announces.inc(1, "rejected")
                    logger.warning(
                        "fleet registry full (%d live); rejecting fresh id %s",
                        self.max_workers, worker_id,
                    )
                    return None
            info = self._workers.get(worker_id)
        fresh = info is None
        if fresh:
            info = WorkerInfo(worker_id=worker_id)
            self._workers[worker_id] = info
        info.backend = str(data.get("backend", info.backend))
        try:
            info.concurrency = int(data.get("concurrency", info.concurrency))
            declared = float(data.get("hashrate", 0.0))
            if declared > 0.0:
                # 0 declares "unknown" — it must not erase a previously
                # declared figure (e.g. a restart with the flag dropped).
                info.declared_hashrate = min(declared, MAX_DECLARED_HASHRATE)
        except (TypeError, ValueError):
            pass
        work_types = data.get("work")
        if isinstance(work_types, list) and work_types:
            info.work_types = tuple(str(t) for t in work_types)
        try:
            # Absent ⇒ 0: a legacy announce (or a --codec v0 restart) must
            # RESET the capability, not inherit last session's advertisement.
            info.codec = max(int(data.get("codec", 0) or 0), 0)
        except (TypeError, ValueError):
            info.codec = 0
        info.last_seen = self.clock.time()
        info.announces += 1
        self._m_announces.inc(1, "join" if fresh else "refresh")
        if fresh:
            logger.info(
                "fleet worker %s joined (%s backend, concurrency %d, "
                "declared %.3g H/s)",
                worker_id, info.backend or "?", info.concurrency,
                info.declared_hashrate,
            )
        await self._persist(info)
        self._sync_gauges()
        return info

    async def _evict_one_stale(self) -> bool:
        """Free one slot by dropping the longest-silent NON-live record
        (memory + store). False when every record is live."""
        now = self.clock.time()
        stale = [
            (info.last_seen, wid)
            for wid, info in self._workers.items()
            if now - info.last_seen > self.ttl
        ]
        if not stale:
            return False
        _, victim = min(stale)
        del self._workers[victim]
        await self.store.delete(f"{STORE_PREFIX}{victim}")
        return True

    def touch(self, worker_id: str) -> None:
        """Any positive signal from a worker (e.g. a sharded win) proves
        liveness as well as an announce does."""
        info = self._workers.get(worker_id)
        if info is not None:
            info.last_seen = self.clock.time()

    def get(self, worker_id: str) -> Optional[WorkerInfo]:
        return self._workers.get(worker_id)

    def is_live(self, worker_id: str) -> bool:
        info = self._workers.get(worker_id)
        return (
            info is not None
            and self.clock.time() - info.last_seen <= self.ttl
        )

    def live_workers(self, work_type: Optional[str] = None) -> List[WorkerInfo]:
        """Live fleet members (announce within ttl), optionally filtered to
        those serving ``work_type``; stable id order for deterministic
        partitions. Aged-out entries stay registered (their capabilities
        and EMA survive a flap) but are excluded here."""
        now = self.clock.time()
        out = []
        for info in self._workers.values():
            if now - info.last_seen > self.ttl:
                continue
            if work_type is not None and not info.serves(work_type):
                continue
            out.append(info)
        out.sort(key=lambda i: i.worker_id)
        self._sync_gauges()
        return out

    def expire(self) -> List[str]:
        """Drop workers silent for 10x ttl from memory (metrics hygiene: a
        renamed fleet must not pin dead ids in the registered gauge
        forever); returns the dropped ids. Plain ttl-aged workers are kept
        — they come back with their learned EMA when they re-announce."""
        now = self.clock.time()
        dead = [
            wid for wid, info in self._workers.items()
            if now - info.last_seen > 10 * self.ttl
        ]
        for wid in dead:
            del self._workers[wid]
            self._m_expired.inc()
        if dead:
            self._sync_gauges()
        return dead

    async def poll(self) -> None:
        """Periodic hygiene (server fleet poll loop): drop the long-dead —
        from the store too, or pid-derived worker ids accumulate there
        across client churn and resurrect on every restart — and resync
        the live/hashrate gauges even while nothing is flowing."""
        for wid in self.expire():
            await self.store.delete(f"{STORE_PREFIX}{wid}")
        self._sync_gauges()

    # -- measured hashrate ---------------------------------------------

    async def observe_result(
        self, worker_id: str, hashes: float, elapsed: float
    ) -> Optional[float]:
        """Fold one sharded win's throughput sample into the worker's EMA.

        ``hashes``: nonces between the shard start and the winning nonce —
        the scan is sequential from the shard start, so this is what the
        worker actually computed. ``elapsed``: dispatch → result wall time
        on the registry clock (includes queueing; the EMA is deliberately
        an END-TO-END rate, which is what partition weighting should use).
        """
        info = self._workers.get(worker_id)
        if info is None or elapsed <= 0.0 or hashes <= 0.0:
            return None
        sample = hashes / elapsed
        if info.ema_hashrate <= 0.0:
            info.ema_hashrate = sample
        else:
            a = self.ema_alpha
            info.ema_hashrate = a * sample + (1.0 - a) * info.ema_hashrate
        info.last_seen = self.clock.time()
        # Memory-only on purpose: this sits on the result-handling hot
        # path, and a store round trip per winning result would tax every
        # request completion. The worker's next announce (every
        # announce-interval seconds) persists the record, EMA included —
        # a restart loses at most that window of EMA movement.
        self._sync_gauges()
        return info.ema_hashrate

    # -- metrics -------------------------------------------------------

    def _sync_gauges(self) -> None:
        now = self.clock.time()
        live = [
            i for i in self._workers.values() if now - i.last_seen <= self.ttl
        ]
        self._m_registered.set(float(len(self._workers)))
        self._m_live.set(float(len(live)))
        self._m_hashrate.set(float(sum(i.hashrate for i in live)))
