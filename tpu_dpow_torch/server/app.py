"""DpowServer: the request-orchestration core.

The port's own copy of ``tpu_dpow/server/app.py``: the same topics, payloads,
store keys and metric families, so a port hub and a ``tpu_dpow`` hub serve
one swarm and one store interchangeably.

Semantic port of the reference's central state machine (reference
server/dpow_server.py:31-376) onto this framework's injectable seams
(Store, Transport) — with the reference's known regressions fixed:

  * difficulty multipliers WORK (the reference ships
    FORCE_ONLY_BASE_DIFFICULTY=True, neutering them — reference
    dpow_server.py:39-40);
  * injectable transport + store make every path testable in-process
    (the reference has no test seams at all, SURVEY.md §4);
  * optional MemoryStore checkpointing to disk (the reference's durability
    story is "it's all in Redis", SURVEY.md §5.4).

Responsibilities and their reference anchors:
  service_handler        — auth, throttle, validate, precache-hit,
                           dispatch + future wait      (dpow_server.py:229-376)
  client_result_handler  — winner election, cancel fan-out, rewards
                                                       (dpow_server.py:95-168)
  block_arrival_handler  — precache pipeline           (dpow_server.py:170-227)
  heartbeat/statistics   — liveness + public stats     (mqtt.py:76-89, :82-93)
"""

from __future__ import annotations

import asyncio
import json
import os
import traceback
from typing import Dict, Optional, Set

from .. import obs
from ..fleet import (
    ANNOUNCE_TOPIC,
    CoverageTracker,
    FleetCoordinator,
    FleetPlanner,
    WorkerRegistry,
)
from ..models import DifficultyModel, WorkType
from ..precache import AccountScorer, PrecacheCache, PrecachePipeline
from ..replica import ReplicaCoordinator, StaleEpoch, dispatch_topic, result_lane
from ..resilience import DispatchSupervisor, SystemClock
from ..sched import AdmissionController, Busy
from ..store import DegradedStore, MemoryStore, Store, atomic_write
from ..transport import Message, QOS_0, QOS_1, Transport
from ..transport import wire
from ..utils import nanocrypto as nc
from ..utils.logging import get_logger
from ..utils.throttle import Throttler
from .config import ServerConfig
from .exceptions import InvalidRequest, RequestTimeout, RetryRequest

logger = get_logger("tpu_dpow_torch.server")

WORK_PENDING = "0"


# Re-exported for compat; the shared implementation lives in utils so the
# ops CLI does not couple to the server app's import graph.
from ..utils import hash_key  # noqa: E402, F401


class DpowServer:
    def __init__(
        self,
        config: ServerConfig,
        store: Store,
        transport: Transport,
        clock=None,
    ):
        self.config = config
        self.store = store
        self.transport = transport
        # Injectable time (resilience/clock.py): chaos tests hand in a
        # FakeClock and play hours of grace windows in milliseconds.
        self.clock = clock or SystemClock()
        self.difficulty_model = DifficultyModel(
            base_difficulty=config.base_difficulty,
            max_multiplier=config.max_multiplier,
        )
        self.work_futures: Dict[str, asyncio.Future] = {}
        self._future_waiters: Dict[str, int] = {}
        # Highest difficulty PUBLISHED for each in-flight dispatch. Lets a
        # later raised-difficulty request re-target the running work instead
        # of piggybacking on the weaker dispatch and bouncing through
        # RetryRequest (the reference has exactly that hole:
        # dpow_server.py:310-329 awaits whatever future exists, at whatever
        # difficulty it was published). Entries live and die with the
        # work_futures entry for the same hash.
        self._dispatched_difficulty: Dict[str, int] = {}
        # Re-dispatch supervision (resilience/supervisor.py): each in-flight
        # dispatch is tracked with its waiters' deadline; a hash with no
        # publish and no worker result for a full grace window gets its
        # work re-published, escalating to hedged dispatch (both work
        # topics) after `hedge_after` attempts. Heals publishes lost to
        # dead/reconnecting workers (work rides QoS 0). Entries live and
        # die with work_futures.
        self.supervisor = DispatchSupervisor(
            grace=config.work_republish_interval or 1.0,
            hedge_after=config.hedge_after,
            republish=self._republish_work,
            clock=self.clock,
            on_abandon=self._dispatch_abandoned,
        )
        # Per-hash: serializes the dispatcher's difficulty-entry write with
        # concurrent raisers for the SAME hash, so interleaved store writes
        # cannot leave `block-difficulty:` below what was last published.
        # Per-hash (not one global lock) because the dispatcher holds it
        # across store+publish awaits on EVERY dispatch — a global lock
        # would serialize unrelated hashes' dispatches behind each other's
        # round trips. Entries live and die with work_futures.
        self._difficulty_locks: Dict[str, asyncio.Lock] = {}
        # Admission control & fair scheduling (tpu_dpow_torch/sched/): every
        # dispatch — on-demand and precache — asks this controller for a
        # window slot first. Defaults leave the window unbounded and the
        # quota unmetered (seed behavior); an operator sizes
        # max_inflight_dispatches to the worker fleet and overload turns
        # into 429 + Retry-After instead of unbounded queue growth
        # (docs/admission.md).
        self.admission = AdmissionController(
            store,
            clock=self.clock,
            window=config.max_inflight_dispatches,
            queue_limit=config.admission_queue_limit,
            quota_rate=config.quota_rate,
            quota_burst=config.quota_burst,
            quota_hard=config.quota_hard,
            precache_lease=config.precache_lease,
            precache_window_fraction=config.precache_window_fraction,
            busy_retry_after=config.busy_retry_after,
        )
        # Window ticket per dispatched hash; lives and dies with the
        # work_futures entry (released in _drop_dispatch_state).
        self._dispatch_tickets: Dict[str, object] = {}
        # Same-hash request coalescing: per hash, the gate
        # a mid-dispatch request holds while it acquires admission and
        # publishes. Concurrent same-hash arrivals wait on the gate and
        # then attach as extra waiters — N requests, ONE window slot, ONE
        # backend dispatch — instead of each queueing for admission. The
        # entry exists only while its dispatcher is between gate-register
        # and work_futures-install; the refcounted waiter teardown below
        # (last waiter cancels the dispatch) is unchanged.
        self._dispatch_gates: Dict[str, asyncio.Future] = {}
        # Fleet coordination (tpu_dpow_torch/fleet/): every work publish routes
        # through the coordinator, which shards the nonce space across the
        # announced worker fleet (disjoint hashrate-weighted ranges) and
        # falls back to the reference's broadcast race whenever the
        # registry is empty, stale, or below fleet_min_workers. The
        # supervisor's republish heals sharded dispatches shard-wise
        # (docs/fleet.md).
        self.fleet_registry = WorkerRegistry(
            store, clock=self.clock, ttl=config.fleet_worker_ttl
        )
        self.fleet = FleetCoordinator(
            self.fleet_registry,
            FleetPlanner(
                self.fleet_registry,
                min_workers=config.fleet_min_workers,
                max_shards=config.fleet_max_shards,
                horizon=config.fleet_horizon,
            ),
            CoverageTracker(self.fleet_registry),
            transport,
            clock=self.clock,
            enabled=config.fleet,
            codec_v1=config.codec != "v0",
            lane_flush=config.lane_flush,
        )
        # Replication (tpu_dpow_torch/replica/, docs/replication.md): with
        # --replicas > 1 this process is ONE member of a ring of
        # near-stateless orchestrator replicas over the SHARED store. It
        # owns a hash-partitioned slice of request space (rendezvous
        # ring), forwards non-owned on-demand dispatches to their owner
        # (cross-replica coalescing), journals every local dispatch so a
        # peer can adopt it if this process dies, and adopts dead peers'
        # journals in turn (leaderless takeover, epoch-fenced against
        # zombies).
        self.replica: Optional[ReplicaCoordinator] = None
        if config.replicas > 1:
            inner = store
            while isinstance(inner, DegradedStore):
                inner = inner.primary
            if isinstance(inner, MemoryStore) and not getattr(inner, "shared", False):
                raise ValueError(
                    "--replicas > 1 requires a SHARED store, but the "
                    "configured store is a per-process memory:// store: "
                    "each replica would keep its own quota ledger, fleet "
                    "registry, and replica membership, so the ring would "
                    "never see its peers and the takeover journal could "
                    "not survive a crash. Point every replica at one "
                    "--store_uri sqlite:///path.db file, redis://host, or "
                    "degraded+ over either; embedded in-process "
                    "topologies (tests, benchmarks) may instead hand the "
                    "same MemoryStore(shared=True) instance to every "
                    "replica."
                )
            self.replica = ReplicaCoordinator(
                store,
                replica_id=config.replica_id or f"r{os.getpid()}",
                clock=self.clock,
                ttl=config.replica_ttl,
                heartbeat_interval=config.replica_heartbeat_interval,
                adopt=self._adopt_dispatch,
            )
        # Hashes whose work_futures entry is a FORWARD PROXY (the ring
        # owner dispatches; the shared result plane resolves it here) and
        # hashes this replica journaled for takeover. Both live and die
        # with the work_futures entry (_drop_dispatch_state).
        self._forwarded: Set[str] = set()
        self._journaled: Set[str] = set()
        # Peer replicas that forwarded each in-flight hash here: the
        # eventual result is RELAYED to their addressed lanes
        # (result/{origin}/{type}, QoS 1) so a forwarder that missed the
        # QoS-0 worker result still resolves its proxy promptly.
        self._forward_origins: Dict[str, Set[str]] = {}
        # Adopted takeovers with NO local waiter: no request coroutine
        # will ever tear them down — the supervisor's abandon hook (at
        # deadline) or _maybe_finish_adopted (on resolve) is their reaper.
        self._adopted_orphan: Set[str] = set()
        # Runtime control levers (POST /control/ on the upcheck face,
        # docs/loadgen.md): a draining replica refuses NEW service work
        # with the standard busy shape — open-loop clients fail over to
        # another face — while in-flight dispatches run to completion
        # (the autoscale actuator's retire-after-drain contract). The
        # precache-shed and fleet-horizon levers live on the admission
        # controller and the fleet planner respectively.
        self.draining = False
        self.service_throttlers: Dict[str, Throttler] = {}
        self.last_block: Optional[float] = None
        self.work_republished = 0  # healed lost publishes (observability)
        self._tasks: list = []
        # Fire-and-forget store writes in flight: the loop only holds weak
        # refs to tasks, so an unretained ensure_future is GC-cancellable
        # mid-write (dpowlint DPOW301) — retained here, reaped on done.
        self._bg_tasks: set = set()
        self._crashed = False
        self._started = False
        # Metrics (tpu_dpow_torch.obs): the queue-depth / latency / outcome
        # signals the reference's two Redis counters cannot answer. Family
        # handles are get-or-create, so several servers in one process
        # (tests) share series rather than clashing on registration.
        reg = obs.get_registry()
        self._tracer = obs.get_tracer()
        self._m_requests = reg.counter(
            "dpow_server_requests_total",
            "Service requests served, by work type", ("work_type",))
        self._m_request_seconds = reg.histogram(
            "dpow_server_request_seconds",
            "End-to-end service request latency, by work type", ("work_type",))
        self._m_inflight = reg.gauge(
            "dpow_server_inflight_requests",
            "Service requests currently being handled")
        self._m_dispatches = reg.gauge(
            "dpow_server_inflight_dispatches",
            "On-demand dispatches with an unresolved future")
        self._m_results = reg.counter(
            "dpow_server_results_total",
            "Worker results received, by disposition", ("outcome",))
        self._m_cancels = reg.counter(
            "dpow_server_cancels_total", "Cancel fan-outs published")
        self._m_precache = reg.counter(
            "dpow_server_precache_dispatch_total",
            "Precache work publishes triggered by block arrivals")
        self._m_republished = reg.counter(
            "dpow_server_work_republished_total",
            "Lost work publishes healed by the republish loop")
        self._m_coalesce = reg.counter(
            "dpow_coalesce_total",
            "On-demand requests served by another request's dispatch "
            "instead of their own, by how they joined", ("outcome",))
        self._m_draining = reg.gauge(
            "dpow_server_draining",
            "1 while this replica refuses new service work pending "
            "retirement (the /control/ drain lever)")
        self._m_draining.set(0.0)
        # Population-scale precache (tpu_dpow_torch/precache/, docs/precache.md):
        # block confirmations are scored per account, admitted into a
        # BOUNDED priority cache of speculative solves, and dispatched
        # rate-shaped through the admission controller — replacing the
        # reference's flat "every known account's every confirmation burns
        # a dispatch" path (reference dpow_server.py:170-206).
        self.precache_scorer = AccountScorer(
            store,
            clock=self.clock,
            half_life=config.precache_score_half_life,
            max_accounts=config.precache_max_accounts,
        )
        self.precache_cache = PrecacheCache(
            capacity=config.precache_cache_size,
            watermark=config.precache_watermark,
            min_score=config.precache_min_score,
            clock=self.clock,
        )
        self.precache = PrecachePipeline(
            store,
            self.admission,
            self.fleet,
            self._tracer,
            self.precache_scorer,
            self.precache_cache,
            base_difficulty=config.base_difficulty,
            debug=config.debug,
            account_expiry=config.account_expiry,
            block_expiry=config.block_expiry,
            batch_interval=config.precache_batch_interval,
            batch_size=config.precache_batch_size,
            poll_interval=config.admission_poll_interval,
            clock=self.clock,
            retire_cb=self._precache_retired,
        )

    # ------------------------------------------------------------------
    # runtime control (POST /control/ on the upcheck face)
    # ------------------------------------------------------------------

    def control_state(self) -> dict:
        """The levers' current positions (GET /control/)."""
        return {
            "draining": self.draining,
            "precache_shed": bool(
                getattr(self.admission, "shed_precache", False)
            ),
            "fleet_horizon": self.fleet.planner.horizon,
        }

    def apply_control(self, data: dict) -> dict:
        """Apply the autoscaler's levers (docs/loadgen.md). Unknown keys
        are refused so a typo'd lever never silently no-ops. Returns the
        post-apply state."""
        known = {"drain", "precache_shed", "fleet_horizon"}
        unknown = set(data) - known
        if unknown:
            raise ValueError(f"unknown control field(s): {sorted(unknown)}")
        if "fleet_horizon" in data:
            horizon = float(data["fleet_horizon"])
            if horizon < 0:
                raise ValueError("fleet_horizon must be >= 0")
            self.fleet.planner.horizon = horizon
        if "precache_shed" in data:
            self.admission.shed_precache = bool(data["precache_shed"])
        if "drain" in data:
            self.draining = bool(data["drain"])
            self._m_draining.set(1.0 if self.draining else 0.0)
        return self.control_state()

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    async def setup(self) -> None:
        await self.store.setup()
        if self.config.checkpoint_path and isinstance(self.store, MemoryStore):
            try:
                await asyncio.to_thread(self.store.load, self.config.checkpoint_path)
                logger.info("restored state checkpoint from %s", self.config.checkpoint_path)
            except FileNotFoundError:
                pass
        await self.transport.connect()
        # Server consumes results; everything else it publishes.
        await self.transport.subscribe("result/#", qos=QOS_0)
        if self.config.fleet:
            # Fleet announces ride QoS 1 so a worker's join survives a
            # server blip. With --no_fleet the subscription is skipped
            # entirely: announces from fleet-default clients must not cost
            # registry/store work on a server that will never shard.
            await self.transport.subscribe("fleet/#", qos=QOS_1)
            # Rehydrate fleet capabilities (learned hashrates) from the
            # store; liveness restarts with one ttl of announce grace.
            await self.fleet_registry.load()
        if self.replica is not None:
            # Join the ring (fresh epoch) and open this replica's
            # forwarded-dispatch lane. QoS 1: a forwarded request must
            # survive an owner mid-reconnect, or the forwarder strands to
            # its timeout for nothing.
            await self.replica.start()
            await self.transport.subscribe(
                dispatch_topic(self.replica.replica_id), qos=QOS_1
            )
            # Our addressed result-relay lane needs its OWN QoS-1
            # subscription: relays are published QoS 1, but the broker
            # delivers at min(publish, subscription) and the shared
            # result/# subscription above is QoS 0 — without this a relay
            # sent while we are mid-reconnect is dropped instead of queued,
            # stranding the proxy until its store-fallback timeout.
            await self.transport.subscribe(
                f"result/{self.replica.replica_id}/#", qos=QOS_1
            )
        if self.config.enable_precache:
            # Rehydrate the hot head of the account-activity table so a
            # restarted server resumes preferring the same accounts it
            # had learned (wall-decayed for the downtime).
            await self.precache_scorer.load()
        self._started = True

    def start_loops(self) -> None:
        self._tasks = [
            asyncio.ensure_future(self._message_loop()),
            asyncio.ensure_future(self._heartbeat_loop()),
            asyncio.ensure_future(self._statistics_loop()),
        ]
        if self.config.work_republish_interval > 0:
            self._tasks.append(asyncio.ensure_future(self.supervisor.run()))
        self._tasks.append(
            asyncio.ensure_future(
                self.admission.run(self.config.admission_poll_interval)
            )
        )
        if self.config.enable_precache:
            # Batch flusher + lease reaper for the precache pipeline.
            self._tasks.append(asyncio.ensure_future(self.precache.run()))
        if self.config.fleet:
            self._tasks.append(asyncio.ensure_future(self._fleet_poll_loop()))
        if self.replica is not None:
            self._tasks.append(asyncio.ensure_future(self.replica.run()))
        if self.config.checkpoint_path and isinstance(self.store, MemoryStore):
            self._tasks.append(asyncio.ensure_future(self._checkpoint_loop()))

    def _spawn(self, coro) -> "asyncio.Future":
        """Launch a fire-and-forget store write WITHOUT losing the task:
        the loop's task set is weak, so a dropped ensure_future result can
        be garbage-collected — and cancelled — mid-write."""
        if self._crashed:
            # crash() fidelity: a SIGKILLed process writes no goodbyes.
            # Cancelled tasks still run their finallys (asyncio offers no
            # way around that), so the journal/frontier teardown writes
            # they try to spawn are refused here — the shared store must
            # keep exactly the state the dead process left behind.
            coro.close()
            done = asyncio.get_event_loop().create_future()
            done.set_result(None)
            return done
        task = asyncio.ensure_future(coro)
        self._bg_tasks.add(task)
        obs.LEDGER.acquire("bgtask", task)
        task.add_done_callback(self._bg_task_done)
        return task

    def _bg_task_done(self, task) -> None:
        """Done-callback for every retained background write: the discard
        keeps `_bg_tasks` from growing, the ledger discharge closes the
        task's lifetime record. Runs for drained AND cancelled tasks —
        close()/crash() detach the set but never the callbacks — so the
        zero-outstanding teardown invariant holds on every exit path."""
        self._bg_tasks.discard(task)
        obs.LEDGER.discharge("bgtask", task)

    async def close(self) -> None:
        self._started = False
        for t in self._tasks:
            t.cancel()
        await asyncio.gather(*self._tasks, return_exceptions=True)
        self._tasks = []
        # Detach the drain set before awaiting (dpowlint DPOW801): a write
        # spawned by a still-unwinding handler DURING the wait lands in the
        # fresh set instead of being silently dropped by a clear() racing
        # the handler.
        draining, self._bg_tasks = set(self._bg_tasks), set()
        if draining:
            # Let in-flight counter/frontier writes land before the store
            # goes away — but bounded: against a hung store (degraded
            # backend mid-outage, chaos HANG) shutdown must not block
            # forever on a fire-and-forget counter.
            done, pending = await asyncio.wait(draining, timeout=2.0)
            for t in pending:
                t.cancel()
            if pending:
                await asyncio.gather(*pending, return_exceptions=True)
            for t in done:
                t.exception()  # consume, writes are best-effort
        if self.config.checkpoint_path and isinstance(self.store, MemoryStore):
            # Same split as the checkpoint loop: snapshot on the loop,
            # write in a thread — and never let a failed final checkpoint
            # skip the transport/store teardown below.
            try:
                blob = self.store.snapshot()
                await asyncio.to_thread(
                    atomic_write, self.config.checkpoint_path, blob
                )
            except Exception as e:
                logger.warning("final checkpoint failed: %s", e)
        if self.replica is not None:
            # Clean leave: drop the member record so peers rebalance now
            # instead of waiting out the ttl. Best-effort — a fenced
            # zombie has nothing left to remove.
            try:
                await self.replica.stop()
            except Exception as e:
                logger.warning("replica leave failed: %s", e)
        await self.transport.close()
        await self.store.close()

    async def crash(self) -> None:
        """Chaos seam: die with NO teardown courtesy — loops cancelled,
        transport dropped, store state (replica membership, heartbeats,
        takeover journal) left in place exactly as a SIGKILL would leave
        it. The replica chaos tests and benchmarks/replicas.py kill one
        ring member this way to exercise the takeover path; close() is
        the clean exit."""
        self._started = False
        # Sever the outside world BEFORE cancelling: the cancelled tasks'
        # finally blocks would otherwise run their graceful teardown —
        # journal forgets, cancel frames — against the shared store and
        # broker, which a real SIGKILL never gets to do.
        self._crashed = True
        await self.transport.close()
        for t in self._tasks:
            t.cancel()
        await asyncio.gather(*self._tasks, return_exceptions=True)
        self._tasks = []
        draining, self._bg_tasks = set(self._bg_tasks), set()
        for t in draining:
            t.cancel()
        await asyncio.gather(*draining, return_exceptions=True)

    # ------------------------------------------------------------------
    # background loops
    # ------------------------------------------------------------------

    async def _message_loop(self) -> None:
        """Dispatch inbound transport messages (reference mqtt.py:54-74)."""
        async for msg in self.transport.messages():
            try:
                if msg.topic.startswith("result/"):
                    await self.client_result_handler(msg.topic, msg.payload)
                elif msg.topic == ANNOUNCE_TOPIC and self.config.fleet:
                    await self.fleet.on_announce(msg.payload)
                elif (
                    self.replica is not None
                    and msg.topic == dispatch_topic(self.replica.replica_id)
                ):
                    await self._replica_forward_handler(msg.payload)
            except Exception:
                logger.error("result handling failed:\n%s", traceback.format_exc())

    async def _heartbeat_loop(self) -> None:
        """~1 Hz empty heartbeat (reference mqtt.py:76-89)."""
        while True:
            try:
                await self.transport.publish("heartbeat", "", qos=QOS_0)
            except Exception as e:
                logger.warning("heartbeat publish failed: %s", e)
            await self.clock.sleep(self.config.heartbeat_interval)

    async def _statistics_loop(self) -> None:
        """5-minute public statistics broadcast (reference dpow_server.py:82-93)."""
        while True:
            await self.clock.sleep(self.config.statistics_interval)
            try:
                stats = await self.all_statistics()
                await self.transport.publish("statistics", json.dumps(stats), qos=QOS_0)
            except Exception as e:
                logger.warning("statistics publish failed: %s", e)

    async def _republish_work(self, block_hash: str, hedged: bool) -> bool:
        """Supervisor callback: heal a lost work publish for one dispatch.

        work/ondemand rides QoS 0 by design (a stale duplicate delivered
        minutes later would waste lanes), so a publish that fired while
        every worker was dead or mid-reconnect is simply gone — the
        reference strands those waiters until timeout and expects the
        service to retry (its dpow_server.py has no analog). The supervisor
        calls here for any hash whose dispatch has been silent (no publish,
        no worker result) for a full grace window; the re-publish goes out
        at the current (possibly raised) target, and workers already
        scanning the hash dedup the repeat on enqueue
        (client/work_handler.py queue_work), so the heal costs nothing in
        the healthy case. A HEDGED re-dispatch (escalation after repeated
        silence) also publishes to work/precache: precache-only workers are
        recruited onto the stalled hash — the result handler keys the work
        type off the store, not the topic, so accounting stays correct.

        Returns True iff something was published (the supervisor re-arms
        its grace window only then).
        """
        fut = self.work_futures.get(block_hash)
        if fut is None or fut.done():
            return False
        # Work no longer wanted at the store level — the frontier moved on
        # (block_arrival retired the key) or a result already landed. The
        # result handler drops everything for such a hash, so re-announcing
        # it would have workers grind a dead target once per grace window
        # until the waiter times out. Let the waiter run out quietly.
        avail = await self.store.get(f"block:{block_hash}")
        if avail != WORK_PENDING:
            return False
        # The store await may have let this hash resolve or tear down; a
        # stale publish would set workers grinding work nobody waits for,
        # with no cancel fan-out behind it.
        if self.work_futures.get(block_hash) is not fut or fut.done():
            return False
        difficulty = self._dispatched_difficulty.get(
            block_hash, self.config.base_difficulty
        )
        # Fleet-aware heal (fleet/coordinator.py): a SHARDED dispatch gets
        # shard-wise recovery — live owners' shards re-published to their
        # lanes, dead owners' shards handed to live workers — instead of
        # re-racing the whole fleet over the full space. Broadcast
        # dispatches (and hedged escalations, which abandon coordination)
        # republish exactly as before.
        published = await self.fleet.republish(
            block_hash, difficulty, WorkType.ONDEMAND.value, hedged,
            self._tracer.id_for(block_hash),
        )
        if not published:
            return False
        self.work_republished += 1
        self._m_republished.inc()
        logger.info(
            "re-published pending work for %s%s",
            block_hash, " (hedged)" if hedged else "",
        )
        return True

    async def _fleet_poll_loop(self) -> None:
        """Fleet hygiene on the injectable clock: long-dead workers are
        dropped, the live/hashrate gauges resync even while nothing flows,
        and abandoned shard tables (a precache dispatch whose result was
        lost AND whose account never confirms again has no other teardown
        path) are swept out."""
        cover_age = max(self.config.precache_lease * 4,
                        self.config.max_timeout * 2)
        while True:
            await self.clock.sleep(max(self.config.fleet_worker_ttl / 2, 0.5))
            try:
                await self.fleet_registry.poll()
                self.fleet.cover.sweep(self.clock.time(), cover_age)
            except Exception as e:
                logger.warning("fleet registry sweep failed: %s", e)

    async def _checkpoint_loop(self) -> None:
        while True:
            await self.clock.sleep(self.config.checkpoint_interval)
            try:
                # Snapshot ON the loop (it iterates live dicts — a thread
                # would race request coroutines mutating the store), then
                # push only the blocking fsync'd write off the loop.
                blob = self.store.snapshot()
                await asyncio.to_thread(
                    atomic_write, self.config.checkpoint_path, blob
                )
            except Exception as e:
                logger.warning("checkpoint failed: %s", e)

    # ------------------------------------------------------------------
    # replica plane (tpu_dpow_torch/replica/, docs/replication.md)
    # ------------------------------------------------------------------

    async def _send_forward(
        self, owner: str, block_hash: str, difficulty: int, deadline: float
    ) -> None:
        """Hand a dispatch to its ring owner on the owner's addressed lane
        (replica/dispatch/{owner}, QoS 1 — a forwarded request must survive
        the owner mid-reconnect, or the forwarder strands for nothing).
        The frame carries our epoch so a zombie forwarder is refused."""
        payload = json.dumps({
            "v": 1,
            "hash": block_hash,
            "difficulty": difficulty,
            "from": self.replica.replica_id,
            "epoch": self.replica.registry.epoch,
            "budget": max(deadline - self.clock.time(), 0.001),
        })
        await self.transport.publish(dispatch_topic(owner), payload, qos=QOS_1)

    async def _replica_forward_handler(self, payload: str) -> None:
        """Owner side of cross-replica forwarding: a peer determined WE own
        this hash. Dispatch it here — through the normal admission/coalesce
        machinery, as a waiterless pseudo-request — and relay the result to
        the forwarder's lane when it lands."""
        try:
            data = json.loads(payload)
        except ValueError:
            return
        if not isinstance(data, dict):
            return
        try:
            block_hash = nc.validate_block_hash(str(data["hash"]))
            difficulty = int(data["difficulty"])
            origin = str(data["from"])
            epoch = int(data.get("epoch", 0))
            budget = float(data.get("budget", self.config.default_timeout))
        except (KeyError, TypeError, ValueError, nc.InvalidBlockHash):
            return
        if not await self.replica.publish_allowed(origin, epoch, "forward"):
            return
        budget = min(max(budget, 0.001), self.config.max_timeout)
        available = await self.store.get(f"block:{block_hash}")
        if available and available != WORK_PENDING:
            strong = True
            try:
                strong = nc.work_value(block_hash, available) >= difficulty
            except (nc.InvalidBlockHash, nc.InvalidWork, ValueError):
                strong = False
            if strong:
                # Solved before the forward arrived (a precache hit, or a
                # peer's dispatch): serve the forwarder straight from the
                # store.
                work_type = (
                    await self.store.get(f"work-type:{block_hash}")
                    or WorkType.PRECACHE.value
                )
                await self._relay_result_to(
                    origin, block_hash, available, work_type
                )
                return
            # Solved BELOW the forwarded target (a base-difficulty
            # precache or weaker peer dispatch won while the forward was
            # in flight): relaying it would bounce in the forwarder's
            # final validation. Reset the frontier so the dispatch below
            # re-targets at the forwarded difficulty (the entry-path
            # weak-precache idiom).
            await self.store.set(
                f"block:{block_hash}", WORK_PENDING,
                expire=self.config.block_expiry,
            )
            await self.store.delete(f"block-lock:{block_hash}")
        self._add_origin(block_hash, origin)
        if block_hash in self._journaled:
            # The dispatch is already journaled without this origin; an
            # adopter must know whom to relay to if we die now.
            self._spawn(self._rejournal(block_hash))
        self._spawn(self._serve_forwarded(block_hash, difficulty, budget, origin))

    async def _serve_forwarded(
        self, block_hash: str, difficulty: int, budget: float, origin: str
    ) -> None:
        """Drive a forwarded dispatch as a local waiter: it holds the
        admission slot, coalesces with concurrent local requests for the
        same hash, extends supervision to the forwarder's budget, and tears
        down by the normal refcount. The result relay rides the winner
        path (_relay_origins), not this coroutine — a relay must fire even
        when a LOCAL request's dispatch resolves the hash first."""
        try:
            await self._dispatch_ondemand(
                block_hash, None, difficulty, budget,
                service=f"replica:{origin}", allow_forward=False,
            )
        except (RequestTimeout, RetryRequest, Busy):
            # Clean abort: the forwarder's own deadline fallback (store
            # check at timeout) is the remaining answer path. A forward
            # shed BEFORE any dispatch state existed (admission Busy)
            # leaves no teardown to pop the origin set later — drop it
            # here or every shed forwarded hash leaks an entry (and a
            # later unrelated dispatch of the hash would relay to it).
            if block_hash not in self.work_futures:
                self._pop_origins(block_hash)
        except asyncio.CancelledError:
            raise
        except Exception:
            logger.error(
                "forwarded dispatch for %s failed:\n%s",
                block_hash, traceback.format_exc(),
            )
            # Same leak guard as the clean-abort branch: a failure before
            # any dispatch state existed (e.g. store error inside
            # admission) leaves no teardown to pop the origin set.
            if block_hash not in self.work_futures:
                self._pop_origins(block_hash)

    async def _relay_result_to(
        self, origin: str, block_hash: str, work: str, work_type: str
    ) -> None:
        """One addressed result relay: result/{origin}/{type}, QoS 1,
        stamped with our epoch (receivers fence zombies)."""
        payload = json.dumps({
            "v": 1,
            "hash": block_hash,
            "work": work,
            "type": work_type,
            "from": self.replica.replica_id,
            "epoch": self.replica.registry.epoch,
        })
        try:
            await self.transport.publish(
                result_lane(origin, work_type), payload, qos=QOS_1
            )
            self.replica.count_relay("sent")
        except Exception as e:
            logger.warning("result relay to %s failed: %s", origin, e)

    async def _recorded_difficulty(self, block_hash: str) -> int:
        """The target on record for an in-flight hash: the store's
        `block-difficulty:` row (authoritative across replicas — initial
        raised dispatches and re-targets bump it), falling back to the
        locally dispatched target, then the base. The one definition every
        resolve/validate site shares, so target resolution cannot diverge
        between them."""
        difficulty_hex = await self.store.get(f"block-difficulty:{block_hash}")
        if difficulty_hex:
            try:
                return int(difficulty_hex, 16)
            except ValueError:
                pass
        return self._dispatched_difficulty.get(
            block_hash, self.config.base_difficulty
        )

    async def _store_work_strong(self, block_hash: str, work: str) -> bool:
        """Stored work answers local waiters only when it meets the
        RECORDED target for the hash: weaker work (a base-difficulty
        precache winning the election under a raised re-target) bounces in
        the waiter's final validation, turning a late answer into an error
        reply — the weak-precache class the local resolve sites guard
        against."""
        difficulty = await self._recorded_difficulty(block_hash)
        try:
            return nc.work_value(block_hash, work) >= difficulty
        except (nc.InvalidBlockHash, nc.InvalidWork, ValueError):
            return False

    async def _relay_origins(
        self, block_hash: str, work: str, work_type: str
    ) -> None:
        """Relay a resolved hash to every replica that forwarded it here.
        Pops the origin set: at most one site relays per dispatch."""
        if self.replica is None:
            return
        origins = self._pop_origins(block_hash)
        if not origins:
            return
        for origin in sorted(origins):
            await self._relay_result_to(origin, block_hash, work, work_type)

    async def _handle_result_relay(self, content: str) -> None:
        """Forwarder side of the relay: resolve the local proxy future from
        the store (the relayer stored the work before relaying). Zombie
        relays — an adopted replica's stale publish — are fenced."""
        try:
            data = json.loads(content)
        except ValueError:
            return
        if not isinstance(data, dict):
            return
        try:
            block_hash = nc.validate_block_hash(str(data["hash"]))
            sender = str(data.get("from", ""))
            epoch = int(data.get("epoch", 0))
            work = str(data.get("work", ""))
        except (KeyError, TypeError, ValueError, nc.InvalidBlockHash):
            return
        if not await self.replica.publish_allowed(sender, epoch, "relay"):
            return
        fut = self.work_futures.get(block_hash)
        if fut is None or fut.done():
            self.replica.count_relay("stale")
            return
        available = await self.store.get(f"block:{block_hash}")
        if (
            available
            and available != WORK_PENDING
            and await self._store_work_strong(block_hash, available)
        ):
            # The relayer's store write is the authority (it won the
            # election); the payload's work is a convenience copy.
            if self.work_futures.get(block_hash) is fut and not fut.done():
                fut.set_result(available)
                self.replica.count_relay("served")
            self._maybe_finish_adopted(block_hash)
            return
        # Store not settled yet (relay raced the shared store) — or it
        # settled WEAKER than our recorded target (a base-difficulty
        # precache under a raised re-target), which must not resolve the
        # proxy: accept the payload's work only if it validates at our
        # recorded target.
        difficulty = await self._recorded_difficulty(block_hash)
        try:
            nc.validate_work(block_hash, work, difficulty)
        except (nc.InvalidWork, nc.InvalidBlockHash):
            self.replica.count_relay("invalid")
            return
        if self.work_futures.get(block_hash) is fut and not fut.done():
            fut.set_result(work)
            self.replica.count_relay("served")
        self._maybe_finish_adopted(block_hash)

    async def _rejournal(self, block_hash: str) -> None:
        """Refresh this dispatch's takeover record (new origin attached, or
        a later waiter extended the deadline). Fire-and-forget: once we are
        fenced the record belongs to the adopter."""
        if self.replica is None or block_hash not in self._journaled:
            return
        deadline = self.supervisor.deadline_of(block_hash)
        if deadline is None:
            return
        try:
            await self.replica.journal_dispatch(
                block_hash,
                self._dispatched_difficulty.get(
                    block_hash, self.config.base_difficulty
                ),
                WorkType.ONDEMAND.value,
                deadline,
                origins=self._forward_origins.get(block_hash, ()),
            )
        except StaleEpoch:
            pass

    async def _adopt_dispatch(
        self, block_hash: str, record: dict, dead_id: str
    ) -> bool:
        """Takeover of ONE journaled dispatch from a dead peer (called by
        the ReplicaCoordinator once it won the adoption claim and fenced
        the dead epoch). Serve-or-clean-abort: re-arm supervision and
        re-publish if the work is still wanted, relay late if it already
        resolved, drop cleanly if the frontier moved on."""
        origins = [
            o for o in record.get("origins", ()) if isinstance(o, str) and o
        ]
        try:
            difficulty = int(record.get("difficulty") or self.config.base_difficulty)
        except (TypeError, ValueError):
            difficulty = self.config.base_difficulty
        work_type = str(record.get("work_type") or WorkType.ONDEMAND.value)
        if work_type not in (WorkType.ONDEMAND.value, WorkType.PRECACHE.value):
            work_type = WorkType.ONDEMAND.value
        available = await self.store.get(f"block:{block_hash}")
        if available is None:
            return True  # frontier moved on / expired: nothing left to serve
        if available != WORK_PENDING:
            # Resolved while the owner was dying: late service is all that
            # is left — relay straight to the forwarders.
            for origin in origins:
                await self._relay_result_to(
                    origin, block_hash, available, work_type
                )
            return True
        now = self.clock.time()
        deadline = ReplicaCoordinator.adopted_deadline(record, now)
        if deadline <= now:
            return True  # budget exhausted before adoption: clean abort
        # A raised re-target may have outbid the journaled difficulty; the
        # result handler validates against the store, so the re-publish
        # must not fall below it.
        difficulty = max(
            difficulty, await self._recorded_difficulty(block_hash)
        )
        if origins:
            for origin in sorted(origins):
                self._add_origin(block_hash, origin)
        existing = self.work_futures.get(block_hash)
        if existing is not None:
            # Already tracked here — typically OUR forward proxy to the
            # dead owner. From adoption on this replica IS the owner:
            # supervise to the journaled budget and re-publish (the dead
            # owner's publish may never have fired). No cleanup guard: the
            # proxy's waiters own its teardown, and on failure the journal
            # record stays for the next poll's retry.
            self._forwarded.discard(block_hash)
            difficulty = max(
                difficulty,
                self._dispatched_difficulty.get(block_hash, difficulty),
            )
            self._dispatched_difficulty[block_hash] = difficulty
            await self._arm_adopted(
                block_hash, existing, difficulty, work_type, deadline, origins
            )
            return True
        fut = asyncio.get_running_loop().create_future()
        self.work_futures[block_hash] = fut
        obs.LEDGER.acquire("future", block_hash)
        self._dispatched_difficulty[block_hash] = difficulty
        self._adopted_orphan.add(block_hash)
        self._m_dispatches.set(len(self.work_futures))
        try:
            await self._arm_adopted(
                block_hash, fut, difficulty, work_type, deadline, origins
            )
        except BaseException:
            # A failed adoption must not strand a dead future; the journal
            # record stays (the coordinator only drops it on success), so
            # the next poll retries.
            if self.work_futures.get(block_hash) is fut:
                self._drop_dispatch_state(block_hash)
            if not fut.done():
                fut.cancel()
            raise
        return True

    async def _arm_adopted(
        self,
        block_hash: str,
        fut: asyncio.Future,
        difficulty: int,
        work_type: str,
        deadline: float,
        origins,
    ) -> None:
        """Shared tail of both _adopt_dispatch branches: supervise to the
        journaled budget, re-journal under OUR id — without it the adopted
        dispatch is in no journal at all (the coordinator deletes the dead
        owner's record on success), so a SECOND replica failure would make
        it unadoptable — then re-publish. Both awaits are guarded against
        the served-while-journaling window: the dead owner's late result
        can resolve the dispatch and tear its state down while either
        suspension is parked."""
        self.supervisor.track(block_hash, deadline)
        await self.replica.journal_dispatch(
            block_hash, difficulty, work_type, deadline,
            origins=[o for o in origins if o != self.replica.replica_id],
        )
        if self.work_futures.get(block_hash) is not fut:
            # Teardown ran while the journal write was suspended: the
            # dispatch was SERVED. Teardown could not forget the record we
            # just wrote (we had not marked _journaled yet) — drop it
            # here, unless a brand-new dispatch of the same hash already
            # journaled itself and owns the key now.
            if block_hash not in self._journaled:
                await self.replica.forget_dispatch(block_hash)
            return
        self._journaled.add(block_hash)
        if fut.done():
            return  # resolved while journaling: nothing to re-publish
        await self.fleet.publish_work(
            block_hash, difficulty, work_type, self._tracer.id_for(block_hash),
        )
        self.supervisor.dispatched(block_hash)

    def _dispatch_abandoned(self, block_hash: str) -> None:
        """Supervisor abandon hook: reap an adopted, waiterless dispatch
        whose budget expired unresolved (clean abort — the zombie's waiters
        died with it; nothing is owed an answer any more)."""
        if block_hash not in self._adopted_orphan:
            return
        self._adopted_orphan.discard(block_hash)
        if self._future_waiters.get(block_hash):
            return  # a local request attached meanwhile: its refcount owns teardown
        fut = self.work_futures.get(block_hash)
        if fut is not None:
            self._drop_dispatch_state(block_hash)
            if not fut.done():
                fut.cancel()

    def _maybe_finish_adopted(self, block_hash: str) -> None:
        """Resolve-path reaper for adopted, waiterless dispatches: the
        moment their future resolves there is nothing left to wait for."""
        if block_hash not in self._adopted_orphan:
            return
        fut = self.work_futures.get(block_hash)
        if (
            fut is not None
            and fut.done()
            and not self._future_waiters.get(block_hash)
        ):
            self._adopted_orphan.discard(block_hash)
            self._drop_dispatch_state(block_hash)

    # ------------------------------------------------------------------
    # statistics (reference redis_db.py:25-52 aggregation)
    # ------------------------------------------------------------------

    async def all_statistics(self) -> dict:
        precache_total = int(await self.store.get("stats:precache") or 0)
        ondemand_total = int(await self.store.get("stats:ondemand") or 0)
        public_services = []
        private_services = {"count": 0, "precache": 0, "ondemand": 0}
        for service in await self.store.smembers("services"):
            info = await self.store.hgetall(f"service:{service}")
            entry = {
                "display": info.get("display", ""),
                "website": info.get("website", ""),
                "precache": int(info.get("precache", 0)),
                "ondemand": int(info.get("ondemand", 0)),
            }
            if info.get("public") == "Y":
                public_services.append(entry)
            else:
                private_services["count"] += 1
                private_services["precache"] += entry["precache"]
                private_services["ondemand"] += entry["ondemand"]
        return {
            "services": {"public": public_services, "private": private_services},
            "work": {"precache": precache_total, "ondemand": ondemand_total},
            # Additive over the reference's payload shape: how often the
            # orchestrator had to heal a lost work publish (republish loop).
            # A climbing value means workers are flapping or absent.
            "work_republished": self.work_republished,
        }

    # ------------------------------------------------------------------
    # result path (reference dpow_server.py:95-168)
    # ------------------------------------------------------------------

    async def client_update(
        self,
        account: str,
        work_type: str,
        block_rewarded: str,
        reply_to: Optional[str] = None,
    ) -> None:
        """Credit ``account`` (canonical spelling) and push its stats.

        ``reply_to``: the spelling the worker REPORTED — an xrb_-configured
        worker subscribes client/xrb_..., so the push must go to that topic
        even though accounting keys on the canonical nano_ form.
        """
        await self.store.hincrby(f"client:{account}", work_type, 1)
        stats = await self.store.hgetall(f"client:{account}")
        payload = {k: int(v) for k, v in stats.items()}
        payload["block_rewarded"] = block_rewarded
        await self.transport.publish(
            f"client/{reply_to or account}", json.dumps(payload), qos=QOS_1
        )

    async def client_result_handler(self, topic: str, content: str) -> None:
        if self.replica is not None:
            # Replica result-lane routing (docs/replication.md): a
            # three-segment topic result/{replica}/{type} is ADDRESSED.
            # Our own lane and the lanes of dead peers we adopted are
            # served here; a live peer's lane is its own business (it
            # hears the same publish on its shared subscription).
            segs = topic.split("/")
            if len(segs) >= 3:
                if not self.replica.serves_lane(segs[1]):
                    return
                # Addressed lanes carry JSON relay frames (peer→peer);
                # legacy worker payloads never start with '{'.
                if content.lstrip().startswith("{"):
                    await self._handle_result_relay(content)
                    return
        try:
            # Version-routed (transport/wire.py): a v1-capable worker
            # answers a binary dispatch with a binary RESULT frame — fixed
            # width nonce instead of a hex round-trip — while legacy ASCII
            # results parse byte-for-byte as before.
            block_hash, work, client, trace_id = wire.decode_result_any(content)
        except ValueError:
            return

        # Work still wanted? (hash deleted once its frontier moved on)
        available = await self.store.get(f"block:{block_hash}")
        if not available or available != WORK_PENDING:
            if (
                self.replica is not None
                and available
                and available != WORK_PENDING
            ):
                # Replicated: a PEER already elected the winner and stored
                # the work while our local waiters (a forward proxy, or a
                # concurrent dispatch) still hold an unresolved future.
                # Resolve it from the store now instead of leaving them to
                # the timeout-path store fallback.
                # Type read FIRST: resolving the future wakes the waiter,
                # whose teardown pops _forward_origins — an await between
                # set_result and _relay_origins would let that run first
                # and silently skip the relay (every other resolve site
                # keeps set_result → _relay_origins await-free).
                stored_type = (
                    await self.store.get(f"work-type:{block_hash}")
                    or WorkType.PRECACHE.value
                )
                # Only at the recorded target: stored work weaker than a
                # raised re-target must not resolve waiters (it bounces in
                # final validation) — they recover via their own
                # timeout-path frontier reset, as on the non-replica path.
                if await self._store_work_strong(block_hash, available):
                    fut = self.work_futures.get(block_hash)
                    if fut is not None and not fut.done():
                        fut.set_result(available)
                    await self._relay_origins(
                        block_hash, available, stored_type
                    )
                    self._maybe_finish_adopted(block_hash)
            self._m_results.inc(1, "stale")
            return

        work_type = await self.store.get(f"work-type:{block_hash}") or WorkType.PRECACHE.value

        difficulty = await self._recorded_difficulty(block_hash)
        try:
            nc.validate_work(block_hash, work, difficulty)
        except (nc.InvalidWork, nc.InvalidBlockHash):
            self._m_results.inc(1, "invalid")
            return

        # A VALID result (winning or not) proves workers are alive at the
        # CURRENT target; hold the supervisor's re-dispatch. Deliberately
        # after validation: a worker grinding a stale weaker target (its
        # re-target publish was lost) streams too-weak results, and
        # counting those as activity would suppress the exact re-publish
        # that heals it.
        self.supervisor.activity(block_hash)

        # Winner election: exactly one result claims the lock
        # (reference dpow_server.py:138).
        if not await self.store.setnx(
            f"block-lock:{block_hash}", "1", expire=self.config.winner_lock_expiry
        ):
            if self.replica is not None:
                # Every replica hears every shared-topic result; exactly
                # ONE wins the store election and runs the side effects
                # (cancel fan-out, credit). The losers still owe their
                # local waiters an answer: this work validated at the
                # current target above, so hand it over directly.
                fut = self.work_futures.get(block_hash)
                if fut is not None and not fut.done():
                    fut.set_result(work)
                await self._relay_origins(block_hash, work, work_type)
                self._maybe_finish_adopted(block_hash)
            self._m_results.inc(1, "lost_election")
            return

        self._m_results.inc(1, "winner")
        # Fleet attribution BEFORE the cover is torn down: the winning
        # nonce identifies the shard (disjoint ranges), and nonce - start
        # over the dispatch elapsed is the worker's EMA throughput sample.
        await self.fleet.on_winner(block_hash, work)
        self.fleet.forget(block_hash)
        if trace_id is not None:
            # Bind the worker-echoed trace id so winner/cancel marks land
            # even if this server never began the trace (restart
            # mid-flight). Only the WINNING result may rebind: any earlier
            # and a bogus/losing result carrying a forged id would hijack
            # the live request's trace before validation rejected it.
            self._tracer.alias(block_hash, trace_id)
        self._tracer.mark_hash(block_hash, "winner")
        # Read BEFORE resolving the future: the moment set_result runs, any
        # await below can hand the loop to the last waiter's teardown,
        # which untracks the dispatch — and the hedged flag with it.
        hedged = self.supervisor.was_hedged(block_hash)
        await self.store.set(f"block:{block_hash}", work, expire=self.config.block_expiry)
        # A precache dispatch holds its admission-window slot as a lease;
        # the winning result is what releases it (on-demand slots release
        # with their dispatch state instead — release_key no-ops there).
        self.admission.release_key(block_hash)
        # The speculative solve landed: flip the cache entry to ready so
        # the budget's hit accounting can tell solved from still-pending.
        self.precache.on_result(block_hash, work_type)

        future = self.work_futures.get(block_hash)
        if future is not None and not future.done():
            future.set_result(work)
        if self.replica is not None:
            # Forwarders (and, for adopted dispatches, the dead owner's
            # forwarders from its journal) get the answer on their
            # addressed lanes — before the cancel fan-out, so their
            # waiting proxies resolve as early as possible.
            await self._relay_origins(block_hash, work, work_type)
            self._maybe_finish_adopted(block_hash)

        # Tell everyone else to stop burning lanes on this hash.
        await self.transport.publish(f"cancel/{work_type}", block_hash, qos=QOS_1)
        if hedged:
            # Hedged dispatch recruited workers off the OTHER work topic;
            # they subscribe only that topic's cancel channel, so the
            # fan-out must mirror the hedge or they grind the resolved
            # hash until their own scans exhaust.
            other = (
                WorkType.PRECACHE.value
                if work_type == WorkType.ONDEMAND.value
                else WorkType.ONDEMAND.value
            )
            await self.transport.publish(f"cancel/{other}", block_hash, qos=QOS_1)
        self._m_cancels.inc()
        self._tracer.mark_hash(block_hash, "cancel")

        try:
            # Canonical spelling for ACCOUNTING (crediting the raw string
            # would split an xrb_-reporting worker's stats from its nano_
            # alias); the stats push still goes to the reported spelling,
            # which is the topic that worker actually subscribes.
            reported = client
            client = nc.validate_account(client)
        except nc.InvalidAccount:
            await self.transport.publish(
                f"client/{client}",
                json.dumps({"error": f"Work accepted but account {client} is invalid"}),
                qos=QOS_1,
            )
            return

        await asyncio.gather(
            self.client_update(client, work_type, block_hash, reply_to=reported),
            self.store.incrby(f"stats:{work_type}"),
            self.store.sadd("clients", client),
        )

    # ------------------------------------------------------------------
    # precache pipeline (reference dpow_server.py:170-227)
    # ------------------------------------------------------------------

    async def block_arrival_handler(
        self, block_hash: str, account: str, previous: Optional[str]
    ) -> None:
        self.last_block = self.clock.time()
        if not self.config.enable_precache:
            return
        if self.replica is not None:
            # Ring-ownership gate: every replica hears every node
            # confirmation, and without this each of N replicas would
            # score, admit, and DISPATCH the same frontier — N window
            # slots and N fleet publishes for one block, plus an N-way
            # race on the frontier swap. Route by block hash exactly as
            # the on-demand path does (_dispatch_ondemand): the one owner
            # precaches; a dead owner's confirmations are simply lost
            # until the ring heals, which is the correct price for
            # SPECULATIVE work (the next confirmation, or an on-demand
            # request, regenerates it).
            owner = self.replica.route(block_hash)
            if owner != self.replica.replica_id:
                self.precache.note_verdict("not_owner")
                return
        await self.precache.on_confirmation(block_hash, account, previous)

    async def block_arrival_ws_handler(self, data: dict) -> None:
        try:
            block = data["block"]
            if isinstance(block, str):
                block = json.loads(block)
            await self.block_arrival_handler(
                data["hash"], data["account"], block.get("previous")
            )
        except Exception:
            logger.error("unable to process block:\n%s", traceback.format_exc())

    # ------------------------------------------------------------------
    # service path (reference dpow_server.py:229-376)
    # ------------------------------------------------------------------

    def _difficulty_lock(self, block_hash: str) -> asyncio.Lock:
        """Per-hash lock serializing every block-difficulty write/publish
        (dispatcher and raisers) for one in-flight dispatch."""
        return self._difficulty_locks.setdefault(block_hash, asyncio.Lock())

    def _precache_retired(self, block_hash: str) -> None:
        """Precache retire hook (capacity evict / frontier supersede / shed
        unwind): the dispatch will never see its result. Cancelling the
        hash's future sends every coalesced on-demand waiter down the
        cancelled-under-us path in _dispatch_ondemand — store re-check,
        then a clean RetryRequest — instead of stranding them for their
        whole timeout on work nobody will deliver."""
        fut = self.work_futures.get(block_hash)
        if fut is not None and not fut.done():
            fut.cancel()

    def _add_origin(self, block_hash: str, origin: str) -> None:
        """Record one forwarder for a hash (ledger-tracked: every entry
        added here must leave through _pop_origins, or the relay table
        leaks — the forward-origin leak class)."""
        entries = self._forward_origins.setdefault(block_hash, set())
        if origin not in entries:
            entries.add(origin)
            obs.LEDGER.acquire("origin", (block_hash, origin))

    def _pop_origins(self, block_hash: str) -> Optional[Set[str]]:
        """Drop (and return) a hash's whole origin set — the ONLY removal
        path for origin entries, so the ledger discharge cannot be
        forgotten at a new teardown site."""
        origins = self._forward_origins.pop(block_hash, None)
        if origins:
            # Sorted: set iteration order varies with hash randomization,
            # and the ledger trace must be identical across same-seed
            # dpowsan runs.
            for origin in sorted(origins):
                obs.LEDGER.discharge("origin", (block_hash, origin))
        return origins

    def _drop_dispatch_state(self, block_hash: str) -> None:
        """Remove ALL per-dispatch side tables for a hash. Single place on
        purpose: every dict that lives-and-dies with a work_futures entry
        must be dropped together, or a new table added later silently leaks
        at whichever teardown site forgot it."""
        del self.work_futures[block_hash]
        obs.LEDGER.discharge("future", block_hash)
        self._dispatched_difficulty.pop(block_hash, None)
        self._difficulty_locks.pop(block_hash, None)
        self.supervisor.untrack(block_hash)
        self.fleet.forget(block_hash)
        ticket = self._dispatch_tickets.pop(block_hash, None)
        if ticket is not None:
            self.admission.release(ticket)
        self._forwarded.discard(block_hash)
        self._pop_origins(block_hash)
        self._adopted_orphan.discard(block_hash)
        if block_hash in self._journaled:
            # Fire-and-forget, like the counter writes: teardown is sync
            # and the journal record is advisory once the dispatch is
            # gone (an adopter finding a resolved hash just cleans up).
            self._journaled.discard(block_hash)
            if self.replica is not None:
                self._spawn(self.replica.forget_dispatch(block_hash))
        self._m_dispatches.set(len(self.work_futures))

    async def _authenticate(self, data: dict) -> str:
        service, api_key = str(data["user"]), str(data["api_key"])
        db_key = await self.store.hget(f"service:{service}", "api_key")
        if db_key is None or hash_key(api_key) != db_key:
            raise InvalidRequest("Invalid credentials")
        return service

    def _resolve_difficulty(self, data: dict) -> int:
        multiplier = data.get("multiplier")
        difficulty_hex = data.get("difficulty")
        try:
            if multiplier is not None:
                # multiplier overrides difficulty (reference service/README.md)
                return self.difficulty_model.resolve(multiplier=float(multiplier))
            if difficulty_hex is not None:
                return self.difficulty_model.resolve(difficulty_hex=str(difficulty_hex))
        except nc.InvalidMultiplier:
            raise InvalidRequest(
                f"Difficulty outside allowed range. Max multiplier: "
                f"{self.config.max_multiplier}"
            )
        except nc.InvalidDifficulty:
            raise InvalidRequest("Invalid difficulty")
        except (ValueError, TypeError):
            raise InvalidRequest("Invalid difficulty or multiplier")
        return self.config.base_difficulty

    def _resolve_timeout(self, data: dict) -> float:
        timeout = data.get("timeout", self.config.default_timeout)
        try:
            timeout = int(timeout)
            if not (1 <= timeout <= self.config.max_timeout):
                raise ValueError
        except (ValueError, TypeError):
            raise InvalidRequest(
                f"Timeout must be an integer between 1 and {int(self.config.max_timeout)}"
            )
        return float(timeout)

    async def service_handler(self, data: dict) -> dict:
        """Metrics shell around the request logic: in-flight gauge up for
        the duration, request-latency histogram observed on every exit path
        (labeled by the work type actually served, or "unresolved" when the
        request died before the precache/on-demand decision)."""
        t0 = self.clock.time()
        self._m_inflight.inc()
        served = {"work_type": "unresolved"}
        try:
            return await self._service_request(data, served)
        finally:
            self._m_inflight.dec()
            self._m_request_seconds.observe(
                self.clock.time() - t0, served["work_type"]
            )
            # Precache yield accounting: a request served from speculative
            # work is a hit, an on-demand solve is a miss, a request that
            # died unresolved is neither (it never reached the decision).
            self.precache.note_request(served["work_type"])

    async def _service_request(self, data: dict, served: dict) -> dict:
        if self.draining:
            # Retire-after-drain (autoscale actuator contract): this
            # replica is leaving rotation — refuse new work with the
            # standard busy shape so callers fail over to another face;
            # dispatches already in flight keep running to completion.
            raise Busy(self.config.busy_retry_after, reason="draining")
        if not {"hash", "user", "api_key"} <= data.keys():
            raise InvalidRequest(
                "Incorrect submission. Required information: user, api_key, hash"
            )
        service = await self._authenticate(data)
        throttler = self.service_throttlers.get(service)
        if throttler is None:
            throttler = self.service_throttlers[service] = Throttler(
                rate_limit=max(self.config.throttle, 0.1)
            )
        async with throttler:
            try:
                block_hash = nc.validate_block_hash(str(data["hash"]))
            except nc.InvalidBlockHash:
                raise InvalidRequest("Invalid hash")
            account = data.get("account")
            if account:
                try:
                    # validate_account owns canonicalization (xrb_ → nano_)
                    account = nc.validate_account(str(account))
                except nc.InvalidAccount:
                    raise InvalidRequest("Invalid account")
            difficulty = self._resolve_difficulty(data)
            timeout = self._resolve_timeout(data)
            # Quota ledger (sched/quota.py): one token per request. Soft
            # mode marks the request over-quota — first in line for load
            # shedding if a dispatch is needed and the window is full;
            # hard mode raises Busy here (429 + Retry-After, api.py).
            over_quota = await self.admission.consume_quota(service)
            self._tracer.begin(block_hash)  # stage: accept

            work = await self.store.get(f"block:{block_hash}")
            if work is None:
                await self.store.set(
                    f"block:{block_hash}", WORK_PENDING, expire=self.config.block_expiry
                )

            work_type = WorkType.ONDEMAND.value
            if work and work != WORK_PENDING:
                # Precache hit — but only if it is strong enough for the
                # requested difficulty (reference dpow_server.py:292-304).
                work_type = WorkType.PRECACHE.value
                precached_value = nc.work_value(block_hash, work)
                if self.difficulty_model.precache_usable(precached_value, difficulty):
                    # Reusing slightly-weak precache means the served
                    # difficulty IS the precached value (reference :303:
                    # "difficulty = precached_difficulty") — final
                    # validation must agree with the reuse policy.
                    difficulty = min(difficulty, precached_value)
                else:
                    work_type = WorkType.ONDEMAND.value
                    await self.store.set(
                        f"block:{block_hash}", WORK_PENDING, expire=self.config.block_expiry
                    )
                    # The 5 s winner lock from the precache result must not
                    # outlive the reset, or the fresh on-demand result would
                    # be discarded and the request would time out.
                    await self.store.delete(f"block-lock:{block_hash}")
                    # The cached solve bought nothing: free its budget slot.
                    self.precache.on_stale(block_hash)
                    logger.info(
                        "forcing ondemand for %s: precached value too weak", block_hash
                    )

            if work_type == WorkType.ONDEMAND.value:
                work = await self._dispatch_ondemand(
                    block_hash, account, difficulty, timeout,
                    service=service, over_quota=over_quota,
                )

            served["work_type"] = work_type
            self._m_requests.inc(1, work_type)
            self._spawn(self.store.hincrby(f"service:{service}", work_type))

            # Final validation: never hand a service bad work
            # (reference dpow_server.py:363-368, demoted there to a log line;
            # here an invalid result is an error reply).
            try:
                nc.validate_work(block_hash, work, difficulty)
            except nc.InvalidWork:
                logger.critical(
                    "work %s for %s failed final validation at %016x",
                    work, block_hash, difficulty,
                )
                raise RetryRequest()

            logger.info("request handled for %s -> %s : %s", service, work_type, block_hash)
            return {"work": work, "hash": block_hash}

    async def _dispatch_ondemand(
        self,
        block_hash: str,
        account: Optional[str],
        difficulty: int,
        timeout: float,
        service: str = "",
        over_quota: bool = False,
        allow_forward: bool = True,
    ) -> str:
        created = None
        ticket = None
        # One deadline for the whole dispatch: any time spent waiting in
        # the admission queue — or coalesced behind another request's
        # pending dispatch — comes OUT of this request's budget; a caller
        # that asked for 10 s must never wait ~20 (queue + work).
        deadline = self.clock.time() + timeout
        coalesced = False  # this request counts in dpow_coalesce_total once
        forward_installed = False  # this request installed the forward proxy
        while block_hash not in self.work_futures:
            if self.replica is not None and allow_forward:
                # Ring routing (replica/ring.py): a hash owned by a LIVE
                # peer is dispatched there — one admission slot, one
                # publish, one supervisor for the whole ring — and a local
                # PROXY future is installed for the shared result plane
                # (every replica hears every result) or the owner's
                # addressed relay to resolve. allow_forward=False on the
                # owner side keeps a forwarded dispatch local even if the
                # ring view shifted mid-flight: serving unpartitioned is
                # always correct, a forward cycle never is.
                owner = self.replica.route(block_hash)
                if owner != self.replica.replica_id:
                    proxy = asyncio.get_running_loop().create_future()
                    self.work_futures[block_hash] = proxy
                    obs.LEDGER.acquire("future", block_hash)
                    self._forwarded.add(block_hash)
                    self._dispatched_difficulty[block_hash] = difficulty
                    self._m_dispatches.set(len(self.work_futures))
                    self._tracer.mark_hash(block_hash, "queue")
                    # Supervised like a local dispatch: if the owner dies
                    # before its journal is adopted — or never dispatches —
                    # the grace window expires and _republish_work publishes
                    # the work from HERE (availability beats partitioning).
                    self.supervisor.track(block_hash, deadline)
                    try:
                        await self.store.set(
                            f"work-type:{block_hash}", WorkType.ONDEMAND.value,
                            expire=self.config.block_expiry,
                        )
                        await self._send_forward(
                            owner, block_hash, difficulty, deadline
                        )
                        self.supervisor.dispatched(block_hash)
                        self._tracer.mark_hash(block_hash, "publish")
                    except BaseException:
                        # Same identity-guarded cleanup as the dispatcher
                        # path: a failed forward must not strand a
                        # never-resolved proxy for later requests.
                        if self.work_futures.get(block_hash) is proxy:
                            # The identity guard above IS the nearest
                            # re-check after the awaits.
                            self._drop_dispatch_state(block_hash)
                        if not proxy.done():
                            proxy.cancel()
                        raise
                    forward_installed = True
                    break
            gate = (
                self._dispatch_gates.get(block_hash)
                if self.config.coalesce else None
            )
            if gate is not None:
                # COALESCE: another request is mid-dispatch for this very
                # hash (admission queue, store writes, publish). Attaching
                # behind its gate instead of queueing for our own window
                # slot is the whole point — N same-hash arrivals cost ONE
                # slot and ONE publish. Quota was already charged per
                # request upstream. Shielded: our per-request timeout must
                # not cancel the shared gate under the other waiters.
                # (Counted after the loop, not here: a gated request that
                # ends up PROMOTING to dispatcher was not served by another
                # request's dispatch and must not inflate the metric.)
                coalesced = True
                remaining = max(deadline - self.clock.time(), 0.001)
                try:
                    await asyncio.wait_for(asyncio.shield(gate), timeout=remaining)
                except asyncio.TimeoutError:
                    raise RequestTimeout()
                if block_hash not in self.work_futures:
                    # The dispatcher died instead of installing a dispatch
                    # (cancelled while queued for admission). A hash with
                    # work already IN FLIGHT — a precache publish, or a
                    # prior dispatch torn down between its publish and its
                    # result — can resolve in exactly this window, and the
                    # futures map forgets it the moment the teardown runs:
                    # the STORE, not the map, holds the answer. Without
                    # this check the promoted waiter re-dispatches the
                    # solved hash and strands until timeout — the result
                    # handler drops every later result at the
                    # not-WORK_PENDING check (dpowsan's coalesce scenario;
                    # pinned by test_chaos's promote-window race test).
                    solved = await self.store.get(f"block:{block_hash}")
                    if solved and solved != WORK_PENDING:
                        if nc.work_value(block_hash, solved) >= difficulty:
                            self._m_coalesce.inc(1, "gated")
                            return solved
                        # Solved, but below THIS request's target: final
                        # validation would bounce it as RetryRequest. Reset
                        # the frontier (the entry-path weak-precache idiom)
                        # so the promotion below re-dispatches at our
                        # difficulty and its results are accepted again.
                        await self.store.set(
                            f"block:{block_hash}", WORK_PENDING,
                            expire=self.config.block_expiry,
                        )
                        await self.store.delete(f"block-lock:{block_hash}")
                # Loop: the dispatch now exists (attach below), or the
                # dispatcher failed — in which case one of the gated
                # requests PROMOTES to dispatcher on its next pass, so a
                # single shed/crashed dispatcher cannot strand the rest.
                continue
            gate = asyncio.get_running_loop().create_future()
            if self.config.coalesce:
                self._dispatch_gates[block_hash] = gate
                obs.LEDGER.acquire("gate", block_hash)
            try:
                # Admission window (sched/window.py): a would-be dispatcher
                # needs a slot before it may create the dispatch. This may
                # wait in the fair queue (backpressure) or raise Busy (shed
                # / rejected → 429). With the default unbounded window it
                # grants synchronously — no await-gap is introduced.
                ticket = await self.admission.acquire_dispatch(
                    block_hash, service,
                    difficulty=difficulty,
                    deadline=deadline,
                    over_quota=over_quota,
                )
                if ticket.future is not None:
                    # The ticket WAITED in the admission queue (future is
                    # only set on the queued path — a synchronous grant
                    # never pays this check). While we queued, work for
                    # this hash that was already in flight — a precache
                    # publish, or a torn-down predecessor's late result —
                    # may have resolved into the store; dispatching now
                    # would publish a solved hash whose every result the
                    # handler drops as stale, stranding us to the deadline
                    # (dpowsan's bounded-window coalesce seeds; pinned in
                    # test_chaos).
                    solved = await self.store.get(f"block:{block_hash}")
                    if solved and solved != WORK_PENDING:
                        if nc.work_value(block_hash, solved) >= difficulty:
                            self.admission.release(ticket)
                            ticket = None
                            return solved
                        # Solved below THIS request's target (a weaker
                        # waiter's predecessor got there first): keep the
                        # slot, reset the frontier, and dispatch at our
                        # own difficulty below — same idiom as the entry
                        # path's too-weak precache reset.
                        await self.store.set(
                            f"block:{block_hash}", WORK_PENDING,
                            expire=self.config.block_expiry,
                        )
                        await self.store.delete(f"block-lock:{block_hash}")
                if block_hash in self.work_futures:
                    # A concurrent dispatcher won the hash while we waited
                    # in the queue or in the store read above (reachable
                    # with --no_coalesce, where no gate serializes
                    # dispatchers): the dispatch exists, hand the slot
                    # back and join it as a plain waiter. Placed AFTER the
                    # last await of this prologue on purpose — nothing may
                    # suspend between this membership check and the
                    # install below (DPOW801).
                    self.admission.release(ticket)
                    ticket = None
                    break
                # Reserve the entry synchronously — no await sits between
                # the membership check and this assignment — so concurrent
                # base- and raised-difficulty dispatches for the same hash
                # cannot both enter this block, double-publish, and clobber
                # each other's block-difficulty entries (the base path's
                # delete below would erase a raised entry and fail its
                # final validation).
                created = asyncio.get_running_loop().create_future()
                self.work_futures[block_hash] = created
                obs.LEDGER.acquire("future", block_hash)
                # The window slot travels with the dispatch state from here
                # on: _drop_dispatch_state releases it (every teardown path).
                # Ownership-transfer discipline (DPOW1102): record the new
                # owner FIRST, then neutralize the local handle — the
                # prologue `finally` below must see None, or it and the
                # teardown would both own the slot.
                obs.LEDGER.transfer("ticket", ticket, note="dispatch-table")
                self._dispatch_tickets[block_hash] = ticket
                ticket = None
                self._dispatched_difficulty[block_hash] = difficulty
                self._m_dispatches.set(len(self.work_futures))
                self._tracer.mark_hash(block_hash, "queue")
                # Supervision starts with the entry (deadline = this
                # waiter's budget); the supervisor holds fire until the
                # first publish is stamped via dispatched(), so it cannot
                # jump the dispatcher's difficulty-entry serialization
                # below.
                self.supervisor.track(block_hash, deadline)
                try:
                    if account:
                        self._spawn(
                            self.store.set(
                                f"account:{account}", block_hash, expire=self.config.account_expiry
                            )
                        )
                    await self.store.set(f"work-type:{block_hash}", WorkType.ONDEMAND.value,
                                         expire=self.config.block_expiry)
                    if self.replica is not None:
                        # Takeover journal (docs/replication.md): persist
                        # the minimal record a peer needs to adopt this
                        # dispatch BEFORE the publish — a crash between
                        # journal and publish is healed by the adopter's
                        # re-publish; the reverse order would strand the
                        # waiters of an unjournaled in-flight dispatch.
                        # StaleEpoch here means we are a ZOMBIE: a peer
                        # already owns everything we believe is ours —
                        # fail the dispatch instead of running it
                        # unsupervised under a dead epoch (the poll loop
                        # rejoins with a fresh epoch).
                        try:
                            await self.replica.journal_dispatch(
                                block_hash, difficulty,
                                WorkType.ONDEMAND.value, deadline,
                                origins=self._forward_origins.get(
                                    block_hash, ()
                                ),
                            )
                        except StaleEpoch:
                            raise RetryRequest()
                        self._journaled.add(block_hash)
                    # Serialized with concurrent raisers (_raise_lock): a
                    # raiser that slipped in while this dispatcher was
                    # suspended in the store writes above has already bumped
                    # `block-difficulty:` — writing (or, worse, deleting)
                    # our weaker target AFTER its bump would make the result
                    # handler accept too-weak work and bounce the raiser
                    # through RetryRequest, the exact hole the retarget path
                    # exists to close. Under the lock the in-memory
                    # high-water mark is authoritative.
                    async with self._difficulty_lock(block_hash):
                        effective = max(
                            difficulty,
                            self._dispatched_difficulty.get(block_hash, difficulty),
                        )
                        if effective != self.config.base_difficulty:
                            await self.store.set(
                                f"block-difficulty:{block_hash}",
                                f"{effective:016x}",
                                expire=self.config.difficulty_expiry,
                            )
                        else:
                            # A previous raised-difficulty dispatch for this
                            # hash may have timed out inside the 120 s TTL;
                            # its leftover entry would make the result
                            # handler validate THIS base-difficulty dispatch
                            # against the old higher target and discard
                            # valid work. Clear it so validation matches
                            # what was asked for.
                            await self.store.delete(f"block-difficulty:{block_hash}")
                        # Publish at the SAME effective target, inside the
                        # lock: the raiser's own QOS_0 publish can be lost,
                        # and a worker arriving between the two publishes
                        # would otherwise grind at a target the result
                        # handler no longer accepts — with nothing left to
                        # re-publish. Routed through the fleet coordinator:
                        # sharded across the announced fleet or broadcast
                        # (registry too small).
                        await self.fleet.publish_work(
                            block_hash, effective, WorkType.ONDEMAND.value,
                            self._tracer.id_for(block_hash),
                        )
                        self.supervisor.dispatched(block_hash)
                        self._tracer.mark_hash(block_hash, "publish")
                    # Void-dispatch re-check: a precache retire (frontier
                    # supersede / capacity evict) can delete `block:` in
                    # the window between _service_request's WORK_PENDING
                    # write and the future install above — its retire hook
                    # found no future to cancel yet, and the result
                    # handler drops every result for a hash whose key is
                    # gone, so the waiters would strand for their whole
                    # timeout. One store read per dispatch closes the
                    # window: key gone ⇒ dispatch void ⇒ cancel, and every
                    # waiter fails over through the cancelled-under-us
                    # store re-check below.
                    if (
                        await self.store.get(f"block:{block_hash}") is None
                        and not created.done()
                    ):
                        created.cancel()
                except BaseException:
                    # A failed dispatch must not leave a never-resolved
                    # future that later requests for this hash would
                    # silently wait on. Identity-guarded: by the time this
                    # cleanup runs, a waiter's teardown may already have
                    # removed our future and a NEW dispatch installed its
                    # own — popping by key would destroy the successor's
                    # future out from under it.
                    if self.work_futures.get(block_hash) is created:
                        # dpowlint: disable=DPOW801 — every side table lives and dies with the work_futures entry; the identity guard above re-validates them all after the awaits
                        self._drop_dispatch_state(block_hash)
                    if not created.done():
                        created.cancel()
                    raise
            finally:
                # A ticket still held HERE never made it into
                # _dispatch_tickets (a cancellation or store error in the
                # prologue between the grant and the transfer — e.g. inside
                # the queued-path store re-check above): hand the window
                # slot back, or with a bounded window every such exit
                # shrinks capacity forever (pinned by test_chaos's
                # cancelled-mid-recheck slot-release test).
                if ticket is not None:
                    self.admission.release(ticket)
                    ticket = None
                # Open the gate LAST — success or failure — so coalesced
                # requests either find the installed dispatch or promote.
                if self._dispatch_gates.get(block_hash) is gate:
                    del self._dispatch_gates[block_hash]
                    obs.LEDGER.discharge("gate", block_hash)
                if not gate.done():
                    gate.set_result(None)
            break
        timeout = max(deadline - self.clock.time(), 0.01)
        if created is None and not forward_installed and self.config.coalesce:
            # This request is served by someone else's dispatch — exactly
            # once per coalesced request: "gated" if it waited behind a
            # pending dispatcher, "attached" if the dispatch was already
            # live. A request that dispatched itself (created is not None,
            # gated-then-promoted included) or installed the forward proxy
            # (the ring owner's dispatch is "its own") counts nothing.
            self._m_coalesce.inc(1, "gated" if coalesced else "attached")
        # The dispatcher holds its OWN future: during its dispatch awaits it
        # is not yet counted as a waiter, so an impatient concurrent waiter
        # may have torn the map entry down already — a key lookup here would
        # KeyError. Awaiting the (then-cancelled) `created` instead falls
        # into the CancelledError store-check below, where a late-landing
        # result is still honored. Non-dispatchers run no awaits between the
        # membership check above and this line, so the key lookup is safe.
        fut = created if created is not None else self.work_futures[block_hash]
        self._future_waiters[block_hash] = self._future_waiters.get(block_hash, 0) + 1
        # A local waiter attaching to an ADOPTED takeover entry takes over
        # its teardown (refcount below); the orphan reaper stands down.
        self._adopted_orphan.discard(block_hash)
        # Deadline propagation: every waiter extends supervision to its own
        # budget (the latest deadline wins), so re-dispatch retries keep
        # healing for exactly as long as some waiter can still be answered
        # — and never longer.
        self.supervisor.track(block_hash, deadline)
        if created is not None and block_hash in self._journaled:
            pass  # the dispatcher journaled this deadline already
        elif block_hash in self._journaled:
            # A later waiter extended supervision past the journaled
            # deadline: refresh the takeover record so an adopter heals
            # for as long as some waiter can still be answered.
            self._spawn(self._rejournal(block_hash))
        try:
            if (
                created is None
                and block_hash in self._forwarded
                and difficulty > self._dispatched_difficulty.get(
                    block_hash, self.config.base_difficulty
                )
            ):
                # Raised-difficulty request joining a FORWARDED hash: the
                # dispatch lives at the ring owner — send it a raised
                # forward frame (the owner's own re-target path bumps the
                # store difficulty and re-publishes) instead of mutating
                # the dispatch from here. Serialized with concurrent
                # raisers (_difficulty_lock), like the local re-target
                # below: the rollback write after the forward await must
                # not clobber a higher target another raiser installed
                # while this one was suspended in the publish.
                async with self._difficulty_lock(block_hash):
                    current = self._dispatched_difficulty.get(
                        block_hash, self.config.base_difficulty
                    )
                    if (
                        difficulty > current
                        and self.work_futures.get(block_hash) is fut
                        and not fut.done()
                    ):
                        self._dispatched_difficulty[block_hash] = difficulty
                        try:
                            owner = self.replica.route(block_hash)
                            if owner != self.replica.replica_id:
                                await self._send_forward(
                                    owner, block_hash, difficulty, deadline
                                )
                            else:
                                # The ring owner is DEAD (route fell back
                                # local): a forward frame would loop to our
                                # own dispatch lane and raise nothing.
                                # Re-target from HERE — the same store bump
                                # + re-publish the supervisor republish
                                # would do at grace expiry, but now and at
                                # the raised target.
                                await self.store.set(
                                    f"block-difficulty:{block_hash}",
                                    f"{difficulty:016x}",
                                    expire=self.config.difficulty_expiry,
                                )
                                await self.fleet.publish_work(
                                    block_hash, difficulty,
                                    WorkType.ONDEMAND.value,
                                    self._tracer.id_for(block_hash),
                                )
                                self.supervisor.dispatched(block_hash)
                        except BaseException:
                            self._dispatched_difficulty[block_hash] = current
                            raise
            elif created is None and difficulty > self._dispatched_difficulty.get(
                block_hash, self.config.base_difficulty
            ):
                # The in-flight dispatch was published at a weaker target
                # than this request needs. Awaiting it anyway would hand us
                # too-weak work and force a RetryRequest at final validation
                # — so RE-TARGET instead: bump `block-difficulty:` (the
                # result handler now discards weaker results) and re-publish
                # at the raised target. The worker side threads the raise
                # into its running job (client/work_handler.py queue_work;
                # backend raise_difficulty). Inside the waiter try-block so a
                # failed publish still tears down our refcount.
                async with self._difficulty_lock(block_hash):
                    current = self._dispatched_difficulty.get(
                        block_hash, self.config.base_difficulty
                    )
                    # fut.done(): a result can land between the unlocked
                    # pre-check and here — re-targeting then would park a
                    # stale raised `block-difficulty:` (full TTL) and burn
                    # worker lanes on a hash whose result the handler will
                    # drop at the not-WORK_PENDING check.
                    if (
                        difficulty > current
                        and self.work_futures.get(block_hash) is fut
                        and not fut.done()
                    ):
                        # Bump the high-water mark only once BOTH the store
                        # write and the publish landed: bumping first with
                        # no rollback would make a transient store/broker
                        # error permanently disable re-targeting for this
                        # hash (every retry would see difficulty > current
                        # as false and skip the re-publish).
                        self._dispatched_difficulty[block_hash] = difficulty
                        try:
                            await self.store.set(
                                f"block-difficulty:{block_hash}",
                                f"{difficulty:016x}",
                                expire=self.config.difficulty_expiry,
                            )
                            # Re-plan at the raised target: the coordinator
                            # replaces the dispatch's shard table, so
                            # coverage and attribution follow the raise.
                            await self.fleet.publish_work(
                                block_hash,
                                difficulty,
                                WorkType.ONDEMAND.value,
                                self._tracer.id_for(block_hash),
                            )
                        except BaseException:
                            self._dispatched_difficulty[block_hash] = current
                            raise
                        self.supervisor.dispatched(block_hash)
                        logger.info(
                            "re-targeted in-flight %s to %016x", block_hash, difficulty
                        )
            work = await asyncio.wait_for(asyncio.shield(fut), timeout=timeout)
        except asyncio.CancelledError:
            # Future cancelled under us: the result may still have landed in
            # the store via client_result_handler (reference :340-345).
            work = await self.store.get(f"block:{block_hash}")
            if not work or work == WORK_PENDING:
                raise RetryRequest()
        except asyncio.TimeoutError:
            # Same store-beats-map rule as the CancelledError path: this
            # future can be a void re-dispatch of a hash whose result
            # landed while its predecessor's teardown raced the winner —
            # nothing will ever resolve it, but the work is sitting in the
            # store. Answer from the store before giving up the deadline.
            work = await self.store.get(f"block:{block_hash}")
            if not work or work == WORK_PENDING:
                raise RequestTimeout()
        finally:
            # Refcounted teardown: the future dies with its LAST waiter —
            # one impatient short-timeout request must not abort concurrent
            # waiters that still have timeout budget.
            remaining = self._future_waiters.get(block_hash, 1) - 1
            if remaining <= 0:
                self._future_waiters.pop(block_hash, None)
                # Identity-guarded: a waiter resumed late (e.g. out of the
                # CancelledError store-check above) must only tear down the
                # future IT awaited — by now the key may hold a successor
                # dispatch's fresh future, which must stay.
                if self.work_futures.get(block_hash) is fut:
                    # dpowlint: disable=DPOW801 — side tables live and die with the work_futures entry; the identity guard above re-validates them all after the awaits
                    self._drop_dispatch_state(block_hash)
                if not fut.done():
                    fut.cancel()
            else:
                self._future_waiters[block_hash] = remaining
        return work
