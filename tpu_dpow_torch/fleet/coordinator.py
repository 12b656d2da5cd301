"""FleetCoordinator: the one object the server's publish paths talk to.

Every work publish the orchestrator used to aim at the shared broadcast
topic now goes through here. Per dispatch the coordinator asks the planner
for a plan and either

  * SHARDED — one ranged payload per selected worker on that worker's
    private lane ``work/{type}/{worker_id}`` (fleet-aware clients subscribe
    their lane next to the broadcast topic; the nonce range rides the
    payload as the backward-compatible trailing field,
    transport/mqtt_codec.py), with the assignment table registered in the
    coverage tracker; or
  * BROADCAST — the reference's racing behavior on ``work/{type}``,
    whenever the registry is empty/stale/too small (planner fallback) or
    fleet mode is off.

The resilience supervisor's republish callback also lands here: a silent
SHARDED dispatch is healed shard-wise — live owners get their own shard
re-published (lost QoS-0 publish), dead owners' shards are handed to live
workers (planner.reassign) or, with nobody live to take them, broadcast as
ranged payloads any racer (including a legacy, range-ignoring client) can
pick up. A HEDGED escalation abandons coordination for the dispatch and
falls back to the full-space broadcast on both work topics — by that point
sharding has failed twice and raw redundancy is the right tool.

Metric accounting is exhaustive: every dispatch increments exactly one
``dpow_fleet_dispatch_total{mode=...}`` series, and the planned-redundancy
gauge tracks how many workers the last dispatch set racing (1 shard = 1).
"""

from __future__ import annotations

import asyncio
from typing import Dict, List, Optional, Tuple

from .. import obs
from ..transport import QOS_0
from ..transport import wire
from ..transport.mqtt_codec import encode_work_payload
from ..utils.logging import get_logger
from .cover import BROADCAST_OWNER, CoverageTracker
from .planner import BROADCAST, SHARDED, FleetPlanner, Plan
from .registry import WorkerRegistry

logger = get_logger("tpu_dpow_torch.fleet")

#: Topic fleet-aware clients announce on (QoS 1; server subscribes fleet/#).
ANNOUNCE_TOPIC = "fleet/announce"


def work_topic(work_type: str, worker_id: Optional[str] = None) -> str:
    """Shared broadcast topic, or a worker's private sharded-dispatch lane."""
    return f"work/{work_type}/{worker_id}" if worker_id else f"work/{work_type}"


class FleetCoordinator:
    def __init__(
        self,
        registry: WorkerRegistry,
        planner: FleetPlanner,
        cover: CoverageTracker,
        transport,
        *,
        clock,
        enabled: bool = True,
        codec_v1: bool = True,
        lane_flush: bool = False,
    ):
        self.registry = registry
        self.planner = planner
        self.cover = cover
        self.transport = transport
        self.clock = clock
        self.enabled = enabled
        # Wire-codec policy (transport/wire.py): with codec_v1 the server
        # emits binary v1 frames on the private lanes of workers that
        # ANNOUNCED the capability — one batched frame per lane per flush —
        # and ASCII v0 everywhere else (broadcast topics have an unknown
        # audience; legacy racers must keep parsing byte-for-byte). False
        # (--codec v0) pins every publish to the legacy grammar.
        self.codec_v1 = codec_v1
        # Cross-dispatch micro-batching (--lane_flush): initial dispatches buffer their lane items for ONE
        # event-loop tick (call_soon flush) so DIFFERENT hashes dispatched
        # in the same tick share a single WORK_BATCH frame. Costs one tick
        # of publish latency per dispatch; only v1 lanes buffer (a v0 lane
        # publishes per item anyway), and the supervisor's republish path
        # never defers — its re-cover bookkeeping requires the lane
        # publish to have LANDED before a shard is recorded as moved.
        self.lane_flush = lane_flush
        self._lane_buf: Dict[Tuple[str, str], list] = {}
        self._flush_scheduled = False
        # Retained flush tasks (dpowlint DPOW301): the loop holds only
        # weak refs, so an unretained ensure_future is GC-cancellable
        # mid-publish.
        self._flush_tasks: set = set()
        reg = obs.get_registry()
        self._m_dispatch = reg.counter(
            "dpow_fleet_dispatch_total",
            "Work dispatches, by delivery mode", ("mode",))
        self._m_recovered = reg.counter(
            "dpow_fleet_ranges_recovered_total",
            "Shards re-covered after their worker died or went silent")
        self._m_redundancy = reg.gauge(
            "dpow_fleet_redundancy_ratio",
            "Workers racing the most recent dispatch (sharded = 1 per "
            "nonce, broadcast = the whole registered fleet)")

    # -- codec-aware publish primitives --------------------------------

    def _peer_v1(self, worker_id: str) -> bool:
        """May this worker's private lane carry binary v1 frames? Only if
        the server's codec policy allows it AND the worker advertised the
        capability on its announce (downgrade negotiation, docs/
        specification.md)."""
        if not self.codec_v1:
            return False
        info = self.registry.get(worker_id)
        return info is not None and info.codec >= 1

    async def _publish_lane(
        self,
        work_type: str,
        worker_id: str,
        items: List[Tuple[str, int, Optional[str], Optional[tuple]]],
        defer: bool = False,
    ) -> None:
        """Everything one worker gets this flush, on its private lane: ONE
        v1 frame (batched past one item) for a v1-capable peer, else one
        legacy ASCII publish per item. A v1 encode failure (malformed
        field) falls back to v0 rather than dropping the dispatch.

        ``defer=True`` (initial dispatches under --lane_flush) parks the
        items in the per-lane tick buffer instead: a call_soon-scheduled
        flush packs everything the lane accumulated this event-loop tick —
        across DIFFERENT dispatches — into one WORK_BATCH frame."""
        if defer and self.lane_flush and self._peer_v1(worker_id):
            self._lane_buf.setdefault((work_type, worker_id), []).extend(items)
            if not self._flush_scheduled:
                self._flush_scheduled = True
                asyncio.get_running_loop().call_soon(self._flush_lanes)
            return
        topic = work_topic(work_type, worker_id)
        if self._peer_v1(worker_id):
            try:
                payload = wire.encode_work_items(items)
            except ValueError:
                logger.warning(
                    "v1 encode failed for lane %s; falling back to v0", topic
                )
            else:
                wire.count_encoded(
                    "v1", "work" if len(items) == 1 else "work_batch", len(items)
                )
                await self.transport.publish(topic, payload, qos=QOS_0)
                return
        elif self.codec_v1:
            wire.M_DOWNGRADE.inc()
        for block_hash, difficulty, trace_id, nonce_range in items:
            await self.transport.publish(
                topic,
                encode_work_payload(block_hash, difficulty, trace_id, nonce_range),
                qos=QOS_0,
            )
            wire.count_encoded("v0", "work")

    def _flush_lanes(self) -> None:
        """call_soon callback: drain the tick buffer in one retained task.
        Runs at most once per scheduling tick — every dispatch buffered
        before the loop reached this callback rides the same flush."""
        self._flush_scheduled = False
        buf, self._lane_buf = self._lane_buf, {}
        if not buf:
            return
        task = asyncio.ensure_future(self._drain_lanes(buf))
        self._flush_tasks.add(task)
        task.add_done_callback(self._flush_tasks.discard)

    async def _drain_lanes(
        self, buf: Dict[Tuple[str, str], list]
    ) -> None:
        for (work_type, worker_id), items in buf.items():
            try:
                await self._publish_lane(work_type, worker_id, items)
            except Exception:
                logger.exception(
                    "lane flush to %s failed (%d item(s) dropped; the "
                    "supervisor republish heals them)", worker_id, len(items),
                )

    async def _publish_assignments(
        self,
        block_hash: str,
        difficulty: int,
        work_type: str,
        trace_id: Optional[str],
        assignments,
    ) -> None:
        """Fan one dispatch's shard table out, grouped per worker lane so a
        worker holding several shards receives one batched frame."""
        by_worker: Dict[str, list] = {}
        for a in assignments:
            by_worker.setdefault(a.worker_id, []).append(a)
        for worker_id, shards in by_worker.items():
            await self._publish_lane(
                work_type,
                worker_id,
                [
                    (block_hash, difficulty, trace_id, (a.start, a.length))
                    for a in shards
                ],
                defer=True,
            )

    async def _publish_broadcast(
        self,
        work_type: str,
        block_hash: str,
        difficulty: int,
        trace_id: Optional[str],
        nonce_range: Optional[tuple] = None,
    ) -> None:
        """Shared-topic publish: ALWAYS legacy ASCII — the audience is
        unknown and may include pre-v1 racers."""
        await self.transport.publish(
            work_topic(work_type),
            encode_work_payload(block_hash, difficulty, trace_id, nonce_range),
            qos=QOS_0,
        )
        wire.count_encoded("v0", "work")

    # -- dispatch ------------------------------------------------------

    async def publish_work(
        self,
        block_hash: str,
        difficulty: int,
        work_type: str,
        trace_id: Optional[str] = None,
    ) -> str:
        """Publish one dispatch; returns the mode used ('sharded' |
        'broadcast'). Counts every call in dpow_fleet_dispatch_total."""
        plan = self.planner.plan(difficulty, work_type) if self.enabled else Plan(
            mode=BROADCAST, racers=1
        )
        if plan.mode == SHARDED:
            await self._publish_assignments(
                block_hash, difficulty, work_type, trace_id, plan.assignments
            )
            self.cover.begin(
                block_hash, work_type, difficulty, plan.assignments,
                self.clock.time(),
            )
            self._m_dispatch.inc(1, SHARDED)
            # Disjoint shards: exactly one worker per nonce.
            self._m_redundancy.set(1.0)
            logger.debug(
                "sharded %s across %d workers", block_hash, len(plan.assignments)
            )
        else:
            await self._publish_broadcast(
                work_type, block_hash, difficulty, trace_id
            )
            self.cover.forget(block_hash)  # a re-target may downgrade modes
            self._m_dispatch.inc(1, BROADCAST)
            self._m_redundancy.set(float(max(plan.racers, 1)))
        return plan.mode

    # -- supervisor republish path -------------------------------------

    async def republish(
        self,
        block_hash: str,
        difficulty: int,
        work_type: str,
        hedged: bool,
        trace_id: Optional[str] = None,
    ) -> bool:
        """Heal a silent dispatch; returns True iff something was
        published (the supervisor re-arms its grace window only then)."""
        if hedged or not self.cover.tracked(block_hash):
            # Escalation (or a broadcast dispatch): raw redundancy. The
            # hedged fan-out recruits the secondary topic's pool exactly as
            # the pre-fleet supervisor did; coordination is abandoned so a
            # later winner is not mis-attributed to a stale shard table.
            self.cover.forget(block_hash)
            await self._publish_broadcast(
                work_type, block_hash, difficulty, trace_id
            )
            if hedged:
                other = "precache" if work_type == "ondemand" else "ondemand"
                await self._publish_broadcast(
                    other, block_hash, difficulty, trace_id
                )
            return True
        plan = self.cover.republish_plan(block_hash)
        if plan is None:
            return False
        lane, orphaned, rebroadcast = plan
        now = self.clock.time()
        published = False
        # Everything lane-bound this heal is COLLECTED first and flushed
        # grouped per worker at the end: an owner's re-publish and a shard
        # it just took over ride one batched frame instead of two publishes
        # (transport/wire.py WORK_BATCH; v0 peers get per-item publishes).
        # Re-cover BOOKKEEPING (cover.reassigned + the recovered counter)
        # is deferred with the publish: recording a new owner before its
        # lane publish lands would let a transport failure mark a shard
        # covered by a worker that never heard of it.
        pending: Dict[str, list] = {}
        recover_after: Dict[str, list] = {}
        for a in lane:
            # Freshest shard per live owner, to its own lane: the original
            # QoS-0 publish may have fired mid-reconnect. A re-send of the
            # range the client already scans dedups clean (no rebase).
            pending.setdefault(a.worker_id, []).append(a)
            published = True
        # Reassignment prefers workers with no shard of this dispatch yet:
        # handing a second shard to a current assignee rebases its single
        # running job away from its own shard.
        taken = self.cover.current_owners(block_hash)
        for a in orphaned:
            replacement = self.planner.reassign(
                a, exclude=taken, work_type=work_type
            ) or self.planner.reassign(a, work_type=work_type)
            if replacement is not None:
                taken.add(replacement.worker_id)
                pending.setdefault(replacement.worker_id, []).append(replacement)
                recover_after.setdefault(replacement.worker_id, []).append(
                    (a, replacement)
                )
                logger.info(
                    "re-covering shard [%016x+%016x] of %s: %s -> %s",
                    a.start, a.length, block_hash, a.worker_id,
                    replacement.worker_id,
                )
            else:
                # Nobody live to take it: broadcast the RANGED payload —
                # fleet clients honor the range, a legacy client ignores it
                # and races the full space (correct either way). Marked in
                # the cover table so later fires re-broadcast WITHOUT
                # re-counting the same shard as freshly re-covered.
                await self._publish_broadcast(
                    work_type, block_hash, difficulty, trace_id,
                    (a.start, a.length),
                )
                self.cover.reassigned(
                    block_hash, a, BROADCAST_OWNER, now
                )
                logger.info(
                    "broadcast orphaned shard [%016x+%016x] of %s (no live "
                    "worker to reassign)", a.start, a.length, block_hash,
                )
                self._m_recovered.inc()
                published = True
        for a in rebroadcast:
            await self._publish_broadcast(
                work_type, block_hash, difficulty, trace_id,
                (a.start, a.length),
            )
            published = True
        for worker_id, shards in pending.items():
            await self._publish_lane(
                work_type,
                worker_id,
                [
                    (block_hash, difficulty, trace_id, (a.start, a.length))
                    for a in shards
                ],
            )
            # The lane publish landed: NOW the re-covers it carried are
            # real — record the new owners and count them.
            for orig, repl in recover_after.get(worker_id, ()):
                self.cover.reassigned(block_hash, orig, repl.worker_id, now)
                self._m_recovered.inc()
            published = True
        return published

    # -- result / teardown hooks ---------------------------------------

    async def on_announce(self, payload: str) -> None:
        await self.registry.handle_announce(payload)

    async def on_winner(self, block_hash: str, work: str) -> None:
        """Attribute a winning result to its shard: EMA throughput sample
        + liveness touch for the owning worker."""
        try:
            nonce = int(work, 16)
        except ValueError:
            return
        sample = self.cover.resolve(block_hash, nonce, self.clock.time())
        if sample is None:
            return
        worker_id, hashes, elapsed = sample
        if not self.registry.is_live(worker_id):
            # The shard's recorded owner is dead — its orphaned range was
            # broadcast (no live replacement) and whoever actually solved
            # it is unknown. Attributing the win would RESURRECT the dead
            # worker (touch stamps it live, the next plan shards onto a
            # lane nobody subscribes) and feed its EMA a bogus sample.
            return
        self.registry.touch(worker_id)
        ema = await self.registry.observe_result(worker_id, hashes, elapsed)
        if ema is not None:
            logger.debug(
                "attributed win on %s to %s (%.3g H over %.3gs; ema %.3g H/s)",
                block_hash, worker_id, hashes, elapsed, ema,
            )

    def forget(self, block_hash: str) -> None:
        self.cover.forget(block_hash)
