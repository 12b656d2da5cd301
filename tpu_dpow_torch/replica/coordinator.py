"""ReplicaCoordinator: the one object a replicated DpowServer talks to.

Owns the registry (membership + heartbeats), the ownership ring, the
dispatch journal, and the leaderless takeover protocol:

  * every replica heartbeats and observes its peers on one poll cadence;
  * a peer whose heartbeat seq stalls for a full ttl is a takeover
    candidate; ONE replica wins the per-death adoption claim (store setnx —
    the same winner-lock idiom the result path already uses), fences the
    dead epoch, and adopts the journal: each record is handed to the
    server's ``adopt`` callback, which re-arms a DispatchSupervisor entry,
    re-publishes the work (re-covering fleet shards through the existing
    coordinator), and serves late results for the hash from then on;
  * a fenced replica that is not actually dead (zombie) has every further
    write refused at the store (fence.py) and — once it notices — rejoins
    with a fresh epoch instead of fighting its adopter.

The coordinator never decides ownership by talking to peers: the ring is a
pure function of the observed live member set (replica/ring.py), so any
replica answers "whose request is this" locally, and transient view splits
degrade to serving unpartitioned — never to dropping or double-serving
(the shared store's winner lock keeps results exactly-once regardless).
"""

from __future__ import annotations

import time
from typing import Awaitable, Callable, Dict, Iterable, Optional, Set

from .. import obs
from ..resilience.clock import Clock, SystemClock
from ..utils.logging import get_logger
from . import fence
from .registry import ReplicaRegistry
from .ring import HashRing

logger = get_logger("tpu_dpow_torch.replica")

#: adopt callback: (block_hash, journal record, dead replica id) → True if
#: the dispatch was taken over (or served/cleaned from the store).
AdoptFn = Callable[[str, Dict, str], Awaitable[bool]]


def dispatch_topic(replica_id: str) -> str:
    """A replica's forwarded-dispatch lane (QoS 1; docs/replication.md)."""
    return f"replica/dispatch/{replica_id}"


def result_lane(replica_id: str, work_type: str) -> str:
    """A replica's addressed result-relay lane, replica↔replica ONLY
    (docs/specification.md): JSON ``{"v":1, hash, work, type, from,
    epoch}`` frames from the replica that resolved a hash back to one
    that forwarded it. Workers keep publishing on the legacy two-segment
    ``result/{type}`` topics, which every replica hears on its shared
    subscription."""
    return f"result/{replica_id}/{work_type}"


class ReplicaCoordinator:
    def __init__(
        self,
        store,
        *,
        replica_id: str,
        clock: Optional[Clock] = None,
        ttl: float = 10.0,
        heartbeat_interval: float = 2.0,
        adopt: Optional[AdoptFn] = None,
    ):
        if not replica_id or any(c in replica_id for c in "/+#"):
            raise ValueError(
                f"replica id {replica_id!r} must be a non-empty, "
                "topic-safe string (no '/', '+', '#')"
            )
        self.store = store
        self.replica_id = replica_id
        self.clock = clock or SystemClock()
        self.ttl = ttl
        self.heartbeat_interval = heartbeat_interval
        self._adopt_cb = adopt
        self.registry = ReplicaRegistry(
            store, replica_id, clock=self.clock, ttl=ttl
        )
        #: dead replica ids whose dispatches this replica adopted — their
        #: result lanes are served here from adoption on.
        self.adopted_from: Set[str] = set()
        #: adopted ids whose journal did NOT fully drain (an adopt callback
        #: failed): the next poll must retry instead of standing down.
        self._adoption_incomplete: Set[str] = set()
        reg = obs.get_registry()
        self._m_takeovers = reg.counter(
            "dpow_replica_takeovers_total",
            "In-flight dispatches adopted from a dead replica's journal")
        self._m_requests = reg.counter(
            "dpow_replica_requests_total",
            "On-demand dispatch routing decisions, by route", ("route",))
        self._m_lane_ignored = reg.counter(
            "dpow_replica_lane_ignored_total",
            "Results addressed to another live replica's lane, ignored here")
        self._m_zombie = reg.counter(
            "dpow_replica_zombie_ignored_total",
            "Replica-plane publishes refused because the sender's epoch is "
            "behind its fence (zombie replica)", ("kind",))
        self._m_relays = reg.counter(
            "dpow_replica_relays_total",
            "Cross-replica result relays, by event", ("event",))

    # -- lifecycle -----------------------------------------------------

    async def start(self) -> None:
        await self.registry.join()
        await self.registry.observe()

    async def stop(self) -> None:
        await self.registry.leave()

    async def run(self) -> None:
        """Heartbeat + observe + takeover, forever, on the injectable
        clock (the server owns the task)."""
        while True:
            await self.clock.sleep(self.heartbeat_interval)
            try:
                await self.poll()
            except Exception:
                logger.exception("replica poll failed")

    async def poll(self) -> None:
        """One cadence tick, public so FakeClock tests can drive it."""
        if not await self.registry.heartbeat():
            # Zombie self-heal: our old epoch was adopted while we were
            # away; rejoin as a fresh member instead of standing dead.
            await self.registry.join()
            return
        await self.registry.observe()
        # A peer we adopted that is LIVE again rejoined at a fresh epoch
        # (retirement deleted its old record — only a rejoin recreates
        # it): its result lane is its own again, and its NEXT death is a
        # new death event we must be willing to adopt.
        for rid in list(self.adopted_from):
            if self.registry.is_live(rid):
                self.adopted_from.discard(rid)
                self._adoption_incomplete.discard(rid)
        # An incomplete id whose member record vanished was finished by a
        # peer that re-won the re-opened election: nothing left to retry.
        for rid in list(self._adoption_incomplete):
            if self.registry.peer_epoch(rid) == 0:
                self._adoption_incomplete.discard(rid)
        for peer in self.registry.stale_peers():
            await self._maybe_adopt(peer.replica_id, peer.epoch)

    # -- ownership routing ---------------------------------------------

    def ring(self) -> HashRing:
        return self.registry.ring()

    def route(self, block_hash: str) -> str:
        """The replica that should dispatch ``block_hash``: the ring owner
        when it is live, ourselves otherwise (availability beats
        partitioning — serving unpartitioned is always correct)."""
        owner = self.registry.ring().owner_of(block_hash)
        if owner is None or owner == self.replica_id:
            self._m_requests.inc(1, "own")
            return self.replica_id
        if not self.registry.is_live(owner):
            self._m_requests.inc(1, "fallback_local")
            return self.replica_id
        self._m_requests.inc(1, "forward")
        return owner

    async def publish_allowed(self, sender_id: str, epoch: int, kind: str) -> bool:
        """Receiver-side zombie fencing for the replica plane: a forwarded
        dispatch or result relay stamped with an epoch BEHIND the sender's
        fence comes from a replica that was declared dead and adopted —
        honoring it would resurrect state its adopter now owns. The fence
        read is authoritative over any in-memory peer view: it is the same
        store cell the adopter raised."""
        if not sender_id:
            return False
        fence_floor = await fence.read_fence(self.store, sender_id)
        if epoch < fence_floor:
            self._m_zombie.inc(1, kind)
            logger.warning(
                "ignoring %s from fenced replica %s (epoch %d < fence %d)",
                kind, sender_id, epoch, fence_floor,
            )
            return False
        return True

    def count_relay(self, event: str) -> None:
        self._m_relays.inc(1, event)

    def serves_lane(self, lane_replica_id: str) -> bool:
        """Should a result addressed to ``result/{lane_replica_id}/…`` be
        processed here? Our own lane always; a dead peer's lane once we
        adopted its dispatches (late results for adopted hashes)."""
        if lane_replica_id == self.replica_id:
            return True
        if lane_replica_id in self.adopted_from:
            return True
        self._m_lane_ignored.inc()
        return False

    # -- dispatch journal ----------------------------------------------

    async def journal_dispatch(
        self,
        block_hash: str,
        difficulty: int,
        work_type: str,
        deadline: float,
        origins: Iterable[str] = (),
    ) -> None:
        """Persist the minimal record takeover needs, at dispatch time.
        Raises StaleEpoch if we are a zombie — the dispatch must then fail
        rather than run unsupervised under a dead epoch."""
        writer = self.registry.writer
        if writer is None:
            raise RuntimeError("journal_dispatch before start()")
        now = self.clock.time()
        await writer.journal_dispatch(
            block_hash,
            {
                "difficulty": int(difficulty),
                "work_type": work_type,
                # Absolute deadline on the writer's clock (exact when the
                # topology shares a clock: in-process replicas, Linux
                # CLOCK_MONOTONIC across processes on one host) plus the
                # remaining budget + a coarse wall stamp, so an adopter on
                # a different clock can still reconstruct a bounded budget.
                "deadline": deadline,
                "remaining": max(deadline - now, 0.0),
                # dpowlint: disable=DPOW101 — cross-process stamp; monotonic clocks do not travel
                "wall": time.time(),
                # Replicas that forwarded this hash here: an adopter relays
                # the eventual result to their lanes (late service).
                "origins": sorted(set(origins)),
            },
        )

    async def forget_dispatch(self, block_hash: str) -> None:
        """Journal teardown with the dispatch state. Best-effort: once we
        are fenced the record belongs to the adopter, not us."""
        writer = self.registry.writer
        if writer is None:
            return
        try:
            await writer.forget_dispatch(block_hash)
        except fence.StaleEpoch:
            pass

    @staticmethod
    def adopted_deadline(record: Dict, now: float, floor: float = 1.0) -> float:
        """The budget an adopted dispatch still has, on the adopter's
        clock: the journaled absolute deadline when the clocks agree. A
        record with ANY budget left is bounded below by a small floor so
        one adopted at the wire is still re-published once instead of
        aborted unseen; a record whose budget is FULLY spent on both
        clocks returns ``now`` itself — the adopter's clean-abort branch
        (every waiter's deadline has passed; re-publishing is dead work)."""
        try:
            deadline = float(record.get("deadline", 0.0))
            remaining = float(record.get("remaining", 0.0))
            wall = float(record.get("wall", 0.0))
        except (TypeError, ValueError):
            return now + floor
        # dpowlint: disable=DPOW101 — comparing against the record's wall stamp needs wall clock
        elapsed_wall = max(time.time() - wall, 0.0) if wall else 0.0
        budget = remaining - elapsed_wall
        if now < deadline <= now + remaining:
            # The journaled absolute deadline is coherent with our clock
            # (shared-clock topology): honor it exactly.
            return deadline
        if budget <= 0.0 and deadline <= now:
            return now  # expired on the wall AND the journaled clock
        return now + max(budget, floor)

    # -- takeover ------------------------------------------------------

    async def _maybe_adopt(self, dead_id: str, dead_epoch: int) -> None:
        if (
            dead_id in self.adopted_from
            and dead_id not in self._adoption_incomplete
            and not self.registry.is_live(dead_id)
        ):
            return  # already fully adopted this incarnation
        won = await fence.claim_adoption(
            self.store, dead_id, dead_epoch, expire=max(self.ttl * 4, 20.0)
        )
        if not won:
            return  # another replica is (or was) the adopter
        try:
            # dpowlint: disable=DPOW801 — the adoption setnx above is the real election (one winner per death event); the pass's membership-set mutations are idempotent under it
            await self._adopt_pass(dead_id, dead_epoch)
        except Exception:
            # Crashed mid-pass (store hiccup, logic error) while HOLDING
            # the claim: re-open the election NOW instead of stranding
            # the remaining journal records until the claim TTL expires —
            # the next claimant (us on the next poll, or any peer)
            # re-adopts only what remains. Same reasoning as the
            # leftovers branch inside _adopt_pass.
            # dpowlint: disable=DPOW801 — same setnx serialization; the incomplete-marker add is idempotent
            self._adoption_incomplete.add(dead_id)
            await fence.release_adoption(self.store, dead_id, dead_epoch)
            raise
        except BaseException:
            # Torn down mid-pass (poll-task cancel at close(), or a
            # genuine adopter death simulated by cancel in tests): the
            # STORE claim is deliberately left to its TTL — that
            # re-opened election IS the designed crash recovery, and
            # releasing it here would let a zombie of this process mask
            # the adopter-crash path. The process-local LeakLedger still
            # records the abandonment (no awaits on this path — it must
            # survive GeneratorExit): this incarnation no longer owns a
            # claim it will never finish.
            obs.LEDGER.discharge(
                "claim", (dead_id, int(dead_epoch)), op="lapse"
            )
            raise

    async def _adopt_pass(self, dead_id: str, dead_epoch: int) -> None:
        """One claimed adoption pass: fence, drain the journal, then
        either re-open the election (leftovers) or retire the member
        record. The CALLER holds the adoption claim and re-opens the
        election if this pass dies with it held."""
        logger.warning(
            "replica %s adopting dead peer %s (epoch %d)",
            self.replica_id, dead_id, dead_epoch,
        )
        # Fence FIRST: from here the zombie cannot journal new dispatches
        # or heartbeat back to life under the dead epoch. The member
        # RECORD stays until the journal drains: peers keep seeing the
        # dead id as stale, so if WE die mid-takeover the adoption claim's
        # TTL re-opens the election and a peer re-adopts the leftovers —
        # deleting the record up front dropped the id from every view and
        # orphaned them forever.
        await fence.raise_fence(self.store, dead_id, dead_epoch + 1)
        self.adopted_from.add(dead_id)
        adopted = 0
        seen: Set[str] = set()

        def _rec_epoch(r: Dict) -> int:
            try:
                return int(r.get("epoch", 0) or 0)
            except (TypeError, ValueError):
                return 0

        # Bounded re-read: a journal write that passed its fence check
        # before our raise can land after a first read — one more pass
        # after the fence settles catches it.
        for _ in range(3):
            records = await fence.read_dispatches(self.store, dead_id)
            fresh = [(h, r) for h, r in records if h not in seen]
            if not fresh:
                break
            for block_hash, record in fresh:
                seen.add(block_hash)
                if _rec_epoch(record) > dead_epoch:
                    # Journaled by a LATER incarnation of the same id: the
                    # zombie rejoined (fresh epoch, above the fence) while
                    # we were adopting and this is a LIVE dispatch — not
                    # part of the death event we claimed. Adopting it would
                    # double-dispatch it and delete the live replica's
                    # takeover record.
                    continue
                ok = True
                if self._adopt_cb is not None:
                    try:
                        ok = await self._adopt_cb(block_hash, record, dead_id)
                    except Exception:
                        logger.exception(
                            "adoption of %s from %s failed", block_hash, dead_id
                        )
                        ok = False
                if ok:
                    adopted += 1
                    self._m_takeovers.inc()
                    await fence.drop_adopted_dispatch(
                        self.store, dead_id, block_hash
                    )
        leftovers = [
            (h, r)
            for h, r in await fence.read_dispatches(self.store, dead_id)
            if _rec_epoch(r) <= dead_epoch
        ]
        if leftovers:
            # Adoption callback failures left records behind: keep the
            # member record so the death stays detectable, and re-open the
            # election NOW — the next poll (ours or a peer's) re-claims
            # and adopts only the leftovers, instead of the whole ring
            # standing down until the claim TTL expires.
            self._adoption_incomplete.add(dead_id)
            await fence.release_adoption(self.store, dead_id, dead_epoch)
            logger.warning(
                "replica %s adopted %d dispatch(es) from %s; %d remain "
                "for re-adoption on the next poll",
                self.replica_id, adopted, dead_id, len(leftovers),
            )
            return
        self._adoption_incomplete.discard(dead_id)
        await fence.drop_member_record(self.store, dead_id, dead_epoch)
        logger.warning(
            "replica %s adopted %d in-flight dispatch(es) from %s",
            self.replica_id, adopted, dead_id,
        )
