"""CoverageTracker: which shard of which dispatch is covered by whom.

For every sharded dispatch the tracker remembers the assignment table the
planner produced, stamped with the dispatch time. It answers three
questions the rest of the subsystem is built on:

  * attribution — a winning result's nonce falls inside exactly one shard
    (ranges are disjoint); the scan is sequential from the shard start, so
    ``nonce - start`` is the hash count the winner actually computed and
    (with the dispatch→result elapsed) a real throughput sample for the
    registry's EMA (fleet/registry.py observe_result);
  * re-cover — when the supervisor's grace window fires for a sharded
    dispatch (resilience/supervisor.py), the tracker splits the assignment
    table into shards whose workers are still live (their publish may have
    been lost: re-publish the SAME shard to the SAME lane) and shards whose
    workers are dead (hand the range to a live worker via the planner, or
    broadcast the ranged payload for anyone — including legacy racers — to
    pick up). Either way the full space stays covered WITHOUT re-racing
    the whole fleet over it;
  * accounting — ``dpow_fleet_ranges_recovered_total`` counts every shard
    that had to move, the benchmark's re-cover signal.

Entries live and die with the server's dispatch state (forget() is called
from _drop_dispatch_state and on winner), so the tracker can never leak
past the futures map it mirrors.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .planner import SPACE, Assignment, FleetPlanner
from .registry import WorkerRegistry

#: Sentinel "owner" for a shard whose re-cover had to fall back to a
#: ranged broadcast — nobody in particular scans it, so wins landing there
#: are never attributed and the shard is only ever re-broadcast, not
#: re-counted.
BROADCAST_OWNER = ""

#: Attribution plausibility bound: a shard owner's winning offset is
#: geometric with mean 1/p, so P(offset > 50/p) ~ e^-50 — an offset past
#: this many expected solves was NOT produced by a scan from the shard
#: start (e.g. a legacy full-space racer's nonce happening to land inside
#: the shard) and must not poison the owner's EMA.
PLAUSIBLE_SOLVES = 50.0


@dataclass
class _DispatchCover:
    work_type: str
    difficulty: int
    assignments: List[Assignment]
    dispatched_at: float  # dispatch creation; never mutated
    #: shards already handed to a replacement (by original worker id), so a
    #: twice-firing grace window does not re-recover the same shard.
    recovered: Dict[str, str] = field(default_factory=dict)
    #: per-shard scan start (by original worker id): the dispatch time,
    #: reset for a shard when it is re-covered. Attribution elapsed must be
    #: per-shard — resetting a dispatch-wide stamp on one shard's re-cover
    #: would inflate every OTHER shard's eventual hashrate sample.
    started: Dict[str, float] = field(default_factory=dict)


class CoverageTracker:
    def __init__(self, registry: WorkerRegistry):
        self.registry = registry
        self._covers: Dict[str, _DispatchCover] = {}

    def begin(
        self,
        block_hash: str,
        work_type: str,
        difficulty: int,
        assignments: List[Assignment],
        now: float,
    ) -> None:
        """Track a fresh sharded dispatch (replaces any previous table for
        the hash — a re-target re-plans and re-covers)."""
        self._covers[block_hash] = _DispatchCover(
            work_type=work_type,
            difficulty=difficulty,
            assignments=list(assignments),
            dispatched_at=now,
            started={a.worker_id: now for a in assignments},
        )

    def tracked(self, block_hash: str) -> bool:
        return block_hash in self._covers

    def work_type_of(self, block_hash: str) -> Optional[str]:
        cover = self._covers.get(block_hash)
        return cover.work_type if cover is not None else None

    def forget(self, block_hash: str) -> None:
        self._covers.pop(block_hash, None)

    def sweep(self, now: float, max_age: float) -> int:
        """Drop tables older than ``max_age`` past their last activity
        (creation or the newest shard re-cover).

        Backstop for dispatches whose teardown path never fires — e.g. a
        sharded PRECACHE publish whose result is lost AND whose account
        never confirms again: nothing else would ever forget it. On-demand
        tables are torn down with their dispatch state long before any
        sane max_age."""
        dead = [
            bh for bh, cover in self._covers.items()
            if now - max(
                cover.started.values(), default=cover.dispatched_at
            ) > max_age
        ]
        for bh in dead:
            del self._covers[bh]
        return len(dead)

    def __len__(self) -> int:
        return len(self._covers)

    # -- attribution ---------------------------------------------------

    def resolve(
        self, block_hash: str, nonce: int, now: float
    ) -> Optional[Tuple[str, float, float]]:
        """Attribute a winning nonce to the shard containing it.

        Returns (worker_id, hashes_scanned, elapsed) — the EMA sample — or
        None when the dispatch was not sharded or the nonce lies in no
        shard (a legacy full-space racer won; correct, just unattributed).
        The cover entry is NOT forgotten here: the server tears it down
        with the rest of the dispatch state.
        """
        cover = self._covers.get(block_hash)
        if cover is None:
            return None
        for a in cover.assignments:
            if a.covers(nonce):
                owner = cover.recovered.get(a.worker_id, a.worker_id)
                if owner == BROADCAST_OWNER:
                    return None  # anyone may have solved a broadcast shard
                scanned = ((nonce - a.start) % SPACE) + 1
                if scanned > PLAUSIBLE_SOLVES * FleetPlanner.expected_hashes(
                    cover.difficulty
                ):
                    # Statistically impossible for a scan from the shard
                    # start — a full-space racer's win landed inside the
                    # shard. Attributing it would fold a sample orders of
                    # magnitude too high into the owner's EMA and skew
                    # every later partition toward it.
                    return None
                started = cover.started.get(a.worker_id, cover.dispatched_at)
                return owner, float(scanned), now - started
        return None

    # -- re-cover ------------------------------------------------------

    def split_by_liveness(
        self, block_hash: str
    ) -> Optional[Tuple[List[Assignment], List[Assignment]]]:
        """(alive, orphaned) shards for a silent sharded dispatch.

        ``alive``: current owner still live — its QoS-0 publish may simply
        have been lost. ``orphaned``: owner dead, aged out, or previously
        broadcast — the shard has no live scanner. Returns None for
        untracked (broadcast) dispatches.
        """
        cover = self._covers.get(block_hash)
        if cover is None:
            return None
        live_ids = {
            info.worker_id
            for info in self.registry.live_workers(cover.work_type)
        }
        alive: List[Assignment] = []
        orphaned: List[Assignment] = []
        for a in cover.assignments:
            owner = cover.recovered.get(a.worker_id, a.worker_id)
            current = Assignment(owner, a.start, a.length)
            (alive if owner in live_ids else orphaned).append(current)
        return alive, orphaned

    def republish_plan(
        self, block_hash: str
    ) -> Optional[Tuple[List[Assignment], List[Assignment], List[Assignment]]]:
        """What a supervisor republish should send for a sharded dispatch:
        (lane, orphaned, rebroadcast), or None when untracked.

        ``lane`` — ONE assignment per live owner, the one with the FRESHEST
        scan stamp. A worker that took over a dead neighbor's shard holds
        two; re-sending both every grace window would rebase its single
        running job back and forth (cover_range), discarding a window of
        scan progress per flip. The freshest shard is the one the client is
        actually scanning, so its re-send dedups clean; the owner's older
        shard is deliberately NOT re-sent (one worker scans one range — the
        hedge escalation is the backstop for pathological cases).

        ``orphaned`` — shards whose owner is dead: move them (count once).
        ``rebroadcast`` — shards already handed to the broadcast fallback:
        re-send the ranged broadcast, but they were counted when they fell.
        """
        cover = self._covers.get(block_hash)
        if cover is None:
            return None
        live_ids = {
            info.worker_id
            for info in self.registry.live_workers(cover.work_type)
        }
        freshest: Dict[str, Tuple[float, Assignment]] = {}
        orphaned: List[Assignment] = []
        rebroadcast: List[Assignment] = []
        for a in cover.assignments:
            owner = cover.recovered.get(a.worker_id, a.worker_id)
            stamp = cover.started.get(a.worker_id, cover.dispatched_at)
            current = Assignment(owner, a.start, a.length)
            if owner == BROADCAST_OWNER:
                rebroadcast.append(current)
            elif owner not in live_ids:
                orphaned.append(current)
            elif owner not in freshest or stamp > freshest[owner][0]:
                freshest[owner] = (stamp, current)
        lane = [a for _, a in freshest.values()]
        return lane, orphaned, rebroadcast

    def current_owners(self, block_hash: str) -> set:
        """Live-or-dead owners currently holding a shard of the dispatch
        (reassignment prefers workers with no stake in it yet)."""
        cover = self._covers.get(block_hash)
        if cover is None:
            return set()
        return {
            cover.recovered.get(a.worker_id, a.worker_id)
            for a in cover.assignments
        } - {BROADCAST_OWNER}

    def reassigned(
        self, block_hash: str, original: Assignment, new_owner: str, now: float
    ) -> None:
        """Record that ``original``'s shard now belongs to ``new_owner``
        and restart the shard's clock (the replacement scans from the shard
        start, so attribution timing must too)."""
        cover = self._covers.get(block_hash)
        if cover is None:
            return
        for a in cover.assignments:
            if a.start == original.start and a.length == original.length:
                key = a.worker_id
                cover.recovered[key] = new_owner
                cover.started[key] = now  # only THIS shard's clock restarts
                return
