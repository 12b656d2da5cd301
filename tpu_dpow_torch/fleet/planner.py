"""FleetPlanner: turn one dispatch into disjoint, hashrate-weighted shards.

The reference broadcasts every work request to the whole swarm and lets
workers race from random starting nonces (reference client README:21) — N
workers each burn an expected full-space search and N-1 results are thrown
away. The planner is the fleet-level analog of the on-chip sharding in
parallel/mesh_search.py: partition the u64 nonce space into disjoint ranges
sized by each live worker's effective hashrate, so the fleet performs ONE
data-parallel search instead of N redundant ones.

Partition properties (tests/test_fleet.py pins them):
  * ranges are disjoint and cover [0, 2^64) exactly (every boundary is a
    rounded cumulative-weight point; the last range closes the space);
  * range width is proportional to the worker's effective hashrate
    (registry EMA > declared > floor), so every shard EXHAUSTS in about the
    same wall time — the slowest worker is not the fleet's tail;
  * worker order inside the partition rotates per plan, so the low end of
    the space (where shard #0 always starts) is not pinned to one worker.

Right-sizing (``horizon`` > 0): a dispatch does not always need the whole
fleet. With a horizon of H seconds the planner selects — starting at a
rotating cursor — just enough workers that their combined hashrate covers
``safety`` x the difficulty's expected solve work within H, and partitions
the FULL space among that subset (full coverage is what guarantees a
solution exists in-plan). The rest of the fleet stays free for concurrent
dispatches — that is where fleet throughput scaling comes from
(benchmarks/fleet.py measures it). horizon 0 (default) always uses every
live worker: latency-optimal, and the conservative choice when the
operator has not sized the fleet.

Fallback: ``plan()`` returns a BROADCAST plan — the reference's racing
behavior, published on the shared work topic — whenever the registry has
fewer than ``min_workers`` live members for the work type (empty, stale,
or simply too small to be worth coordinating).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional

from .registry import WorkerRegistry

SPACE = 1 << 64

SHARDED = "sharded"
BROADCAST = "broadcast"


@dataclass(frozen=True)
class Assignment:
    """One worker's shard: [start, start + length) with length 0 = 2^64."""

    worker_id: str
    start: int
    length: int  # 0 encodes the full 2^64 span (it does not fit a u64)

    def covers(self, nonce: int) -> bool:
        if self.length == 0:
            return True
        return 0 <= (nonce - self.start) % SPACE < self.length

    @property
    def span(self) -> int:
        return self.length or SPACE


@dataclass
class Plan:
    mode: str  # SHARDED | BROADCAST
    assignments: List[Assignment] = field(default_factory=list)
    #: workers that would race this dispatch (broadcast accounting; the
    #: planner cannot see legacy subscribers, so this is the REGISTERED
    #: racer count — a lower bound on true broadcast redundancy).
    racers: int = 0


class FleetPlanner:
    def __init__(
        self,
        registry: WorkerRegistry,
        *,
        min_workers: int = 2,
        max_shards: int = 64,
        horizon: float = 0.0,
        safety: float = 4.0,
    ):
        self.registry = registry
        self.min_workers = max(min_workers, 1)
        self.max_shards = max(max_shards, 1)
        self.horizon = horizon
        self.safety = max(safety, 1.0)
        self._cursor = 0  # rotates shard-0 / subset start across plans

    @staticmethod
    def expected_hashes(difficulty: int) -> float:
        """Expected nonces scanned to find one solution at ``difficulty``
        (the geometric mean 1/p; same model as the engine's rung
        sizing, backend/torch_backend.py _solve_p)."""
        p = max((SPACE - difficulty) / SPACE, 1e-30)
        return 1.0 / p

    def plan(self, difficulty: int, work_type: str) -> Plan:
        live = self.registry.live_workers(work_type)
        if len(live) < self.min_workers:
            return Plan(mode=BROADCAST, racers=max(len(live), 1))
        # Rotate the fleet order per plan: both which worker anchors shard 0
        # and (under a horizon) which subset serves this dispatch.
        self._cursor = (self._cursor + 1) % len(live)
        rotated = live[self._cursor:] + live[:self._cursor]
        selected = rotated
        if self.horizon > 0:
            need = self.safety * self.expected_hashes(difficulty) / self.horizon
            picked, rate = [], 0.0
            for info in rotated:
                picked.append(info)
                rate += info.hashrate
                if rate >= need:
                    break
            selected = picked
        selected = selected[: self.max_shards]
        weights = [info.hashrate for info in selected]
        total = sum(weights)
        if total <= 0.0 or not math.isfinite(total):  # defensive: floor > 0
            return Plan(mode=BROADCAST, racers=len(live))
        assignments: List[Assignment] = []
        cum = 0.0
        prev = 0
        for i, info in enumerate(selected):
            cum += weights[i]
            end = SPACE if i == len(selected) - 1 else int(SPACE * cum / total)
            if end <= prev:
                continue  # rounding collapsed this shard; neighbor absorbs it
            assignments.append(
                Assignment(info.worker_id, prev, (end - prev) % SPACE)
            )
            prev = end
        if not assignments:
            return Plan(mode=BROADCAST, racers=len(live))
        return Plan(mode=SHARDED, assignments=assignments, racers=len(selected))

    def reassign(
        self, assignment: Assignment, exclude: Optional[set] = None,
        work_type: str = "ondemand",
    ) -> Optional[Assignment]:
        """Hand a (dead worker's) shard to another live worker — the whole
        range to ONE worker, fastest first: re-cover latency is dominated
        by the single scan, and splitting a recovered shard again would
        multiply the publish fan-out for marginal gain."""
        exclude = exclude or set()
        candidates = [
            info for info in self.registry.live_workers(work_type)
            if info.worker_id not in exclude
        ]
        if not candidates:
            return None
        best = max(candidates, key=lambda i: (i.hashrate, i.worker_id))
        return Assignment(best.worker_id, assignment.start, assignment.length)
