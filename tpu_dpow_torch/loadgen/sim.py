"""Discrete-event twin of the replica ring: 1M requests in seconds.

The port's copy of ``tpu_dpow/loadgen/sim.py``: same model, same RNG
draws in the same order, so the same inputs give the same
:class:`SimOutcome` in both packages. A million-request diurnal capture
against real replica processes is hours of wall clock. This module is
the calibrated stand-in: each replica is modeled as its admission window
(k parallel service slots + a bounded FIFO queue — exactly the structure
``tpu_dpow_torch/sched/`` imposes on the real server),
service times come from a distribution CALIBRATED against the live
N=1/2/3 capture, and the REAL autoscale controller runs in the loop —
same ``decide()`` code, same decision journal, same replay contract as
against live processes. What is simulated is the queueing physics; what
is real is every line of policy.

Faithfully modeled, because they change the controller's job:
  * same-hash coalescing — concurrent same-hash arrivals share one
    service slot (the population's reuse/hot-hash behavior feeds this);
  * store hits — a hash solved recently answers instantly;
  * per-request timeouts (patience from the population model) and
    queue-full busy sheds;
  * scale-up lag — a spawned replica only starts serving after
    ``spawn_delay`` (the real process fork + setup + ring join cost);
  * drain-before-retire — a retiring replica stops accepting, finishes
    its queue, then leaves (the actuator's contract);
  * precache — modeled as BOTH sides of the real trade, calibrated from
    a live capture: while precache admission is open, ``precache_util``
    of each replica's window is held by speculative leases (fewer
    on-demand slots) and ``precache_hit`` of arrivals are served from
    already-solved frontiers at store-hit cost (skipping dispatch
    entirely). The controller's shed lever frees the slots and, with no
    new speculative solves, zeroes the hit stream — so the sim
    reproduces the real lever's shape: shedding buys window capacity
    now at the price of longer service per request later.

Not modeled: the fleet_horizon lever (a worker-fleet effect the sim's
single synthetic responder tier has no analogue for) — the controller
may still decide it; the sim applies it as a no-op and says so in the
capture. Pure synchronous code, no sockets, no wall clock: deterministic
per (schedule seed, population seed, sim seed).
"""

from __future__ import annotations

import heapq
import itertools
import math
import random
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, Iterable, List, Optional, Tuple

from ..resilience.clock import Clock
from .arrival import Arrival
from .population import ServicePopulation
from .recorder import OpenLoopRecorder


class SimClock(Clock):
    """Read-only clock the recorder/journal stamp from; the event loop
    advances it. sleep() is unsupported on purpose — the sim is
    synchronous, nothing awaits."""

    def __init__(self):
        self.now = 0.0

    def time(self) -> float:
        return self.now

    async def sleep(self, delay: float) -> None:
        raise RuntimeError("SimClock does not sleep; the event heap advances time")


@dataclass
class SimParams:
    """The queueing model. ``service_median``/``service_sigma`` are the
    log-normal service-time parameters ONE slot spends per on-demand
    dispatch, calibrated from a live capture (chip_smoke.py's autoscale
    phase fits them from its N = 1 capacity rung); the rest mirror real
    server flags."""

    window: int = 8                 # --max_inflight_dispatches per replica
    queue_limit: int = 64           # --admission_queue_limit per replica
    service_median: float = 0.25
    service_sigma: float = 0.35
    service_floor: float = 0.01
    store_hit_s: float = 0.004      # served-from-store round trip
    # window fraction held by precache leases while admission is open
    # (calibrate from dpow_sched_inflight's precache share in a live run)
    precache_util: float = 0.25
    # P(arrival's frontier was already speculatively solved) while
    # precache is open — served at store_hit_s, no dispatch (calibrate
    # from the live dpow_precache_hit_ratio)
    precache_hit: float = 0.0
    spawn_delay: float = 3.0        # process start + ring join
    solved_lru: int = 50000         # recent solved hashes (store-hit window)


class _Replica:
    __slots__ = ("rid", "busy", "queue", "draining", "up_at")

    def __init__(self, rid: int, up_at: float):
        self.rid = rid
        self.busy = 0  # occupied service slots
        self.queue: Deque[tuple] = deque()  # (arrival_t, spec, key)
        self.draining = False
        self.up_at = up_at


@dataclass
class SimOutcome:
    summary: dict = field(default_factory=dict)
    replica_timeline: List[dict] = field(default_factory=list)
    decisions: int = 0
    coalesced: int = 0
    store_hits: int = 0
    precache_hits: int = 0
    peak_replicas: int = 0


class ClusterSim:
    """Event-driven run: arrivals from a schedule + population, the
    controller polled every ``poll_interval`` of sim time (None = no
    controller: fixed fleet)."""

    def __init__(
        self,
        params: SimParams,
        *,
        replicas: int = 1,
        seed: int = 0,
        recorder: Optional[OpenLoopRecorder] = None,
        controller=None,
        journal=None,
        poll_interval: float = 5.0,
        signal_window: float = 15.0,
    ):
        self.p = params
        self.clock = SimClock()
        self.rng = random.Random(seed ^ 0x51AB)
        self.recorder = recorder or OpenLoopRecorder(self.clock, window=30.0)
        self.controller = controller
        self.journal = journal
        self.poll_interval = poll_interval
        self.signal_window = signal_window
        self._seq = itertools.count()
        self._heap: List[tuple] = []
        self._replicas: Dict[int, _Replica] = {}
        self._next_rid = 0
        for _ in range(replicas):
            self._add_replica(0.0)
        self._rr = itertools.count()
        self.precache_open = True
        self.horizon = 0.0  # recorded, not modeled (module docstring)
        # coalescing + store-hit state
        self._pending: Dict[str, int] = {}   # hash -> waiters riding one slot
        self._solved: "dict" = {}            # bounded LRU of solved hashes
        self._recent_lat: Deque[Tuple[float, float]] = deque()
        # (t, was_precache_hit) per classified arrival — the windowed
        # hit-ratio signal, mirroring the real counter-delta fold
        self._recent_pre: Deque[Tuple[float, bool]] = deque()
        self.out = SimOutcome()
        self._replica_marks: List[dict] = []

    # -- fleet ----------------------------------------------------------

    def _add_replica(self, up_at: float) -> _Replica:
        r = _Replica(self._next_rid, up_at)
        self._next_rid += 1
        self._replicas[r.rid] = r
        return r

    def _accepting(self) -> List[_Replica]:
        now = self.clock.now
        return [
            r for r in self._replicas.values()
            if not r.draining and r.up_at <= now
        ]

    def live_count(self) -> int:
        return len(self._accepting())

    # -- actuation (the sim-side Actuator) ------------------------------

    def apply_action(self, action) -> None:
        kind = getattr(action, "kind", action)
        if kind == "scale_up":
            r = self._add_replica(self.clock.now + self.p.spawn_delay)
            self._push(r.up_at, "replica_up", r.rid)
        elif kind == "scale_down":
            victims = self._accepting()
            if len(victims) > 1:
                victim = victims[-1]
                victim.draining = True
                self._maybe_retire(victim)
        elif kind == "shed_precache_on":
            self.precache_open = False
        elif kind == "shed_precache_off":
            self.precache_open = True
        elif kind == "set_horizon":
            self.horizon = float(getattr(action, "value", 0.0) or 0.0)

    def _maybe_retire(self, r: _Replica) -> None:
        if r.draining and r.busy == 0 and not r.queue:
            self._replicas.pop(r.rid, None)

    # -- event plumbing -------------------------------------------------

    def _push(self, t: float, kind: str, data=None) -> None:
        heapq.heappush(self._heap, (t, next(self._seq), kind, data))

    def _service_sample(self) -> float:
        s = self.p.service_median * math.exp(
            self.rng.gauss(0.0, self.p.service_sigma)
        )
        return max(self.p.service_floor, s)

    def _window_now(self) -> int:
        """On-demand slots per replica RIGHT NOW: while precache admission
        is open its leases hold ``precache_util`` of the window (the real
        window counts precache leases in inflight); shedding returns the
        full window to on-demand work."""
        if self.precache_open and self.p.precache_util > 0:
            return max(
                1, int(round(self.p.window * (1.0 - self.p.precache_util)))
            )
        return self.p.window

    def _note_solved(self, block_hash: str) -> None:
        self._solved[block_hash] = True
        if len(self._solved) > self.p.solved_lru:
            self._solved.pop(next(iter(self._solved)))

    def _finish(self, intended_t: float, outcome: str) -> None:
        lat = self.recorder.done(intended_t, outcome, end_t=self.clock.now)
        # the controller's p95 signal sees SERVED requests only, exactly
        # like the real signal path (autoscale/signals.py excludes the
        # "unresolved" work_type): refusals and abandons register through
        # queue depth, not through fabricated latency samples
        if outcome == "ok":
            self._recent_lat.append((self.clock.now, lat))

    # -- signals for the controller -------------------------------------

    def signals(self):
        from ..autoscale.signals import Signals

        now = self.clock.now
        while self._recent_lat and self._recent_lat[0][0] < now - self.signal_window:
            self._recent_lat.popleft()
        lats = sorted(lat for _, lat in self._recent_lat)
        p95 = lats[min(int(0.95 * len(lats)), len(lats) - 1)] if lats else None
        while self._recent_pre and self._recent_pre[0][0] < now - self.signal_window:
            self._recent_pre.popleft()
        pre_ratio = (
            sum(1 for _, hit in self._recent_pre if hit) / len(self._recent_pre)
            if self._recent_pre else None
        )
        accepting = self._accepting()
        inflight = sum(r.busy for r in self._replicas.values())
        # precache leases hold real window slots on the live server and
        # count in dpow_sched_inflight; mirror that so the controller's
        # occupancy signal sees the same saturation either way
        inflight += (self.p.window - self._window_now()) * len(accepting)
        capacity = max(1, len(accepting)) * self.p.window
        return Signals(
            t=now,
            p95_s=p95,
            completed=len(lats),
            queue_depth=float(sum(len(r.queue) for r in self._replicas.values())),
            inflight=float(inflight),
            capacity=float(capacity),
            occupancy=inflight / capacity if capacity else None,
            coalesce_delta=0.0,
            fleet_hashrate=0.0,
            replicas_live=float(len(accepting)),
            sources_ok=len(accepting),
            sources_total=len(self._replicas),
            precache_hit_ratio=pre_ratio,
        )

    # -- the run ---------------------------------------------------------

    def run(
        self,
        schedule: Iterable[Arrival],
        population: ServicePopulation,
        *,
        slo_p95_ms: Optional[float] = None,
    ) -> SimOutcome:
        arrivals = iter(schedule)
        self.recorder.begin(0.0)
        first = next(arrivals, None)
        if first is not None:
            self._push(first.t, "arrival", first)
        if self.controller is not None:
            self._push(self.poll_interval, "poll")
        pending_events = bool(self._heap)
        mark_last = -1
        while pending_events:
            t, _, kind, data = heapq.heappop(self._heap)
            self.clock.now = t
            if kind == "arrival":
                nxt = next(arrivals, None)
                if nxt is not None:
                    self._push(nxt.t, "arrival", nxt)
                self._arrive(data, population)
            elif kind == "complete":
                self._complete(*data)
            elif kind == "replica_up":
                pass  # becoming visible to _accepting() is the event
            elif kind == "poll":
                self._poll()
                # keep polling while anything is still outstanding
                if any(
                    r.busy or r.queue for r in self._replicas.values()
                ) or any(k == "arrival" for _, _, k, _ in self._heap):
                    self._push(t + self.poll_interval, "poll")
            if int(t) > mark_last:
                mark_last = int(t)
                self._replica_marks.append({
                    "t": round(t, 1),
                    "replicas": self.live_count(),
                    "queue": sum(len(r.queue) for r in self._replicas.values()),
                })
            pending_events = bool(self._heap)
        self.out.summary = self.recorder.summary(slo_p95_ms=slo_p95_ms)
        self.out.replica_timeline = self._compact_marks()
        self.out.peak_replicas = max(
            (m["replicas"] for m in self._replica_marks), default=0
        )
        return self.out

    def _compact_marks(self) -> List[dict]:
        """Replica-count timeline, change points only."""
        out: List[dict] = []
        for m in self._replica_marks:
            if not out or out[-1]["replicas"] != m["replicas"]:
                out.append(m)
        return out

    def _arrive(self, arrival: Arrival, population: ServicePopulation) -> None:
        spec = population.spec(arrival)
        self.recorder.issued(spec.intended_t, actual_t=self.clock.now)
        # the simulated client's own abandon behavior still concludes the
        # request for the recorder (outcome accounting stays exhaustive)
        if spec.cancel_after is not None:
            self._push(
                self.clock.now + spec.cancel_after, "complete",
                ("cancelled", spec.intended_t, None, None),
            )
            return
        if spec.hash in self._solved:
            self.out.store_hits += 1
            self._push(
                self.clock.now + self.p.store_hit_s, "complete",
                ("ok", spec.intended_t, None, None),
            )
            return
        # precache hit: the account's frontier was speculatively solved
        # before the request arrived — answered at store cost, no slot.
        # Only while precache is open: the shed lever stops new
        # speculative solves, so fresh frontiers stop being pre-answered
        # (hits collapse to zero, exactly the live flash-crowd shape).
        if self.p.precache_hit > 0:
            hit = self.precache_open and self.rng.random() < self.p.precache_hit
            self._recent_pre.append((self.clock.now, hit))
            if hit:
                self.out.precache_hits += 1
                self._push(
                    self.clock.now + self.p.store_hit_s, "complete",
                    ("ok", spec.intended_t, None, None),
                )
                return
        if spec.hash in self._pending:
            # same-hash coalesce: ride the in-flight dispatch's slot
            self._pending[spec.hash] += 1
            self.out.coalesced += 1
            self._push(
                self.clock.now + self._remaining(spec.hash), "complete",
                ("ok", spec.intended_t, None, None),
            )
            return
        accepting = self._accepting()
        if not accepting:
            self._finish(spec.intended_t, "busy")
            return
        r = accepting[next(self._rr) % len(accepting)]
        if r.busy < self._window_now():
            self._start_service(r, spec)
        elif len(r.queue) < self.p.queue_limit:
            r.queue.append((self.clock.now, spec))
        else:
            self._finish(spec.intended_t, "busy")

    # remaining service time for a pending hash: approximated by a fresh
    # residual sample (memoryless-ish; only affects coalesced waiters)
    def _remaining(self, block_hash: str) -> float:
        return 0.5 * self._service_sample()

    def _start_service(self, r: _Replica, spec) -> None:
        r.busy += 1
        self._pending.setdefault(spec.hash, 0)
        self._push(
            self.clock.now + self._service_sample(), "complete",
            ("ok", spec.intended_t, r.rid, spec.hash),
        )

    def _complete(self, outcome, intended_t, rid, block_hash) -> None:
        if block_hash is not None:
            self._pending.pop(block_hash, None)
            self._note_solved(block_hash)
        self._finish(intended_t, outcome)
        if rid is None:
            return
        r = self._replicas.get(rid)
        if r is None:
            return
        r.busy -= 1
        # pull the queue, expiring waiters whose patience ran out
        while r.queue and r.busy < self._window_now():
            queued_at, spec = r.queue.popleft()
            if self.clock.now - queued_at > spec.timeout:
                self._finish(spec.intended_t, "timeout")
                continue
            if spec.hash in self._solved:
                self.out.store_hits += 1
                self._push(
                    self.clock.now + self.p.store_hit_s, "complete",
                    ("ok", spec.intended_t, None, None),
                )
                continue
            self._start_service(r, spec)
        self._maybe_retire(r)

    def _poll(self) -> None:
        signals = self.signals()
        actions = self.controller.decide(signals)
        if self.journal is not None:
            self.journal.record(signals, actions, self.controller.state_dict())
        for action in actions:
            self.out.decisions += 1
            self.apply_action(action)
