"""dpowsan: a schedule-perturbing confirmer for the DPOW801 race class.

The port's own copy of ``tpu_dpow/analysis/sanitizer.py``: the same
perturber, seams and six scenarios, driven against the port's hub
(``DpowServer``, ``MemoryStore``, ``Broker``, ``InProcTransport``) and its
engine. The device-fault scenario runs ``TorchWorkBackend`` in persistent
mode on ``--device`` (default ``cuda``: the mailbox-steered run kernel,
``ops/csrc/blake2b_run.cu``; ``cpu``: its plain version). Without a card
the engine refuses with its own WorkError, which fails the run: nothing
falls back to the CPU by itself.

The static half (analysis/concurrency.py) names check-then-act *candidates*;
this module tries to make the real state machines actually fail. It wraps
the chaos harness's FakeClock/in-proc stack with a seeded interleaving
perturber and replays the two e2e scenarios whose interleavings bit us in
review — same-hash coalescing and fleet straggler re-cover — under N seeds:

  * the :class:`Perturber` injects ``asyncio.sleep(0)`` yields of seeded
    depth and real task-wakeup REORDERING (parked awaiters released in
    shuffled order via ``call_soon``) at every store and transport
    operation — exactly the await points the checker reasons about;
  * :class:`PerturbingStore` / :class:`PerturbingTransport` wrap the two
    injectable seams, so the server under test is the real DpowServer with
    no test-only code paths;
  * every run is reproducible by seed: the RNG drives every decision, the
    clock is a FakeClock, and the decision trace digests into a stable id
    (``same seed → same trace`` is pinned in tests/test_torch_analysis.py,
    which also holds the five hub scenarios' traces equal to
    ``tpu_dpow``'s seed for seed).

A scenario PASSES when its end-state invariants hold — every request is
answered or fails cleanly within its budget, nothing is stranded while the
store holds valid work, and every per-dispatch side table is torn down.
A failure names the seed (replay with ``--san_seeds 1 --san_base_seed K``)
and its traceback; :func:`annotate` folds the runs back onto the static
DPOW801 findings as confirmed / not-reproduced / unexercised.

Flag surface (machine-checked against tpu_dpow_torch/docs/flags.md,
DPOW701-703):
``--san`` runs the sanitizer after the static pass, ``--san_seeds`` /
env ``DPOW_SAN_SEEDS`` sets the replay count, ``--san_base_seed`` / env
``DPOW_SAN_BASE_SEED`` offsets the seed range for reproduction,
``--device`` picks the device-fault engine's device.
"""

from __future__ import annotations

import argparse
import asyncio
import hashlib
import json
import os
import random
import struct
import sys
import traceback
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

#: difficulty used by every scenario: ~256 expected blake2b trials, instant
#: to brute-force on the host.
EASY_DIFFICULTY = 0xFF00000000000000

#: package modules the scenarios actually drive — the denominator for
#: annotate()'s confirmed/not-reproduced/unexercised verdicts.
INSTRUMENTED_PREFIXES = (
    "tpu_dpow_torch/server/app.py",
    "tpu_dpow_torch/fleet/",
    "tpu_dpow_torch/sched/",
    "tpu_dpow_torch/store/",
    "tpu_dpow_torch/replica/",
    "tpu_dpow_torch/resilience/",
    "tpu_dpow_torch/transport/broker.py",
    "tpu_dpow_torch/transport/inproc.py",
    "tpu_dpow_torch/backend/torch_backend.py",
    "tpu_dpow_torch/ops/control.py",
    "tpu_dpow_torch/ops/cuda_kernel.py",
    "tpu_dpow_torch/autoscale/",
    "tpu_dpow_torch/precache/",
)

#: the package whose frames a failing run's traceback names
PACKAGE = __name__.split(".")[0] + "/"


@dataclass
class SanitizerConfig:
    """Defaults for the sanitizer flags (tpu_dpow_torch/docs/flags.md,
    sanitizer section)."""

    san: bool = False
    san_seeds: int = 20
    san_base_seed: int = 0
    device: str = "cuda"


def _env_int(name: str, default: int) -> int:
    """Tolerant env override: a malformed value must degrade to the coded
    default with a warning, not crash every ``python -m tpu_dpow_torch.analysis``
    invocation (add_flags runs before argparse even sees --san)."""
    raw = os.getenv(name)
    if raw is None:
        return default
    try:
        return int(raw)
    except ValueError:
        print(
            f"dpowsan: ignoring non-integer {name}={raw!r} "
            f"(using {default})",
            file=sys.stderr,
        )
        return default


def add_flags(p: argparse.ArgumentParser) -> None:
    """The sanitizer's argparse surface (checked by DPOW701-703)."""
    c = SanitizerConfig()
    p.add_argument(
        "--san", action="store_true",
        help="after the static pass, replay the coalescing, fleet "
        "re-cover, replica-takeover, device-fault, autoscale-drain and "
        "precache scenarios under the seeded interleaving perturber",
    )
    p.add_argument(
        "--san_seeds", type=int,
        default=_env_int("DPOW_SAN_SEEDS", c.san_seeds),
        help="sanitizer replay count: seeds run per scenario "
        "(env DPOW_SAN_SEEDS overrides the default)",
    )
    p.add_argument(
        "--san_base_seed", type=int,
        default=_env_int("DPOW_SAN_BASE_SEED", c.san_base_seed),
        help="first seed of the replay range — reproduce one failing seed "
        "K with --san_seeds 1 --san_base_seed K "
        "(env DPOW_SAN_BASE_SEED overrides the default)",
    )
    p.add_argument(
        "--device", default=c.device, choices=["cuda", "cpu"],
        help="device of the device-fault scenario's engine: cuda (the "
        "run kernel on the card) or cpu (its plain version); there is "
        "no fallback between them",
    )


class SanitizerFailure(AssertionError):
    """A scenario invariant broke under a perturbed interleaving."""


# ---------------------------------------------------------------------------
# the perturber
# ---------------------------------------------------------------------------


class Perturber:
    """Seeded interleaving chaos at await points.

    ``point()`` is called by the seam wrappers before and after every
    store/transport operation. Per call the seeded RNG picks one of:

      * pass through (no extra suspension);
      * yield to the event loop 1-3 times (``asyncio.sleep(0)``) — slides
        this coroutine behind everything currently runnable;
      * PARK: suspend on a future released by a ``call_soon`` callback
        that wakes all parked coroutines in shuffled order — genuine
        wakeup reordering, the thing FIFO scheduling never exercises.

    Every decision lands in ``trace``; ``digest()`` is the run's stable
    fingerprint (same seed + same code ⇒ same digest).
    """

    def __init__(self, seed: int):
        self.seed = seed
        self.rng = random.Random(seed)
        self.trace: List[str] = []
        self._parked: List[asyncio.Future] = []
        self._release_scheduled = False

    async def point(self, site: str) -> None:
        r = self.rng.random()
        if r < 0.30:
            self.trace.append(f"{site}=pass")
            return
        if r < 0.80:
            n = self.rng.randint(1, 3)
            self.trace.append(f"{site}=yield{n}")
            for _ in range(n):
                await asyncio.sleep(0)
            return
        self.trace.append(f"{site}=park")
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        self._parked.append(fut)
        if not self._release_scheduled:
            self._release_scheduled = True
            loop.call_soon(self._release)
        await fut

    def _release(self) -> None:
        self._release_scheduled = False
        parked, self._parked = self._parked, []
        self.rng.shuffle(parked)
        for fut in parked:
            if not fut.done():
                fut.set_result(None)

    def digest(self) -> str:
        return hashlib.sha256("\n".join(self.trace).encode()).hexdigest()[:16]


class PerturbingStore:
    """Store-protocol proxy: a perturbation point around every async op."""

    def __init__(self, inner, perturber: Perturber):
        self._inner = inner
        self._perturber = perturber

    def __getattr__(self, name: str):
        attr = getattr(self._inner, name)
        if name.startswith("_") or not asyncio.iscoroutinefunction(attr):
            return attr
        perturber = self._perturber

        async def op(*args, **kwargs):
            await perturber.point(f"store.{name}")
            result = await attr(*args, **kwargs)
            await perturber.point(f"store.{name}.done")
            return result

        return op


class PerturbingTransport:
    """Transport proxy: perturbation around publishes and deliveries."""

    def __init__(self, inner, perturber: Perturber):
        self._inner = inner
        self._perturber = perturber

    @property
    def connected(self) -> bool:
        return self._inner.connected

    async def connect(self) -> None:
        await self._inner.connect()

    async def close(self) -> None:
        await self._inner.close()

    async def subscribe(self, pattern: str, qos: int = 0) -> None:
        await self._inner.subscribe(pattern, qos)

    async def publish(self, topic: str, payload: str, qos: int = 0) -> None:
        await self._perturber.point("transport.publish")
        await self._inner.publish(topic, payload, qos)
        await self._perturber.point("transport.publish.done")

    async def messages(self):
        async for msg in self._inner.messages():
            await self._perturber.point("transport.deliver")
            yield msg


# ---------------------------------------------------------------------------
# scenario plumbing
# ---------------------------------------------------------------------------


def solve(block_hash: str, difficulty: int, start: int = 0) -> str:
    """Host-side brute force; instant at EASY_DIFFICULTY."""
    h = bytes.fromhex(block_hash)
    nonce = start
    while True:
        value = int.from_bytes(
            hashlib.blake2b(
                struct.pack("<Q", nonce) + h, digest_size=8
            ).digest(),
            "little",
        )
        if value >= difficulty:
            return f"{nonce:016x}"
        nonce += 1


def _scenario_hash(seed: int, tag: str) -> str:
    return hashlib.blake2b(
        f"dpowsan-{tag}-{seed}".encode(), digest_size=32
    ).hexdigest().upper()


async def _settle(rounds: int = 60) -> None:
    for _ in range(rounds):
        await asyncio.sleep(0)


def _payout() -> str:
    from ..utils import nanocrypto as nc

    return nc.encode_account(bytes(range(32)))


async def _start_server(perturber: Perturber, **config_overrides):
    """The real DpowServer on perturbed seams + FakeClock + in-proc broker."""
    from ..resilience.clock import FakeClock
    from ..server import DpowServer, ServerConfig, hash_key
    from ..store import MemoryStore
    from ..transport.broker import Broker
    from ..transport.inproc import InProcTransport

    clock = FakeClock()
    broker = Broker()
    config = ServerConfig(
        base_difficulty=EASY_DIFFICULTY,
        throttle=1000.0,
        heartbeat_interval=3600.0,
        statistics_interval=3600.0,
        work_republish_interval=2.0,
        **config_overrides,
    )
    store = PerturbingStore(MemoryStore(), perturber)
    transport = PerturbingTransport(
        InProcTransport(broker, client_id="server"), perturber
    )
    server = DpowServer(config, store, transport, clock=clock)
    await server.setup()
    server.start_loops()
    await store.hset(
        "service:svc",
        {"api_key": hash_key("secret"), "public": "N",
         "display": "svc", "website": "", "precache": "0", "ondemand": "0"},
    )
    await store.sadd("services", "svc")
    return server, store, clock


def _check_teardown(server) -> None:
    """Every per-dispatch side table must be empty once the dust settles."""
    leaks = {
        "work_futures": server.work_futures,
        "_future_waiters": server._future_waiters,
        "_dispatch_gates": server._dispatch_gates,
        "_dispatch_tickets": server._dispatch_tickets,
        "_difficulty_locks": server._difficulty_locks,
        "_dispatched_difficulty": server._dispatched_difficulty,
    }
    stuck = {k: dict(v) for k, v in leaks.items() if v}
    if stuck:
        raise SanitizerFailure(f"per-dispatch state leaked: {stuck}")


# ---------------------------------------------------------------------------
# scenario: same-hash coalescing under a cancel/winner race
# ---------------------------------------------------------------------------


async def scenario_coalesce(perturber: Perturber) -> None:
    """Three same-hash requests coalesce onto one dispatch; one waiter is
    cancelled at a seed-chosen instant while the winning result lands.
    Some seeds bound the admission window to 1 with a blocker dispatch
    holding the slot, so the cancel hits a dispatcher QUEUED for admission
    — the promote-window race that strands gated waiters (the dpowsan
    finding fixed in server/app.py). Invariants: every request is served
    or fails CLEANLY, nobody strands while valid work sits in the store,
    and the last waiter out tears every side table down."""
    from ..server.exceptions import RequestTimeout, RetryRequest
    from ..server.app import WORK_PENDING
    from ..transport.mqtt_codec import encode_result_payload

    bounded = perturber.rng.random() < 0.5
    server, store, clock = await _start_server(
        perturber, fleet=False,
        max_inflight_dispatches=1 if bounded else 0,
    )
    payout = _payout()
    try:
        h = _scenario_hash(perturber.seed, "coalesce")
        blocker_h = _scenario_hash(perturber.seed, "coalesce-blocker")
        watched = {}
        if bounded:
            # a different hash occupies the single window slot, so the
            # same-hash trio's dispatcher parks in the admission queue
            watched["blocker"] = asyncio.ensure_future(server.service_handler(
                {"user": "svc", "api_key": "secret", "hash": blocker_h,
                 "timeout": 25}
            ))
            await _settle(perturber.rng.randint(5, 60))
        request = {"user": "svc", "api_key": "secret", "hash": h, "timeout": 25}
        reqs = [
            asyncio.ensure_future(server.service_handler(dict(request)))
            for _ in range(3)
        ]
        # Cancel one request at a seed-varied point of the dispatch state
        # machine — mid-gate, mid-admission-queue, mid-publish, or as a
        # plain waiter.
        for _ in range(perturber.rng.randint(0, 50)):
            await asyncio.sleep(0)
        reqs[0].cancel()
        work = solve(h, EASY_DIFFICULTY)
        blocker_work = solve(blocker_h, EASY_DIFFICULTY)
        release_blocker_at = perturber.rng.randint(40, 200)
        everyone = list(reqs) + list(watched.values())
        for spin in range(1500):
            if all(r.done() for r in everyone):
                break
            if await store.get(f"block:{h}") == WORK_PENDING:
                # a dispatch is live: land the worker result for it
                await server.client_result_handler(
                    "result/ondemand", encode_result_payload(h, work, payout)
                )
            if bounded and spin >= release_blocker_at and (
                await store.get(f"block:{blocker_h}") == WORK_PENDING
            ):
                await server.client_result_handler(
                    "result/ondemand",
                    encode_result_payload(blocker_h, blocker_work, payout),
                )
            await asyncio.sleep(0)
        else:
            stranded = [
                name for name, r in
                [(str(i), r) for i, r in enumerate(reqs)] + list(watched.items())
                if not r.done()
            ]
            stored = await store.get(f"block:{h}")
            raise SanitizerFailure(
                f"requests {stranded} stranded after the winner landed "
                f"(store holds {stored!r}) — the dispatch they wait on can "
                "never resolve"
            )
        results = await asyncio.gather(*reqs, return_exceptions=True)
        served = {"work": work, "hash": h}
        for i, r in enumerate(results):
            if r == served:
                continue
            if i == 0 and isinstance(r, asyncio.CancelledError):
                continue  # the raced waiter may abort cleanly
            if isinstance(r, (RetryRequest, RequestTimeout)):
                continue  # clean abort: result raced the teardown
            raise SanitizerFailure(f"request {i} ended wrong: {r!r}")
        # the blocker is a request too: "everyone served or fails
        # cleanly" must hold for it, not just the same-hash trio
        for name, r in zip(
            watched, await asyncio.gather(
                *watched.values(), return_exceptions=True
            )
        ):
            if r == {"work": blocker_work, "hash": blocker_h}:
                continue
            if isinstance(r, (RetryRequest, RequestTimeout)):
                continue
            raise SanitizerFailure(f"request {name} ended wrong: {r!r}")
        await _settle()
        _check_teardown(server)
    finally:
        await server.close()


# ---------------------------------------------------------------------------
# scenario: fleet straggler re-cover
# ---------------------------------------------------------------------------


async def scenario_fleet_recover(perturber: Perturber) -> None:
    """A sharded dispatch loses one worker mid-flight; the supervisor's
    grace window fires under perturbation and the orphaned shard must be
    re-covered exactly once, the eventual result honored, and every cover/
    dispatch table torn down."""
    from .. import obs
    from ..transport.mqtt_codec import encode_result_payload

    server, store, clock = await _start_server(
        perturber,
        fleet=True,
        fleet_min_workers=2,
        fleet_worker_ttl=5.0,
        hedge_after=10,  # the re-cover path, not the hedge, is under test
    )
    recovered_counter = obs.get_registry().counter(
        "dpow_fleet_ranges_recovered_total")
    recovered_before = recovered_counter.value()
    try:
        workers = (("w1", 1.0e6), ("w2", 2.0e6), ("w3", 3.0e6))
        for wid, rate in workers:
            await server.fleet.on_announce(
                json.dumps({"id": wid, "hashrate": rate, "codec": 1})
            )
        h = _scenario_hash(perturber.seed, "recover")
        req = asyncio.ensure_future(server.service_handler(
            {"user": "svc", "api_key": "secret", "hash": h, "timeout": 25}
        ))
        await _settle()
        if not server.fleet.cover.tracked(h):
            raise SanitizerFailure(
                "dispatch did not shard across the announced fleet"
            )
        # w3 goes silent; w1/w2 keep announcing while scenario time passes.
        # ttl 5 + grace 2: by t=8 the supervisor has fired on the silent
        # dispatch with w3 stale — its shard must move to a live worker.
        for _ in range(4):
            await clock.advance(2.0)
            for wid, rate in workers[:2]:
                await server.fleet.on_announce(
                    json.dumps({"id": wid, "hashrate": rate, "codec": 1})
                )
            await _settle()
        recovered = recovered_counter.value() - recovered_before
        if recovered < 1:
            raise SanitizerFailure(
                "w3 went silent past its ttl but no shard was re-covered"
            )
        work = solve(h, EASY_DIFFICULTY)
        await server.client_result_handler(
            "result/ondemand", encode_result_payload(h, work, _payout())
        )
        result = await asyncio.wait_for(req, timeout=30)
        if result != {"work": work, "hash": h}:
            raise SanitizerFailure(f"request served wrong: {result!r}")
        await _settle()
        _check_teardown(server)
        if server.fleet.cover.tracked(h):
            raise SanitizerFailure("cover table leaked past the teardown")
        if server.supervisor.tracked(h):
            raise SanitizerFailure("supervisor entry leaked past the teardown")
    finally:
        await server.close()


# ---------------------------------------------------------------------------
# scenario: replicated takeover vs the dead owner's late result
# ---------------------------------------------------------------------------


async def scenario_takeover(perturber: Perturber) -> None:
    """Two ring replicas over one shared store; the owner dies with a
    forwarded dispatch in flight, and the worker's result for it lands at
    a seed-chosen instant DURING the survivor's adoption pass — before the
    journal read, between the resolved-check and the re-publish, or after
    the supervisor re-arm (the adopt-vs-late-result race, docs/replication.md
    failure matrix). Invariants: the surviving waiter is served or aborts
    cleanly — never stranded while the store holds the answer; the death
    is adopted at most once (nothing double-dispatched); the dead owner's
    journal drains; every per-dispatch side table on the survivor is torn
    down."""
    from .. import obs
    from ..replica import fence, owner_of
    from ..resilience.clock import FakeClock
    from ..server import DpowServer, ServerConfig, hash_key
    from ..server.app import WORK_PENDING
    from ..server.exceptions import RequestTimeout, RetryRequest
    from ..store import MemoryStore
    from ..transport.broker import Broker
    from ..transport.inproc import InProcTransport
    from ..transport.mqtt_codec import encode_result_payload

    clock = FakeClock()
    broker = Broker()
    shared = MemoryStore(shared=True)

    def make(rid: str) -> DpowServer:
        config = ServerConfig(
            base_difficulty=EASY_DIFFICULTY,
            throttle=1000.0,
            heartbeat_interval=3600.0,
            statistics_interval=3600.0,
            work_republish_interval=2.0,
            fleet=False,
            replicas=2,
            replica_id=rid,
            replica_ttl=2.0,
            replica_heartbeat_interval=3600.0,  # cadence driven by poll()
        )
        return DpowServer(
            config,
            PerturbingStore(shared, perturber),
            PerturbingTransport(
                InProcTransport(broker, client_id=f"server-{rid}"), perturber
            ),
            clock=clock,
        )

    a, b = make("ra"), make("rb")
    store = PerturbingStore(shared, perturber)
    await store.hset(
        "service:svc",
        {"api_key": hash_key("secret"), "public": "N",
         "display": "svc", "website": "", "precache": "0", "ondemand": "0"},
    )
    await store.sadd("services", "svc")
    takeovers = obs.get_registry().counter("dpow_replica_takeovers_total")
    takeovers_before = takeovers.value()
    payout = _payout()
    try:
        for s in (a, b):
            await s.setup()
            s.start_loops()
        for s in (a, b):
            await s.replica.poll()
        await _settle()
        # a hash the ring assigns to rb: the request lands on ra and is
        # forwarded to (and journaled by) the owner
        i = 0
        while True:
            h = _scenario_hash(perturber.seed * 1009 + i, "takeover")
            if owner_of(h, ["ra", "rb"]) == "rb":
                break
            i += 1
        req = asyncio.ensure_future(a.service_handler(
            {"user": "svc", "api_key": "secret", "hash": h, "timeout": 25}
        ))
        for _ in range(3000):
            if any(rh == h for rh, _ in await fence.read_dispatches(shared, "rb")):
                break
            await asyncio.sleep(0)
        else:
            raise SanitizerFailure(
                "forwarded dispatch never reached the owner's journal"
            )
        # SIGKILL the owner mid-flight; the survivor absorbs the final
        # heartbeat, then a full silent ttl passes
        await b.crash()
        await a.replica.poll()
        await clock.advance(2.5)
        # THE RACE: the adoption pass and the dead owner's late worker
        # result run concurrently — the perturber's parks/yields slide the
        # result delivery into seed-chosen points of the adopt path
        work = solve(h, EASY_DIFFICULTY)

        async def late_result() -> None:
            for _ in range(perturber.rng.randint(0, 40)):
                await asyncio.sleep(0)
            await a.client_result_handler(
                "result/ondemand", encode_result_payload(h, work, payout)
            )

        await asyncio.gather(a.replica.poll(), late_result())
        for spin in range(3000):
            if req.done():
                break
            if await store.get(f"block:{h}") == WORK_PENDING:
                # the adopted re-publish is live again: answer it
                await a.client_result_handler(
                    "result/ondemand", encode_result_payload(h, work, payout)
                )
            await asyncio.sleep(0)
        else:
            stored = await store.get(f"block:{h}")
            raise SanitizerFailure(
                f"surviving waiter stranded after the owner died "
                f"(store holds {stored!r})"
            )
        result = await asyncio.gather(req, return_exceptions=True)
        r = result[0]
        if r != {"work": work, "hash": h} and not isinstance(
            r, (RetryRequest, RequestTimeout)
        ):
            raise SanitizerFailure(f"surviving waiter ended wrong: {r!r}")
        # at most ONE adopter took the death event — a second adoption
        # would re-publish (double-dispatch) a hash someone already owns
        adopted = takeovers.value() - takeovers_before
        if adopted > 1:
            raise SanitizerFailure(
                f"death event adopted {adopted} times (double-dispatch)"
            )
        await _settle(120)
        if await fence.read_dispatches(shared, "rb"):
            raise SanitizerFailure(
                "the dead owner's journal did not drain after adoption"
            )
        _check_teardown(a)
        if a._forward_origins or a._adopted_orphan:
            raise SanitizerFailure(
                "replica relay/orphan tables leaked past the teardown"
            )
    finally:
        await a.close()
        await b.close()


# ---------------------------------------------------------------------------
# scenario: device fault domains — evacuate vs solve vs cancel vs raise
# ---------------------------------------------------------------------------


async def scenario_devfault(perturber: Perturber, device: str = "cuda") -> str:
    """The torch engine's device fault domains under seed-shuffled
    interleavings of the four things that can race a wedged device:
    the WATCHDOG's evacuation/exhaustion sweep, the SOLVE (the zombie
    wake-up releasing a launch that may already hold the winner), a
    CANCEL, and a RAISE — in every order the seed picks, at perturbed
    yield points. Invariants: the request is served with host-valid work
    or fails CLEANLY (WorkCancelled / DevicesExhausted — never stranded),
    the engine tears down to zero jobs, and the wedged thread always
    drains once the fault lifts (no leaked control slots). On ``cuda`` the
    wedged poll is the run kernel's: its grid spins on the unanswered
    mailbox until the fault is released. Returns the outcome: served,
    cancelled or exhausted."""
    from ..backend import DevicesExhausted, WorkCancelled
    from ..backend.torch_backend import TorchWorkBackend
    from ..chaos import FaultyDevice
    from ..models import WorkRequest
    from ..ops import control as ctl_mod
    from ..resilience.clock import FakeClock
    from ..utils import nanocrypto as nc

    rng = perturber.rng
    unreachable = (1 << 64) - 2
    difficulty = EASY_DIFFICULTY if rng.random() < 0.5 else unreachable
    hang_window = rng.randint(1, 3)
    do_raise = difficulty == EASY_DIFFICULTY and rng.random() < 0.4
    do_cancel = rng.random() < 0.4
    do_advance = rng.random() < 0.6
    if difficulty != EASY_DIFFICULTY or do_raise:
        # an unreachable (or raised-unreachable) target can only end via
        # cancel or exhaustion: keep every seed bounded
        do_cancel = True

    actions = ["release"]
    if do_cancel:
        actions.append("cancel")
    if do_raise:
        actions.append("raise")
    if do_advance:
        actions.append("advance")
    rng.shuffle(actions)

    clock = FakeClock()
    # cuda_kernel.window accepts sublanes=8, iters=8 on both devices: an
    # 8192-nonce window on the CPU, 65536 with the card's nblocks=8.
    b = TorchWorkBackend(
        device=device, sublanes=8, iters=8, run_mode="persistent",
        persistent_steps=4, control_poll_steps=1, pipeline=1, clock=clock,
        device_suspect_after=5.0, device_probe_interval=10.0,
    )
    await b.setup()
    h = _scenario_hash(perturber.seed, "devfault")
    fd = FaultyDevice()
    fd.install()
    try:
        fd.hang_at_poll(0, hang_window)
        task = asyncio.ensure_future(b.generate(WorkRequest(h, difficulty)))
        # let the launch engage (real time; the engine clock stays frozen)
        for _ in range(2000):
            if fd.events or task.done():
                break
            await asyncio.sleep(0.002)
        raised = False
        for action in actions:
            await perturber.point(f"devfault.{action}")
            if action == "release":
                fd.release(0)
            elif action == "cancel":
                await b.cancel(h)
            elif action == "raise":
                # a raise landing after the solve is a legitimate no-op —
                # only a raise that TOOK moves the bar the result must meet
                raised = await b.raise_difficulty(h, unreachable)
            elif action == "advance":
                await clock.advance(7.0)
        await perturber.point("devfault.settle")
        outcome = "served"
        try:
            result = await asyncio.wait_for(task, timeout=60)
        except WorkCancelled:
            result, outcome = None, "cancelled"  # clean abort
        except DevicesExhausted:
            result, outcome = None, "exhausted"  # clean abort
        if result is not None:
            final = unreachable if raised else difficulty
            if nc.work_value(h, result) < final:
                raise SanitizerFailure(
                    f"served work {result} below the final target"
                )
        # the wedged thread must drain once the fault is lifted
        for rec in list(b._inflight):
            if rec.thread_done is not None:
                for _ in range(5000):
                    if rec.thread_done.is_set():
                        break
                    await asyncio.sleep(0.002)
                else:
                    raise SanitizerFailure("launch thread never drained")
        await b.close()
        if b._jobs:
            raise SanitizerFailure(f"jobs leaked past close: {b._jobs}")
        for _ in range(2000):
            with ctl_mod._slots_lock:
                leaked = list(ctl_mod._slots)
            if not leaked:
                break
            await asyncio.sleep(0.002)
        else:
            raise SanitizerFailure(f"control slots leaked: {leaked}")
    finally:
        fd.uninstall()
        await b.close()
    return outcome


# ---------------------------------------------------------------------------
# scenario: autoscale drain vs in-flight dispatch
# ---------------------------------------------------------------------------


async def scenario_autoscale(perturber: Perturber) -> None:
    """The retire-after-drain contract (tpu_dpow_torch/autoscale/) under
    perturbation: a replica holding in-flight AND admission-queued
    dispatches is told to drain at a seed-chosen instant while worker
    results land and fresh arrivals race the toggle. Invariants: every
    pre-drain request is served or fails cleanly (the drain must never
    strand a waiter whose dispatch is already out); every post-drain
    arrival gets the busy contract with reason=draining (never silently
    dispatched on a retiring replica); the drain signal the actuator
    polls (window inflight) really reaches zero; side tables torn down."""
    from ..autoscale.signals import signals_from_snapshot
    from ..sched import Busy
    from ..server.app import WORK_PENDING
    from ..server.exceptions import RequestTimeout, RetryRequest
    from ..transport.mqtt_codec import encode_result_payload
    from .. import obs

    server, store, clock = await _start_server(
        perturber, fleet=False, max_inflight_dispatches=2,
    )
    payout = _payout()
    try:
        hashes = [
            _scenario_hash(perturber.seed * 31 + i, "autoscale")
            for i in range(3)
        ]
        # three distinct hashes against a 2-slot window: one dispatch is
        # QUEUED for admission when the drain lands — the exact
        # scale-down-vs-inflight ordering the static analysis reasons about
        reqs = [
            asyncio.ensure_future(server.service_handler(
                {"user": "svc", "api_key": "secret", "hash": h, "timeout": 25}
            ))
            for h in hashes
        ]
        for _ in range(perturber.rng.randint(0, 60)):
            await asyncio.sleep(0)
        await perturber.point("autoscale.drain")
        server.apply_control({"drain": True, "precache_shed": True})
        # fresh arrivals race the toggle: all must get the busy contract
        late = [
            asyncio.ensure_future(server.service_handler(
                {"user": "svc", "api_key": "secret",
                 "hash": _scenario_hash(perturber.seed * 97 + i, "late"),
                 "timeout": 25}
            ))
            for i in range(2)
        ]
        works = {h: solve(h, EASY_DIFFICULTY) for h in hashes}
        everyone = reqs + late
        for _ in range(2000):
            if all(r.done() for r in everyone):
                break
            for h in hashes:
                if await store.get(f"block:{h}") == WORK_PENDING:
                    await server.client_result_handler(
                        "result/ondemand",
                        encode_result_payload(h, works[h], payout),
                    )
            await asyncio.sleep(0)
        else:
            stranded = [i for i, r in enumerate(everyone) if not r.done()]
            raise SanitizerFailure(
                f"requests {stranded} stranded across the drain — the "
                "retire-after-drain contract lost a waiter"
            )
        for h, r in zip(hashes, await asyncio.gather(
            *reqs, return_exceptions=True
        )):
            if r == {"work": works[h], "hash": h}:
                continue
            if isinstance(r, (RetryRequest, RequestTimeout, Busy)):
                # Busy is legal ONLY for a request still awaiting
                # admission when the drain landed... which cannot happen:
                # draining gates ARRIVALS, not admitted work. Anything
                # here but a clean timeout-class abort is a bug.
                if isinstance(r, Busy):
                    raise SanitizerFailure(
                        f"pre-drain request for {h} bounced busy — drain "
                        "must gate new arrivals, never admitted work"
                    )
                continue
            raise SanitizerFailure(f"pre-drain request ended wrong: {r!r}")
        for r in await asyncio.gather(*late, return_exceptions=True):
            if not isinstance(r, Busy):
                raise SanitizerFailure(
                    f"post-drain arrival ended {r!r} — expected the busy "
                    "contract (a retiring replica must not take new work)"
                )
        await _settle()
        # the signal the actuator's retire loop polls must read drained
        sig, _ = signals_from_snapshot(obs.snapshot(), t=clock.time())
        if server.admission.window.inflight != 0 or sig.inflight != 0:
            raise SanitizerFailure(
                f"window still holds {server.admission.window.inflight} "
                f"slot(s) (signal reads {sig.inflight}) after every "
                "dispatch resolved — the actuator would SIGINT a replica "
                "with live work"
            )
        _check_teardown(server)
    finally:
        await server.close()


# ---------------------------------------------------------------------------
# scenario: precache evict vs on-demand arrival vs lease lapse vs shed
# ---------------------------------------------------------------------------


async def scenario_precache(perturber: Perturber) -> None:
    """The population-scale precache subsystem (tpu_dpow_torch/precache/) under
    seed-shuffled races of everything that can touch one speculative
    dispatch: a confirmation storm over more accounts than the cache
    holds (capacity EVICTION + frontier-supersede), an ON-DEMAND request
    arriving for a frontier the precacher may or may not have finished,
    the admission LEASE lapsing mid-flight (clock advance past
    precache_lease), and the autoscaler's SHED lever flipping on and back
    off. Invariants: the on-demand request is served with valid work or
    misses cleanly (timeout-class abort — never stranded); the cache
    bound is never exceeded at any instant; once every dispatch resolves
    no admission slot or precache lease is stranded and no pending entry
    squats in the budget; side tables torn down."""
    from ..server.app import WORK_PENDING
    from ..server.exceptions import RequestTimeout, RetryRequest
    from ..transport.mqtt_codec import encode_result_payload

    rng = perturber.rng
    capacity = rng.randint(2, 3)
    server, store, clock = await _start_server(
        perturber, fleet=False,
        max_inflight_dispatches=4,
        precache_cache_size=capacity,
        precache_watermark=1.0,  # admission policy = beat-the-lowest at bound
        precache_lease=5.0,
        precache_window_fraction=1.0 if rng.random() < 0.5 else 0.5,
    )
    payout = _payout()
    try:
        # more known accounts than the cache holds: eviction pressure is
        # structural, not incidental. Genesis frontiers make them known
        # without debug mode, so the score policy is really in the loop.
        accounts = [f"acct-{i}" for i in range(capacity + 2)]
        genesis = {}
        for i, acct in enumerate(accounts):
            g = _scenario_hash(perturber.seed * 131 + i, "precache-genesis")
            genesis[acct] = g
            await store.set(f"account:{acct}", g)
        hot = accounts[0]
        c1 = _scenario_hash(perturber.seed * 7 + 1, "precache-hot")
        c2 = _scenario_hash(perturber.seed * 7 + 2, "precache-hot")
        confs = [(c1, hot, genesis[hot]), (c2, hot, c1)]
        for i, acct in enumerate(accounts[1:], start=1):
            confs.append((
                _scenario_hash(perturber.seed * 11 + i, "precache-cold"),
                acct, genesis[acct],
            ))
        if rng.random() < 0.5:
            # a re-announce racing the original: the frontier fence
            # (getset) must give exactly one caller the dispatch
            confs.append((c2, hot, c1))
        rng.shuffle(confs)
        hashes = list({h for h, _, _ in confs})
        works = {h: solve(h, EASY_DIFFICULTY) for h in hashes}

        conf_tasks = []
        for h, acct, prev in confs:
            conf_tasks.append(asyncio.ensure_future(
                server.block_arrival_handler(h, acct, prev)
            ))
            for _ in range(rng.randint(0, 3)):
                await asyncio.sleep(0)
        # the on-demand arrival races the speculative solves: a READY
        # entry serves from the store, a pending one coalesces onto the
        # in-flight dispatch, a refused/evicted one pays on-demand
        h_req = rng.choice(hashes)
        req = asyncio.ensure_future(server.service_handler(
            {"user": "svc", "api_key": "secret", "hash": h_req, "timeout": 25}
        ))
        do_shed = rng.random() < 0.6
        do_lapse = rng.random() < 0.6
        shed_at = rng.randint(0, 40)
        lift_at = shed_at + rng.randint(5, 40)
        lapse_at = rng.randint(0, 60)
        everyone = conf_tasks + [req]
        for spin in range(2000):
            if len(server.precache_cache) > capacity:
                raise SanitizerFailure(
                    f"cache bound exceeded: {len(server.precache_cache)} "
                    f"entries in a capacity-{capacity} cache"
                )
            if do_shed and spin == shed_at:
                await perturber.point("precache.shed")
                server.apply_control({"precache_shed": True})
            if do_shed and spin == lift_at:
                server.apply_control({"precache_shed": False})
            if do_lapse and spin == lapse_at:
                # past precache_lease + the admission sweep interval: the
                # poll loop lapses every unresolved speculative lease
                await clock.advance(6.0)
            if all(t.done() for t in everyone):
                break
            for h in hashes:
                if await store.get(f"block:{h}") == WORK_PENDING:
                    wt = await store.get(f"work-type:{h}") or "ondemand"
                    await server.client_result_handler(
                        f"result/{wt}",
                        encode_result_payload(h, works[h], payout),
                    )
            await asyncio.sleep(0)
        else:
            stranded = [i for i, t in enumerate(everyone) if not t.done()]
            stored = await store.get(f"block:{h_req}")
            raise SanitizerFailure(
                f"tasks {stranded} stranded across the precache races "
                f"(store holds {stored!r} for the requested hash)"
            )
        for t in conf_tasks:
            t.result()  # a confirmation must never raise out of the seam
        r = (await asyncio.gather(req, return_exceptions=True))[0]
        if r != {"work": works[h_req], "hash": h_req} and not isinstance(
            r, (RetryRequest, RequestTimeout)
        ):
            raise SanitizerFailure(
                f"on-demand request ended wrong: {r!r} — a precache hit "
                "must serve and a miss must fail cleanly"
            )
        if do_shed:
            server.apply_control({"precache_shed": False})
        # drain every still-pending speculative dispatch, then lapse and
        # reap whatever never resolved: the budget must not be squatted
        for _ in range(1000):
            pending = [
                h for h in hashes
                if await store.get(f"block:{h}") == WORK_PENDING
            ]
            if not pending:
                break
            for h in pending:
                wt = await store.get(f"work-type:{h}") or "ondemand"
                await server.client_result_handler(
                    f"result/{wt}", encode_result_payload(h, works[h], payout)
                )
            await asyncio.sleep(0)
        else:
            raise SanitizerFailure("speculative dispatches never drained")
        await _settle()
        await clock.advance(6.0)
        await _settle()
        await server.precache.flush()
        server.admission.poll()
        server.precache.reap_lapsed()
        for entry in server.precache_cache.entries():
            if entry.state != "ready":
                raise SanitizerFailure(
                    f"entry {entry.block_hash} stranded {entry.state} in "
                    "the budget after every dispatch resolved"
                )
        if server.admission.precache_inflight != 0:
            raise SanitizerFailure(
                f"{server.admission.precache_inflight} precache lease(s) "
                "still hold window slots after every dispatch resolved"
            )
        if server.admission.window.inflight != 0:
            raise SanitizerFailure(
                f"window still holds {server.admission.window.inflight} "
                "slot(s) after every dispatch resolved"
            )
        _check_teardown(server)
    finally:
        await server.close()


SCENARIOS: Dict[str, Callable] = {
    "coalesce": scenario_coalesce,
    "fleet_recover": scenario_fleet_recover,
    "takeover": scenario_takeover,
    "devfault": scenario_devfault,
    "autoscale": scenario_autoscale,
    "precache": scenario_precache,
}


# ---------------------------------------------------------------------------
# the runner
# ---------------------------------------------------------------------------


@dataclass
class SeedRun:
    scenario: str
    seed: int
    ok: bool
    trace_digest: str
    error: str = ""
    tb_paths: Tuple[str, ...] = ()
    #: resources the LeakLedger still held at teardown (0 on a clean run
    #: — the DPOW11xx zero-outstanding invariant, obs/ledger.py)
    outstanding: int = 0
    #: order-sensitive digest of the ledger's acquire/release trace; the
    #: same seed must reproduce it exactly (pinned for the event-loop
    #: deterministic scenarios in tests/test_torch_analysis.py)
    ledger_digest: str = ""
    #: what a scenario that reports one ended with (devfault: served,
    #: cancelled or exhausted); "" for the others
    outcome: str = ""


@dataclass
class SanitizerReport:
    runs: List[SeedRun] = field(default_factory=list)

    @property
    def failures(self) -> List[SeedRun]:
        return [r for r in self.runs if not r.ok]

    @property
    def seeds(self) -> int:
        return len({r.seed for r in self.runs})

    @property
    def ledger_outstanding(self) -> int:
        """Total resources the LeakLedger held at teardown, summed over
        every run (0 = the zero-outstanding invariant held everywhere;
        the ``LEDGER=`` headline in scripts/run_tier1.sh)."""
        return sum(r.outstanding for r in self.runs)

    def render(self) -> str:
        lines = []
        per: Dict[str, List[SeedRun]] = {}
        for r in self.runs:
            per.setdefault(r.scenario, []).append(r)
        for name, runs in per.items():
            ok = sum(1 for r in runs if r.ok)
            outcomes: Dict[str, int] = {}
            for r in runs:
                if r.outcome:
                    outcomes[r.outcome] = outcomes.get(r.outcome, 0) + 1
            lines.append(
                f"dpowsan: scenario={name} seeds={len(runs)} ok={ok}"
                + "".join(f" {k}={v}" for k, v in sorted(outcomes.items()))
            )
        for r in self.failures:
            lines.append(
                f"dpowsan: FAIL scenario={r.scenario} seed={r.seed} "
                f"trace={r.trace_digest}\n{r.error}"
            )
        if self.failures:
            lines.append(
                f"dpowsan: {len(self.failures)} failure(s) — reproduce one "
                "with --san --san_seeds 1 --san_base_seed <seed>"
            )
        else:
            lines.append(
                f"dpowsan: clean ({len(self.runs)} runs, {self.seeds} seeds "
                "per scenario)"
            )
        outstanding = self.ledger_outstanding
        lines.append(
            "dpowsan: ledger "
            + ("clean (0 outstanding)" if outstanding == 0
               else f"{outstanding} outstanding resource(s) at teardown")
        )
        return "\n".join(lines)


def run_seed(scenario_name: str, seed: int, device: str = "cuda") -> SeedRun:
    """One reproducible scenario run under one seed.

    Besides the scenario's own asserts, every run carries the DPOW11xx
    runtime invariant: the LeakLedger (obs/ledger.py) is reset before the
    scenario and must read ZERO outstanding resources — tickets, leases,
    slots, claims, gates, futures, origin entries, bg tasks — after it,
    i.e. every acquire the run performed was discharged on some path the
    seed exercised. A nonzero ledger is a leak the static DPOW1101 pass
    reasons about, caught live. ``device`` goes to the device-fault
    scenario's engine."""
    from ..obs.ledger import LEDGER

    perturber = Perturber(seed)
    scenario = SCENARIOS[scenario_name]
    LEDGER.reset()
    run = (
        scenario(perturber, device=device)
        if scenario is scenario_devfault else scenario(perturber)
    )
    try:
        outcome = asyncio.run(asyncio.wait_for(run, timeout=120)) or ""
    except Exception as e:
        tb = traceback.format_exc()
        paths = tuple(
            sorted({
                frame.filename[frame.filename.find(PACKAGE):]
                for frame in traceback.extract_tb(e.__traceback__)
                if PACKAGE in frame.filename
            })
        )
        return SeedRun(
            scenario_name, seed, False, perturber.digest(),
            error=tb.strip().splitlines()[-1] + f"\n{tb}", tb_paths=paths,
            outstanding=sum(LEDGER.outstanding().values()),
            ledger_digest=LEDGER.trace_digest(),
        )
    leaked = LEDGER.outstanding()
    if leaked:
        detail = ", ".join(
            f"{kind}={count}" for kind, count in sorted(leaked.items())
        )
        keys = ", ".join(LEDGER.outstanding_keys())
        return SeedRun(
            scenario_name, seed, False, perturber.digest(),
            error=(
                f"LeakLedger: {sum(leaked.values())} resource(s) still "
                f"outstanding at teardown ({detail}) — leaked: {keys}"
            ),
            outstanding=sum(leaked.values()),
            ledger_digest=LEDGER.trace_digest(),
        )
    return SeedRun(
        scenario_name, seed, True, perturber.digest(),
        ledger_digest=LEDGER.trace_digest(), outcome=outcome,
    )


def run_seeds(
    seeds: int,
    base_seed: int = 0,
    scenarios: Optional[Sequence[str]] = None,
    device: str = "cuda",
) -> SanitizerReport:
    report = SanitizerReport()
    for name in scenarios or SCENARIOS:
        for seed in range(base_seed, base_seed + seeds):
            report.runs.append(run_seed(name, seed, device))
    return report


# ---------------------------------------------------------------------------
# folding runs back onto the static findings
# ---------------------------------------------------------------------------

CONFIRMED = "confirmed"
NOT_REPRODUCED = "not-reproduced"
UNEXERCISED = "unexercised"


#: the static race classes dpowsan's scenarios can exercise: DPOW801
#: check-then-act candidates, DPOW1001 epoch-fence candidates (the
#: device-fault and takeover scenarios drive exactly the stale-epoch
#: apply paths the fence checker reasons about), and DPOW1101
#: release-on-all-paths candidates (the LeakLedger's zero-outstanding
#: teardown invariant is the runtime twin of that static judgment).
ANNOTATED_CODES = ("DPOW801", "DPOW1001", "DPOW1101")


def annotate(findings, report: SanitizerReport) -> Dict[str, str]:
    """Finding.key() → confirmed / not-reproduced / unexercised.

    ``confirmed``: a failing run's traceback touches the finding's file.
    ``not-reproduced``: the finding's module is on the scenarios' hot path
    and no seed failed there — evidence (not proof) the candidate is
    benign or already guarded. ``unexercised``: the scenarios never drive
    that module; the static verdict stands alone.
    """
    failing_paths = set()
    for run in report.failures:
        failing_paths.update(run.tb_paths)
    out: Dict[str, str] = {}
    for finding in findings:
        if finding.code not in ANNOTATED_CODES:
            continue
        if finding.path in failing_paths:
            out[finding.key()] = CONFIRMED
        elif any(finding.path.startswith(p) for p in INSTRUMENTED_PREFIXES):
            out[finding.key()] = NOT_REPRODUCED
        else:
            out[finding.key()] = UNEXERCISED
    return out
