"""chaos_demo: a scripted drop/fail/recover scenario, end to end.

The port's copy of ``tpu_dpow/scripts/chaos_demo.py``. One process, one
event loop, zero real sleeps: an in-proc broker, a DpowServer on a
FakeClock, a worker whose primary engine is scripted to fail, and a store
whose backend is scripted to die and come back. The script walks the
resilience layer through every state it has —

  1. the first work/ publish is DROPPED → the dispatch supervisor
     re-publishes after its grace window, then escalates to hedged
     dispatch;
  2. the primary engine throws WorkError three times → its circuit
     breaker opens and the fallback engine serves (the port's
     FailoverBackend);
  3. the primary store dies mid-run → DegradedStore keeps serving from
     memory and journals writes, then reconciles when the backend heals;

— then the fleet scenario (a worker killed mid-range, its shard re-covered)
and the device scenario (a member of the torch engine's persistent fan
wedged, evacuated, quarantined and re-admitted), and prints the chaos event
log plus the obs snapshot of every family involved, which is the same view
an operator gets from GET /metrics in production.

Run it:  python -m tpu_dpow_torch.scripts.chaos_demo [--device cuda|cpu] [--members N]

The device scenario fans over every visible card by default (``--device
cuda``). It evacuates a wedged member onto the others, so it needs at least
two members: with one card it stops and exits non-zero; ``--device cpu
--members 8`` runs it on eight logical members of the CPU.
"""

from __future__ import annotations

import argparse
import asyncio
import hashlib
import json
import struct
import sys
from typing import Optional

from .. import obs
from ..backend import WorkBackend
from ..chaos import (
    DROP,
    ERROR,
    FakeClock,
    FaultSchedule,
    FaultyBackend,
    FaultyStore,
    FaultyTransport,
    Rule,
    join_client,
)
from ..client import ClientConfig, DpowClient
from ..resilience import FailoverBackend
from ..server import DpowServer, ServerConfig, hash_key
from ..store import DegradedStore, MemoryStore
from ..transport.broker import Broker
from ..transport.inproc import InProcTransport
from ..utils import nanocrypto as nc

EASY = 0xFF00000000000000  # ~256 hashes expected: instant on the host CPU
PAYOUT = nc.encode_account(bytes(range(32)))

RESILIENCE_FAMILIES = (
    "dpow_server_supervised_dispatches",
    "dpow_server_redispatch_total",
    "dpow_server_redispatch_abandoned_total",
    "dpow_server_work_republished_total",
    "dpow_breaker_state",
    "dpow_breaker_transitions_total",
    "dpow_breaker_failures_total",
    "dpow_client_backend_served_total",
    "dpow_client_backend_failover_total",
    "dpow_store_degraded",
    "dpow_store_degraded_transitions_total",
    "dpow_store_journal_depth",
    "dpow_store_journal_dropped_total",
    "dpow_chaos_injected_total",
)


class BruteBackend(WorkBackend):
    """Host-side brute force — instant at the demo's easy difficulty."""

    async def setup(self):
        pass

    async def generate(self, request):
        h = bytes.fromhex(request.block_hash)
        w = 0
        while True:
            v = int.from_bytes(
                hashlib.blake2b(
                    struct.pack("<Q", w) + h, digest_size=8
                ).digest(),
                "little",
            )
            if v >= request.difficulty:
                return f"{w:016x}"
            w += 1

    async def cancel(self, block_hash):
        pass


async def _settle(seconds: float = 0.05) -> None:
    # Real-time settling for event-loop handoffs only; every chaos timer
    # (grace windows, probe intervals) runs on the fake clock.
    await asyncio.sleep(seconds)


async def scenario() -> dict:
    obs.reset()
    clock = FakeClock()
    broker = Broker()

    # -- seam 3: the store dies after serving the first request ----------
    store_faults = FaultSchedule([
        Rule(op="*", pattern="*", action=ERROR, times=3, after=30),
    ])
    primary = MemoryStore()
    store = DegradedStore(
        FaultyStore(primary, store_faults), probe_interval=4.0, clock=clock
    )

    # -- seam 1: the first work publish evaporates ------------------------
    transport_faults = FaultSchedule([
        Rule(op="publish", pattern="work/*", action=DROP, times=1),
    ])
    config = ServerConfig(
        base_difficulty=EASY, throttle=1000.0, heartbeat_interval=0.05,
        statistics_interval=3600.0, work_republish_interval=2.0, hedge_after=2,
    )
    server = DpowServer(
        config, store,
        FaultyTransport(
            InProcTransport(broker, client_id="server"), transport_faults,
            clock=clock,
        ),
        clock=clock,
    )
    await server.setup()
    server.start_loops()
    await store.hset("service:demo", {"api_key": hash_key("demo"),
                                      "public": "N", "precache": "0",
                                      "ondemand": "0"})
    await store.sadd("services", "demo")

    # -- seam 2: the worker's primary engine fails three times ------------
    engine_faults = FaultSchedule([Rule(op="generate", action=ERROR, times=3)])
    chain = FailoverBackend(
        [("flaky", FaultyBackend(BruteBackend(), engine_faults)),
         ("steady", BruteBackend())],
        failure_threshold=3, reset_timeout=60.0, clock=clock,
    )
    client = DpowClient(
        ClientConfig(payout_address=PAYOUT, startup_heartbeat_wait=3.0),
        InProcTransport(broker, client_id="demo-worker"),
        backend=chain,
    )
    # re-beat the heartbeat through the startup gate — the server's
    # clock-driven beat loop only fires when scenario time advances
    await join_client(client, server)
    client.start_loops()

    log: list = []
    try:
        # request 1: publish dropped → healed by supervised re-dispatch;
        # engine failure #1 → served by the fallback.
        h1 = f"{1:064X}"
        req1 = asyncio.ensure_future(server.service_handler(
            {"user": "demo", "api_key": "demo", "hash": h1, "timeout": 20}
        ))
        await _settle()
        log.append("work publish for request 1 dropped by chaos; waiting "
                   "out the supervisor grace window (fake clock)")
        await clock.advance(2.0)  # grace → re-dispatch
        resp1 = await asyncio.wait_for(req1, 10)
        nc.validate_work(h1, resp1["work"], EASY)
        log.append(f"request 1 healed via re-dispatch "
                   f"(work_republished={server.work_republished}); engine "
                   f"'flaky' failed once, 'steady' served")

        # requests 2-4: engine failures #2-#3 trip the breaker; the store
        # outage begins mid-stream and every request still completes.
        for i in range(2, 5):
            h = f"{i:064X}"
            resp = await asyncio.wait_for(server.service_handler(
                {"user": "demo", "api_key": "demo", "hash": h, "timeout": 20}
            ), 10)
            nc.validate_work(h, resp["work"], EASY)
        log.append(f"breaker 'backend:flaky' now "
                   f"{chain.breakers['flaky'].state} after "
                   f"{engine_faults.fired(ERROR)} failures; fallback serving")
        if store.degraded:
            log.append("store went DEGRADED mid-stream; requests kept "
                       "completing from the in-memory fallback")

        # drive the store through recovery: each probe window elapses on
        # the fake clock; the first probes burn the outage's remaining
        # error budget, then the journal replays into the healed primary.
        for _ in range(4):
            if not store.degraded:
                break
            await clock.advance(4.0)
            await store.get("block:recovery-probe")
        log.append(
            "store recovered and reconciled"
            if not store.degraded else "store still degraded (unexpected)"
        )
    finally:
        await client.close()
        await server.close()

    snapshot = obs.snapshot()
    return {
        "narrative": log,
        "chaos_events": [
            {"op": op, "subject": subject[:16], "action": action}
            for schedule in (transport_faults, engine_faults, store_faults)
            for op, subject, action in schedule.events
        ],
        "metrics": {
            name: snapshot[name] for name in RESILIENCE_FAMILIES
            if name in snapshot
        },
        "primary_store_reconciled": not store.degraded,
    }


FLEET_FAMILIES = (
    "dpow_fleet_workers_live",
    "dpow_fleet_workers_registered",
    "dpow_fleet_hashrate_hs",
    "dpow_fleet_announces_total",
    "dpow_fleet_dispatch_total",
    "dpow_fleet_ranges_recovered_total",
    "dpow_fleet_redundancy_ratio",
)


class _ParkedBackend(WorkBackend):
    """Backend the fleet scenario drives by hand: records the assigned
    shard, solves only when the script says so (honoring the range the
    way the torch/native engines do — scan upward from the shard start)."""

    def __init__(self):
        self.requests = {}
        self.futures = {}
        self.covered = {}

    async def setup(self):
        pass

    async def generate(self, request):
        self.requests[request.block_hash] = request
        fut = asyncio.get_running_loop().create_future()
        self.futures[request.block_hash] = fut
        return await fut

    async def cancel(self, block_hash):
        fut = self.futures.get(block_hash)
        if fut and not fut.done():
            from ..backend import WorkCancelled

            fut.set_exception(WorkCancelled(block_hash))

    async def cover_range(self, block_hash, nonce_range):
        if block_hash not in self.futures or self.futures[block_hash].done():
            return False
        self.covered[block_hash] = nonce_range
        return True

    def solve_from(self, block_hash, difficulty, start):
        h = bytes.fromhex(block_hash)
        w = start
        while True:
            v = int.from_bytes(
                hashlib.blake2b(
                    struct.pack("<Q", w & ((1 << 64) - 1)) + h, digest_size=8
                ).digest(),
                "little",
            )
            if v >= difficulty:
                break
            w += 1
        work = f"{w & ((1 << 64) - 1):016x}"
        self.futures[block_hash].set_result(work)
        return work


async def fleet_scenario() -> dict:
    """Fleet coordination end to end (docs/fleet.md): three workers join
    and announce, a dispatch shards the nonce space across them, one
    worker is killed mid-range, the supervisor's grace window hands the
    orphaned shard to a live worker, and the result lands — attributed to
    the re-covering worker's hashrate EMA. FakeClock: the worker ttl and
    grace windows play out in milliseconds."""
    obs.reset()
    clock = FakeClock()
    broker = Broker()
    store = MemoryStore()
    config = ServerConfig(
        base_difficulty=EASY, throttle=1000.0, heartbeat_interval=0.05,
        statistics_interval=3600.0, work_republish_interval=2.0,
        hedge_after=10, fleet_worker_ttl=5.0,
    )
    server = DpowServer(
        config, store, InProcTransport(broker, client_id="server"), clock=clock
    )
    await server.setup()
    server.start_loops()
    await store.hset("service:demo", {"api_key": hash_key("demo"),
                                      "public": "N", "precache": "0",
                                      "ondemand": "0"})
    await store.sadd("services", "demo")

    log: list = []
    clients = []
    for i, rate in enumerate((1e6, 2e6, 4e6), 1):
        c = DpowClient(
            ClientConfig(payout_address=PAYOUT, startup_heartbeat_wait=3.0,
                         worker_id=f"fleet-w{i}", declared_hashrate=rate,
                         fleet_announce_interval=3600.0),
            InProcTransport(broker, client_id=f"fleet-w{i}",
                            clean_session=False),
            backend=_ParkedBackend(),
        )
        await join_client(c, server)
        c.start_loops()
        clients.append(c)
    try:
        await _settle()
        live = server.fleet_registry.live_workers("ondemand")
        log.append(f"{len(live)} workers announced "
                   f"({', '.join(i.worker_id for i in live)}); registry live")

        h = f"{9:064X}"
        req = asyncio.ensure_future(server.service_handler(
            {"user": "demo", "api_key": "demo", "hash": h, "timeout": 25}
        ))
        await _settle()
        shards = {
            c.worker_id: c.work_handler.backend.requests[h].nonce_range
            for c in clients
        }
        log.append("dispatch SHARDED: " + "; ".join(
            f"{w} [{s:016x}+{ln:016x}]" for w, (s, ln) in shards.items()))

        victim = clients[2]  # the fastest worker owns the widest shard
        victim.config.fleet = False  # die silently — no goodbye
        await victim.close()
        log.append(f"{victim.worker_id} KILLED mid-range (no goodbye)")
        for _ in range(2):  # survivors keep announcing while victim ages out
            await clock.advance(2.0)
            for c in clients[:2]:
                await c._announce()
            await _settle()
        await clock.advance(2.0)
        await _settle()
        taker = next(
            c for c in clients[:2]
            if c.work_handler.backend.covered.get(h) is not None
        )
        log.append(
            f"supervisor grace fired: {victim.worker_id}'s shard re-covered "
            f"onto {taker.worker_id} "
            f"(ranges_recovered_total="
            f"{int(obs.get_registry().counter('dpow_fleet_ranges_recovered_total').value())})"
        )
        await clock.advance(0.5)
        start = shards[victim.worker_id][0]
        work = taker.work_handler.backend.solve_from(h, EASY, start)
        resp = await asyncio.wait_for(req, 10)
        assert resp["work"] == work
        nc.validate_work(h, work, EASY)
        await _settle()
        ema = server.fleet_registry.get(taker.worker_id).ema_hashrate
        log.append(f"result landed from the orphaned shard; win attributed "
                   f"to {taker.worker_id} (measured EMA {ema:.3g} H/s)")
    finally:
        for c in clients:
            if c.transport.connected:
                await c.close()
        await server.close()

    snapshot = obs.snapshot()
    return {
        "narrative": log,
        "metrics": {
            name: snapshot[name] for name in FLEET_FAMILIES
            if name in snapshot
        },
        "recovered_ranges": snapshot[
            "dpow_fleet_ranges_recovered_total"]["series"][""],
        "result_landed": True,
    }


DEVICE_FAMILIES = (
    "dpow_backend_device_health",
    "dpow_backend_evacuations_total",
    "dpow_backend_quarantine_total",
    "dpow_backend_launch_threads_leaked_total",
    "dpow_chaos_injected_total",
)


def visible_members(device: str) -> int:
    """Members the device scenario's fan gets by default: every visible
    card on ``cuda``, the CPU's logical fan members on ``cpu``."""
    import torch

    from ..parallel.fan_search import fan_devices

    try:
        return len(fan_devices(-1, torch.device(device).type))
    except ValueError:
        return 0


def members_problem(device: str, members: int) -> Optional[str]:
    """Why the device scenario cannot run with ``members`` members, or None."""
    if members >= 2:
        return None
    return (
        f"the device scenario needs at least 2 fan members (it evacuates a "
        f"wedged member onto the others), but --device {device} gives "
        f"{members}; run it with --device cpu --members 8"
    )


async def device_scenario(device: str = "cuda", members: Optional[int] = None) -> dict:
    """Device fault domains end to end: an n-way persistent fan of the
    torch engine loses member 3 mid-launch (it stops polling — a wedged
    card), the watchdog declares it suspect, evacuates its uncovered nonce
    range onto the healthy members, the solve lands from the evacuated
    range at degraded width, the zombie wake-up bounces off the kill fence,
    and a successful probe re-admits the member. FakeClock: the suspect
    deadline and probe interval play out in milliseconds."""
    import hashlib as _hl
    import itertools as _it

    from ..backend.torch_backend import TorchWorkBackend
    from ..chaos import FaultyDevice
    from ..models import WorkRequest
    from ..resilience import HEALTHY, QUARANTINED

    n = visible_members(device) if members is None else members
    problem = members_problem(device, n)
    if problem is not None:
        raise ValueError(problem)
    obs.reset()
    clock = FakeClock()
    victim = min(3, n - 1)
    log: list = []
    val = nc.work_value_int  # planted-difficulty arithmetic on raw nonces

    b = TorchWorkBackend(
        device=device, sublanes=8, iters=2, devices=n, max_batch=1,
        run_mode="persistent", persistent_steps=4, control_poll_steps=1,
        pipeline=1, clock=clock,
        device_suspect_after=10.0, device_probe_interval=30.0,
    )
    await b.setup()
    span_dev = b.chunk_per_shard
    hx = _hl.blake2b(b"chaos-devfault", digest_size=32).hexdigest().upper()
    h = bytes.fromhex(hx)
    S, stride = 1 << 40, 1 << 20
    L = n * stride
    # Plant the solution in the victim's UNCOVERED remainder: the floor
    # covers everything any device can scan before the evacuation.
    pre: list = []
    for d in range(n):
        width = 4 * span_dev if d != victim else 2 * span_dev
        pre.extend(range(S + d * stride, S + d * stride + width))
    floor = max(val(h, x) for x in pre)
    f_dead = S + victim * stride + span_dev
    planted = next(x for x in _it.count(f_dead) if val(h, x) > floor)
    diff = val(h, planted)

    async def spin(cond, msg, timeout=60.0):
        deadline = asyncio.get_event_loop().time() + timeout
        while not cond():
            if asyncio.get_event_loop().time() >= deadline:
                raise TimeoutError(msg)
            await asyncio.sleep(0.005)

    with FaultyDevice() as fd:
        fd.hang_at_poll(victim, 2)
        req = asyncio.ensure_future(
            b.generate(WorkRequest(hx, diff, nonce_range=(S, L)))
        )
        await spin(
            lambda: any(r.control is not None for r in b._inflight),
            "no persistent launch",
        )
        rec = next(r for r in b._inflight if r.control is not None)
        await spin(
            lambda: ("poll", victim, 2) in fd.events,
            f"device {victim} never wedged",
        )
        await spin(
            lambda: all(
                rec.control.device_accounted(s, 4, 1)
                for s in range(n) if s != victim
            ),
            "healthy devices not accounted",
        )
        log.append(
            f"{n}-way persistent fan launched; device {victim} wedged at "
            f"its control poll (chaos hang-at-poll) while the other "
            f"{n - 1} kept polling"
        )
        await clock.advance(13.0)
        assert b._dfd.state(victim) == QUARANTINED
        evacs = obs.get_registry().counter(
            "dpow_backend_evacuations_total", labelnames=("reason",)
        ).value("stalled_poll")
        log.append(
            f"watchdog: device {victim} suspect -> range "
            f"[{f_dead:016x}, ...) evacuated onto {n - 1} healthy devices "
            f"(evacuations_total={int(evacs)}) -> quarantined"
        )
        fd.release(victim)  # the zombie wakes against the kill fence
        work = await asyncio.wait_for(req, 90)
        nc.validate_work(hx, work, diff)
        assert int(work, 16) >= f_dead
        log.append(
            f"solve {work} landed FROM THE EVACUATED RANGE at degraded "
            f"fan width, inside the request's deadline; zombie launch "
            f"drained without touching the frontier (epoch fence)"
        )
        while b._dfd.state(victim) != HEALTHY and not any(
            not p.done() for p in b._probe_tasks.values()
        ):
            await clock.advance(2.6)
        await spin(
            lambda: b._dfd.state(victim) == HEALTHY, "probe never re-admitted"
        )
        log.append(
            f"probe interval elapsed -> single-launch probe succeeded -> "
            f"device {victim} re-admitted; fan back to full width {n}"
        )
    await b.close()

    snapshot = obs.snapshot()
    return {
        "narrative": log,
        "metrics": {
            name: snapshot[name] for name in DEVICE_FAMILIES
            if name in snapshot
        },
        "evacuations": snapshot[
            "dpow_backend_evacuations_total"]["series"].get("stalled_poll", 0),
        "readmitted": True,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="torch device of the device scenario's fan: cuda or cpu")
    p.add_argument("--members", type=int, default=None,
                   help="fan members of the device scenario (default: every "
                   "visible card on cuda, 8 on cpu)")
    args = p.parse_args(argv)
    members = visible_members(args.device) if args.members is None else args.members
    problem = members_problem(args.device, members)
    if problem is not None:
        print(f"chaos_demo: {problem}", file=sys.stderr)
        return 2

    result = asyncio.run(asyncio.wait_for(scenario(), timeout=60))
    print("=== chaos demo: drop / fail / recover ===")
    for line in result["narrative"]:
        print(f"  * {line}")
    print("\n=== injected faults ===")
    for event in result["chaos_events"]:
        print(f"  {event['op']:<10} {event['action']:<10} {event['subject']}")
    print("\n=== obs snapshot (resilience families) ===")
    print(json.dumps(result["metrics"], indent=2, sort_keys=True))
    ok = result["primary_store_reconciled"]
    print(f"\nscenario {'completed' if ok else 'FAILED'}: every request "
          f"served through dropped publishes, a tripped engine and a store "
          f"outage")

    fleet = asyncio.run(asyncio.wait_for(fleet_scenario(), timeout=60))
    print("\n=== chaos demo: fleet join / shard / kill / re-cover ===")
    for line in fleet["narrative"]:
        print(f"  * {line}")
    print("\n=== obs snapshot (fleet families) ===")
    print(json.dumps(fleet["metrics"], indent=2, sort_keys=True))
    fleet_ok = fleet["result_landed"] and fleet["recovered_ranges"] >= 1
    print(f"\nfleet scenario {'completed' if fleet_ok else 'FAILED'}: "
          f"sharded dispatch survived a mid-range worker death via "
          f"re-cover")

    device = asyncio.run(asyncio.wait_for(
        device_scenario(args.device, members), timeout=180))
    print("\n=== chaos demo: device hang / evacuate / quarantine / probe ===")
    for line in device["narrative"]:
        print(f"  * {line}")
    print("\n=== obs snapshot (device fault-domain families) ===")
    print(json.dumps(device["metrics"], indent=2, sort_keys=True))
    device_ok = device["readmitted"] and device["evacuations"] >= 1
    print(f"\ndevice scenario {'completed' if device_ok else 'FAILED'}: "
          f"the fan survived a mid-launch device hang via evacuation and "
          f"probe re-admission")
    return 0 if (ok and fleet_ok and device_ok) else 1


if __name__ == "__main__":
    raise SystemExit(main())
