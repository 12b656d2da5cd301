"""The port's fleet layer (fleet/: WorkerRegistry, FleetPlanner,
CoverageTracker, FleetCoordinator) held against tpu_dpow's,
differentially — twins of tests/test_fleet.py's unit tests.

The same numpy-seeded announce script (joins, refreshes, goodbyes, garbage,
codec capabilities, clock advances) fills both packages' registries on a
FakeClock; the same registry must give the same ``Plan`` and the same cover
ranges, and both coordinators must publish the same (topic, payload)
sequence — the binary v1 lane frames included, which each package's wire
codec must decode from the other's.
"""

import asyncio
import importlib
import json
import time

import numpy as np
import pytest

PKGS = ("tpu_dpow", "tpu_dpow_torch")
EASY = 0xFF00000000000000
SPACE = 1 << 64
DIFFS = (EASY, 0xFFFFFFC000000000, 0xFFFFFFF800000000, 0xFFFFFE0000000000)


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, timeout=30))


def both(fn, *args):
    out = {pkg: fn(pkg, *args) for pkg in PKGS}
    assert out["tpu_dpow"] == out["tpu_dpow_torch"]
    return out["tpu_dpow"]


def announce_script(seed: int, n: int = 40) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        r = int(rng.integers(10))
        wid = f"w{int(rng.integers(1, 7))}"
        if r == 0:
            out.append(("advance", float(rng.choice([1.0, 4.0, 11.0]))))
        elif r == 1:
            out.append(("announce", json.dumps({"id": wid, "bye": True})))
        elif r == 2:
            out.append(("announce", ["not json", json.dumps({"id": "bad/id"}),
                                     json.dumps({"nope": 1})][int(rng.integers(3))]))
        else:
            out.append(("announce", json.dumps({
                "v": 1, "id": wid, "backend": ["jax", "torch", "native"][int(rng.integers(3))],
                "concurrency": int(rng.integers(1, 16)),
                "hashrate": float(rng.choice([0.0, 1e6, 2e6, 3e6, 8e6, 5e7])),
                "work": [["precache", "ondemand"], ["ondemand"], ["precache"]][int(rng.integers(3))],
                "codec": int(rng.integers(0, 2)),
            })))
    return out


def _info(i) -> tuple:
    return (i.worker_id, i.backend, i.concurrency, i.declared_hashrate, i.ema_hashrate,
            i.work_types, i.codec, i.announces, i.last_seen)


async def _registry(pkg, script, ttl=10.0, store=None):
    clock = mod(pkg, "resilience").FakeClock()
    store = store or mod(pkg, "store").MemoryStore()
    reg = mod(pkg, "fleet").WorkerRegistry(store, clock=clock, ttl=ttl)
    trace = []
    for op, arg in script:
        if op == "advance":
            await clock.advance(arg)
            trace.append(("advance", reg.expire()))
        else:
            got = await reg.handle_announce(arg)
            trace.append(("announce", got and _info(got)))
        trace.append(("live", [i.worker_id for i in reg.live_workers()],
                      [i.worker_id for i in reg.live_workers("ondemand")]))
    return reg, clock, store, trace


@pytest.mark.parametrize("seed", range(4))
def test_registry_script_and_persisted_records_match(seed, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1.7e9)

    def script(pkg):
        async def main():
            reg, clock, store, trace = await _registry(pkg, announce_script(seed))
            records = {k: await store.hgetall(k) for k in sorted(await store.keys("*"))
                       if k.startswith("fleet")}
            # a restarted registry over the same store learns the same records
            reborn = mod(pkg, "fleet").WorkerRegistry(store, clock=clock, ttl=10.0)
            loaded = await reborn.load()
            return trace, records, loaded, sorted(_info(i) for i in reborn._workers.values())

        return run(main())

    trace, records, loaded, _ = both(script)
    assert records and loaded


@pytest.mark.parametrize("min_workers,horizon", [(2, 0.0), (1, 0.0), (2, 1.0), (3, 0.05)])
@pytest.mark.parametrize("seed", range(3))
def test_planner_gives_the_same_plan(seed, min_workers, horizon):
    def script(pkg):
        fleet = mod(pkg, "fleet")

        async def main():
            reg, clock, _s, _t = await _registry(pkg, announce_script(seed + 10), ttl=30.0)
            planner = fleet.FleetPlanner(reg, min_workers=min_workers, horizon=horizon)
            plans = []
            for rnd in range(6):
                for diff in DIFFS:
                    for wt in ("ondemand", "precache"):
                        p = planner.plan(diff, wt)
                        shards = [(a.worker_id, a.start, a.length, a.span) for a in p.assignments]
                        plans.append((p.mode, p.racers, shards))
                        if shards and p.mode == fleet.SHARDED:
                            assert sum(s[3] for s in shards) == SPACE
            return plans

        return run(main())

    plans = both(script)
    assert any(p[0] == "sharded" for p in plans) or min_workers > 1


@pytest.mark.parametrize("seed", range(3))
def test_cover_ranges_and_attribution_match(seed):
    def script(pkg):
        fleet = mod(pkg, "fleet")
        rng = np.random.default_rng(seed)

        async def main():
            reg, clock, _s, _t = await _registry(pkg, [
                ("announce", json.dumps({"id": f"w{i}", "hashrate": 1e6 * i}))
                for i in range(1, 5)])
            planner = fleet.FleetPlanner(reg, min_workers=2)
            cover = fleet.CoverageTracker(reg)
            out = []
            hashes = [rng.bytes(32).hex().upper() for _ in range(4)]
            starts = {}
            for h in hashes:
                plan = planner.plan(EASY, "ondemand")
                cover.begin(h, "ondemand", EASY, plan.assignments, clock.time())
                starts[h] = [a.start for a in plan.assignments]
            for step in range(12):
                await clock.advance(float(rng.choice([0.5, 2.0, 6.0])))
                alive_ids = [f"w{i}" for i in range(1, 5) if rng.integers(3)]
                for wid in alive_ids:
                    await reg.handle_announce(json.dumps({"id": wid, "hashrate": 1e6}))
                h = hashes[int(rng.integers(len(hashes)))]
                start = starts[h][int(rng.integers(len(starts[h])))]
                nonce = (start + int(rng.integers(0, 4000))) % SPACE
                out.append(("resolve", cover.resolve(h, nonce, clock.time())))
                out.append(("resolve_far", cover.resolve(h, (start + (1 << 40)) % SPACE,
                                                         clock.time())))
                alive, orphaned = cover.split_by_liveness(h)
                out.append(("split", [(a.worker_id, a.start, a.length) for a in alive],
                            [(a.worker_id, a.start, a.length) for a in orphaned]))
                if orphaned and alive:
                    cover.reassigned(h, orphaned[0], alive[0].worker_id, clock.time())
                    out.append(("owners", sorted(cover.current_owners(h))))
            out.append(("swept", cover.sweep(clock.time(), 30.0), len(cover)))
            return out

        return run(main())

    out = both(script)
    assert any(o[0] == "resolve" and o[1] is not None for o in out)


class Capture:
    def __init__(self):
        self.published = []

    async def publish(self, topic, payload, qos=0):
        self.published.append((topic, payload, qos))


@pytest.mark.parametrize("lane_flush", [False, True])
@pytest.mark.parametrize("codec_v1", [True, False])
def test_coordinator_publishes_the_same_frames(codec_v1, lane_flush):
    def script(pkg):
        fleet = mod(pkg, "fleet")
        mod(pkg, "obs").reset()
        rng = np.random.default_rng(17)

        async def main():
            reg, clock, _s, _t = await _registry(pkg, [
                ("announce", json.dumps({"id": f"w{i}", "hashrate": 1e6 * i,
                                         "codec": i % 2}))
                for i in range(1, 5)])
            cover = fleet.CoverageTracker(reg)
            cap = Capture()
            coord = fleet.FleetCoordinator(reg, fleet.FleetPlanner(reg, min_workers=2),
                                           cover, cap, clock=clock, codec_v1=codec_v1,
                                           lane_flush=lane_flush)
            hashes = [rng.bytes(32).hex().upper() for _ in range(5)]
            modes = []
            for i, h in enumerate(hashes):
                modes.append(await coord.publish_work(h, DIFFS[i % 3], "ondemand",
                                                      trace_id=f"{i:016x}"))
            for _ in range(3):
                await asyncio.sleep(0)
            # w4 dies; republish re-covers its shards
            await clock.advance(11.0)
            for i in (1, 2, 3):
                await reg.handle_announce(json.dumps({"id": f"w{i}", "hashrate": 1e6 * i,
                                                      "codec": i % 2}))
            healed = [await coord.republish(h, EASY, "ondemand", hedged=False,
                                            trace_id="ab" * 8) for h in hashes[:3]]
            healed.append(await coord.republish(hashes[3], EASY, "ondemand", hedged=True))
            await coord.on_winner(hashes[0], f"{12345:016x}")
            snap = mod(pkg, "obs").snapshot()
            fams = {k: v["series"] for k, v in snap.items()
                    if k.startswith(("dpow_fleet_", "dpow_codec_")) and v["series"]}
            return modes, healed, cap.published, fams

        return run(main())

    modes, healed, published, fams = both(script)
    assert "sharded" in modes and published
    lanes = [p for t, p, _q in published if t.count("/") == 2]
    if codec_v1:
        assert any(mod("tpu_dpow", "transport.wire").wire_version(p) == 1 for p in lanes)
    # each package decodes the other's frames (v1 and v0) to the same items
    for _t, payload, _q in published:
        a = mod("tpu_dpow", "transport.wire").decode_work_any(payload)
        b = mod("tpu_dpow_torch", "transport.wire").decode_work_any(payload)
        assert a == b and a


def test_work_topic_and_constants_match():
    for wt in ("ondemand", "precache"):
        for wid in (None, "w1", "gpu-7"):
            assert (mod("tpu_dpow", "fleet").work_topic(wt, wid)
                    == mod("tpu_dpow_torch", "fleet").work_topic(wt, wid))
    for name in ("ANNOUNCE_TOPIC", "MIN_HASHRATE", "SPACE", "BROADCAST", "SHARDED"):
        assert getattr(mod("tpu_dpow", "fleet"), name) == getattr(mod("tpu_dpow_torch", "fleet"), name)
