"""The port's precache layer (precache/: AccountScorer, PrecacheCache,
PrecachePipeline) held against tpu_dpow's, differentially — twins of
tests/test_precache.py.

The same numpy-seeded confirmation stream (frontier advances, re-announces,
unknown accounts, results, stale work, shed flips, lease lapses, batch
flushes) runs through both packages on a FakeClock. The verdicts, the cache
states, the publishes, the store and every ``dpow_precache_*`` series must
be equal.
"""

import asyncio
import importlib
import time

import numpy as np
import pytest

PKGS = ("tpu_dpow", "tpu_dpow_torch")
EASY = 0xF000000000000000


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, timeout=30))


def both(fn, *args):
    out = {pkg: fn(pkg, *args) for pkg in PKGS}
    assert out["tpu_dpow"] == out["tpu_dpow_torch"]
    return out["tpu_dpow"]


def h(i: int) -> str:
    return f"{i:064X}"


class StubFleet:
    def __init__(self):
        self.published = []
        self.forgotten = []

    async def publish_work(self, block_hash, difficulty, work_type, trace_id=None):
        self.published.append((block_hash, difficulty, work_type, trace_id))

    def forget(self, block_hash):
        self.forgotten.append(block_hash)


class StubTracer:
    def begin(self, key=None, stage="accept"):
        return f"trace-{key}"

    def mark(self, trace_id, stage):
        pass


def make_pipeline(pkg, store, clock, *, window, fraction, lease, capacity, watermark,
                  min_score, debug, retired, **pipe_kw):
    pre = mod(pkg, "precache")
    admission = mod(pkg, "sched").AdmissionController(
        store, clock=clock, window=window, precache_lease=lease,
        precache_window_fraction=fraction)
    scorer = pre.AccountScorer(store, clock=clock, half_life=60.0)
    cache = pre.PrecacheCache(capacity=capacity, watermark=watermark,
                              min_score=min_score, clock=clock)
    fleet = StubFleet()
    pipe = pre.PrecachePipeline(store, admission, fleet, StubTracer(), scorer, cache,
                                base_difficulty=EASY, debug=debug, clock=clock,
                                retire_cb=retired.append, **pipe_kw)
    return pipe, admission, cache, fleet


async def _dump(store) -> dict:
    out = {}
    for k in sorted(await store.keys("*")):
        for read in (store.get, store.hgetall, store.smembers):
            try:
                v = await read(k)
                out[k] = sorted(v) if isinstance(v, set) else v
                break
            except TypeError:
                continue
    return out


CONFIGS = {
    "roomy": dict(window=8, fraction=1.0, lease=30.0, capacity=8, watermark=1.0,
                  min_score=0.0, debug=False),
    "tight": dict(window=2, fraction=0.5, lease=5.0, capacity=3, watermark=0.67,
                  min_score=0.0, debug=False),
    "floor": dict(window=6, fraction=1.0, lease=10.0, capacity=4, watermark=0.5,
                  min_score=1.5, debug=False),
    "debug_batched": dict(window=4, fraction=1.0, lease=10.0, capacity=5, watermark=1.0,
                          min_score=0.0, debug=True, batch_interval=10.0, batch_size=3),
}


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_confirmation_stream_gives_the_same_verdicts_and_cache(config, seed, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1.7e9)

    def script(pkg):
        rng = np.random.default_rng(seed)
        mod(pkg, "obs").reset()
        cache_mod = mod(pkg, "precache.cache")

        async def main():
            clock = mod(pkg, "resilience").FakeClock()
            store = mod(pkg, "store").MemoryStore(clock=clock.time)
            retired = []
            pipe, admission, cache, fleet = make_pipeline(pkg, store, clock, retired=retired,
                                                          **CONFIGS[config])
            frontier = {}
            for a in range(6):
                if a < 4:  # two accounts stay unknown to the hub
                    frontier[a] = 1000 * a
                    await store.set(f"account:a{a}", h(1000 * a))
            out = []
            for step in range(70):
                r = int(rng.integers(12))
                a = int(rng.integers(6))
                if r <= 5:
                    prev = frontier.get(a, 1000 * a)
                    nxt = prev + 1
                    verdict = await pipe.on_confirmation(h(nxt), f"a{a}", h(prev))
                    if verdict == "dispatch":
                        frontier[a] = nxt
                    out.append(("confirm", a, verdict))
                elif r == 6 and a in frontier:
                    out.append(("reannounce", await pipe.on_confirmation(
                        h(frontier[a]), f"a{a}", h(frontier[a] - 1))))
                elif r == 7 and a in frontier:
                    pipe.on_result(h(frontier[a]), ["precache", "ondemand"][int(rng.integers(2))])
                    out.append(("result", a))
                elif r == 8 and a in frontier:
                    pipe.on_stale(h(frontier[a]))
                    out.append(("stale", a))
                elif r == 9:
                    admission.shed_precache = not admission.shed_precache
                    out.append(("shed", admission.shed_precache))
                elif r == 10:
                    dt = float(rng.choice([1.0, 6.0, 31.0]))
                    await clock.advance(dt)
                    admission.poll()
                    out.append(("reap", dt, pipe.reap_lapsed()))
                else:
                    out.append(("flush", await pipe.flush()))
                    pipe.note_request(["precache", "ondemand"][int(rng.integers(2))])
                out.append(sorted((e.block_hash, e.account, e.state, round(e.score, 9))
                                  for e in cache.entries()))
            out.append(("flush", await pipe.flush()))
            out.append(("hit_ratio", cache.hit_ratio()))
            out.append(("published", fleet.published, sorted(fleet.forgotten), retired))
            out.append(("store", await _dump(store)))
            out.append(("counts", {v: pipe.count(v) for v in (
                "dispatch", "duplicate", "unknown_account", "shed", "window_full",
                "score_floor", "watermark")}))
            snap = mod(pkg, "obs").snapshot()
            out.append({k: v["series"] for k, v in sorted(snap.items())
                        if k.startswith(("dpow_precache_", "dpow_sched_")) and v["series"]})
            assert cache_mod.READY and cache_mod.PENDING
            return out

        return run(main())

    out = both(script)
    verdicts = {o[2] for o in out if isinstance(o, tuple) and o[0] == "confirm"}
    assert "dispatch" in verdicts


@pytest.mark.parametrize("writer,reader", [PKGS, PKGS[::-1]])
def test_scorer_state_carries_across_packages(writer, reader, monkeypatch):
    """Scores persisted by one hub's scorer rehydrate the other's hot head."""
    monkeypatch.setattr(time, "time", lambda: 1.7e9)

    async def main():
        store = mod(writer, "store").MemoryStore()
        clock = mod(writer, "resilience").FakeClock()
        s = mod(writer, "precache").AccountScorer(store, clock=clock, half_life=100.0,
                                                  persist_floor=0.5, persist_interval=0.0)
        rng = np.random.default_rng(4)
        for _ in range(40):
            await s.observe(f"acct{int(rng.integers(8))}")
        want = {f"acct{i}": round(s.score(f"acct{i}"), 9) for i in range(8)}
        blob = store.snapshot()
        other = mod(reader, "store").MemoryStore()
        other.restore(blob)
        r = mod(reader, "precache").AccountScorer(
            other, clock=mod(reader, "resilience").FakeClock(), half_life=100.0,
            persist_floor=0.5, persist_interval=0.0)
        loaded = await r.load()
        got = {f"acct{i}": round(r.score(f"acct{i}"), 9) for i in range(8)}
        return loaded, want, got

    loaded, want, got = run(main())
    assert loaded > 0
    assert {k: v for k, v in got.items() if v} == {k: v for k, v in want.items() if got[k]}
