"""The port's admission layer (sched/: QuotaLedger, FairQueue,
DispatchWindow, AdmissionController) held against tpu_dpow's,
differentially — twins of tests/test_sched.py, tests/test_quota_contract.py
and tests/test_sched_overload.py.

The same numpy-seeded script runs through both packages on a FakeClock and
every decision (grant, queue, shed, reject, Retry-After), every window
event and every ``dpow_sched_*`` series must be equal. The overload twin
drives both hubs' HTTP faces with one burst and compares the 429s.
"""

import asyncio
import importlib
import json

import aiohttp
import numpy as np
import pytest

from fake_redis import FakeRedis

PKGS = ("tpu_dpow", "tpu_dpow_torch")
EASY = 0xF000000000000000


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, timeout=60))


def both(fn, *args):
    out = {pkg: fn(pkg, *args) for pkg in PKGS}
    assert out["tpu_dpow"] == out["tpu_dpow_torch"]
    return out["tpu_dpow"]


def sched_series(pkg) -> dict:
    snap = mod(pkg, "obs").snapshot()
    return {k: v["series"] for k, v in sorted(snap.items())
            if k.startswith("dpow_sched_") and v["series"]}


# -- FairQueue ---------------------------------------------------------------


def _ticket(pkg, rng, i):
    return mod(pkg, "sched").Ticket(
        f"h{i}", ["a", "b", "c", "node"][int(rng.integers(4))],
        work_class=["ondemand", "ondemand", "precache"][int(rng.integers(3))],
        difficulty=int(rng.integers(0, 4)), deadline=float(rng.integers(1, 60)),
        over_quota=bool(rng.integers(0, 4) == 0))


@pytest.mark.parametrize("seed", range(4))
def test_fair_queue_script_matches(seed):
    def script(pkg):
        rng = np.random.default_rng(seed)
        q = mod(pkg, "sched").FairQueue()
        out = []
        for i in range(80):
            op = int(rng.integers(6))
            if op <= 2:
                q.push(_ticket(pkg, rng, i))
                out.append(("push", len(q)))
            elif op == 3:
                tk = q.pop_best()
                out.append(("pop", tk and tk.key))
            elif op == 4:
                tk = q.shed_victim()
                out.append(("shed", tk and tk.key))
            else:
                gone = q.expired(now=float(rng.integers(0, 40)))
                out.append(("expired", [tk.key for tk in gone]))
        return out

    out = both(script)
    assert {o[0] for o in out} == {"push", "pop", "shed", "expired"}


# -- QuotaLedger on every store ----------------------------------------------


def _store(pkg, kind, tmp_path, clock):
    if kind == "memory":
        return mod(pkg, "store").MemoryStore()
    if kind == "sqlite":
        return mod(pkg, "store.sqlite_store").SqliteStore(str(tmp_path / f"{pkg}-q.db"))
    if kind == "redis":
        return mod(pkg, "store.redis_store").RedisStore("redis://q", client=FakeRedis())
    return mod(pkg, "store").DegradedStore(mod(pkg, "store").MemoryStore(), clock=clock)


@pytest.mark.parametrize("rate,burst", [(2.0, 4.0), (0.5, 2.0), (0.0, 1.0)])
@pytest.mark.parametrize("kind", ["memory", "sqlite", "redis", "degraded"])
def test_quota_admit_deny_sequence_matches(kind, rate, burst, tmp_path):
    def script(pkg):
        rng = np.random.default_rng(int(rate * 10 + burst))

        async def main():
            clock = mod(pkg, "resilience").FakeClock()
            store = _store(pkg, kind, tmp_path, clock)
            await store.setup()
            ledger = mod(pkg, "sched").QuotaLedger(store, rate=rate, burst=burst, clock=clock)
            out = []
            for _ in range(40):
                if rng.integers(3) == 0:
                    dt = float(rng.choice([0.25, 0.5, 1.0, 3.0]))
                    await clock.advance(dt)
                    out.append(("advance", dt))
                svc = ["a", "b"][int(rng.integers(2))]
                v = await ledger.consume(svc)
                out.append((svc, v.allowed, round(v.retry_after, 9)))
            out.append(("peek", round(await ledger.peek("a"), 9)))
            out.append(("keys", sorted(await store.keys("*"))))
            await store.close()
            return out

        return run(main())

    out = both(script)
    if rate:
        assert any(not o[1] for o in out if o[0] in ("a", "b")), "no denial in the script"


@pytest.mark.parametrize("writer,reader", [PKGS, PKGS[::-1]])
def test_quota_bucket_carries_across_packages(writer, reader, tmp_path):
    """A bucket drained under one hub stays drained under the other over
    the same durable store: no free burst after switching."""

    async def main():
        clock = mod(writer, "resilience").FakeClock(start=50.0)
        s = mod(writer, "store").get_store(f"sqlite://{tmp_path}/q.db")
        await s.setup()
        ledger = mod(writer, "sched").QuotaLedger(s, rate=1.0, burst=3.0, clock=clock)
        for _ in range(3):
            assert (await ledger.consume("svc")).allowed
        await s.close()
        s2 = mod(reader, "store").get_store(f"sqlite://{tmp_path}/q.db")
        await s2.setup()
        clock2 = mod(reader, "resilience").FakeClock(start=50.0)
        reborn = mod(reader, "sched").QuotaLedger(s2, rate=1.0, burst=3.0, clock=clock2)
        denied = await reborn.consume("svc")
        await clock2.advance(1.0)
        allowed = await reborn.consume("svc")
        await s2.close()
        return denied.allowed, denied.retry_after, allowed.allowed

    assert run(main()) == (False, 1.0, True)


# -- DispatchWindow ----------------------------------------------------------


@pytest.mark.parametrize("capacity,queue_limit", [(2, 2), (1, 4), (3, 1), (0, 0)])
@pytest.mark.parametrize("seed", [7, 8])
def test_dispatch_window_script_matches(capacity, queue_limit, seed):
    def script(pkg):
        rng = np.random.default_rng(seed)
        sched = mod(pkg, "sched")

        async def main():
            clock = mod(pkg, "resilience").FakeClock()
            events = []
            w = sched.DispatchWindow(capacity=capacity, queue_limit=queue_limit,
                                     clock=clock, lease=30.0, retry_after=3.0,
                                     on_event=lambda e, tk: events.append((e, tk.key)))
            tasks = {}
            out = []
            for i in range(60):
                op = int(rng.integers(6))
                if op <= 1:
                    tk = _ticket(pkg, rng, i)
                    tk.work_class = "ondemand"
                    tasks[tk.key] = asyncio.ensure_future(w.acquire(tk))
                elif op == 2:
                    tk = _ticket(pkg, rng, i)
                    tk.work_class = "precache"
                    out.append(("try", tk.key, w.try_acquire(tk)))
                elif op == 3 and w._inflight:
                    victim = min(w._inflight, key=lambda t: t.key)
                    w.release(victim)
                    out.append(("release", victim.key))
                elif op == 4:
                    pending = sorted(k for k, t in tasks.items() if not t.done())
                    if pending:
                        tasks[pending[0]].cancel()
                        out.append(("cancel", pending[0]))
                else:
                    now = float(rng.integers(0, 80))
                    w.expire(now)
                    out.append(("expire", now))
                for _ in range(3):
                    await asyncio.sleep(0)
                out.append(("state", w.inflight, w.queued))
            for t in tasks.values():
                if not t.done():
                    t.cancel()
            await asyncio.gather(*tasks.values(), return_exceptions=True)
            fates = {}
            for k, t in sorted(tasks.items()):
                if t.cancelled():
                    fates[k] = "cancelled"
                elif t.exception() is not None:
                    e = t.exception()
                    fates[k] = (type(e).__name__, e.retry_after, e.reason)
                else:
                    fates[k] = "granted"
            return out, events, fates

        return run(main())

    out, events, fates = both(script)
    assert events


# -- AdmissionController -----------------------------------------------------


@pytest.mark.parametrize("window,queue_limit,hard", [(2, 1, False), (3, 2, True), (0, 0, True)])
def test_admission_script_decisions_and_metrics_match(window, queue_limit, hard):
    def script(pkg):
        rng = np.random.default_rng(window * 10 + queue_limit)
        sched = mod(pkg, "sched")
        mod(pkg, "obs").reset()

        async def main():
            clock = mod(pkg, "resilience").FakeClock()
            ctl = sched.AdmissionController(
                mod(pkg, "store").MemoryStore(), clock=clock, window=window,
                queue_limit=queue_limit, busy_retry_after=2.0, quota_rate=1.0,
                quota_burst=3.0, quota_hard=hard, precache_lease=10.0)
            poll = asyncio.ensure_future(ctl.run(interval=1.0))
            held, tasks, out = [], {}, []
            for i in range(50):
                op = int(rng.integers(7))
                svc = ["a", "b", "c"][int(rng.integers(3))]
                if op <= 1:
                    try:
                        oq = await ctl.consume_quota(svc)
                    except sched.Busy as e:
                        out.append(("quota", svc, "busy", e.retry_after))
                        continue
                    tasks[f"h{i}"] = asyncio.ensure_future(ctl.acquire_dispatch(
                        f"h{i}", svc, difficulty=int(rng.integers(3)),
                        deadline=float(rng.integers(5, 100)), over_quota=oq))
                    out.append(("quota", svc, oq))
                elif op == 2:
                    lease = ctl.try_acquire_precache(f"p{int(rng.integers(6))}")
                    out.append(("precache", lease is not None))
                elif op == 3:
                    done = sorted(k for k, t in tasks.items() if t.done()
                                  and not t.cancelled() and t.exception() is None)
                    done = [k for k in done if k not in held]
                    if done:
                        ctl.release(tasks[done[0]].result())
                        held.append(done[0])
                        out.append(("release", done[0]))
                elif op == 4:
                    key = f"p{int(rng.integers(6))}"
                    ctl.release_key(key)
                    out.append(("release_key", key))
                else:
                    dt = float(rng.choice([0.5, 2.0, 11.0]))
                    await clock.advance(dt)
                    out.append(("advance", dt))
                for _ in range(3):
                    await asyncio.sleep(0)
                out.append(("window", ctl.window.inflight, ctl.window.queued))
            poll.cancel()
            for t in tasks.values():
                t.cancel()
            res = await asyncio.gather(*tasks.values(), return_exceptions=True)
            fates = [type(r).__name__ for r in res]
            return out, fates, sched_series(pkg)

        return run(main())

    out, fates, series = both(script)
    assert "dpow_sched_admitted_total" in series


# -- the overload burst over HTTP --------------------------------------------


async def _overload_hub(pkg):
    """No worker; a window of 2 with a queue of 1: a burst of 6 POSTs must
    split 3 admitted (they time out) and 3 refused with 429 + Retry-After."""
    mod(pkg, "obs").reset()
    server_mod = mod(pkg, "server")
    config = server_mod.ServerConfig(
        base_difficulty=EASY, throttle=100000.0, heartbeat_interval=3600.0,
        statistics_interval=3600.0, service_port=0, service_ws_port=0,
        upcheck_port=0, block_cb_port=0, max_inflight_dispatches=2,
        admission_queue_limit=1, busy_retry_after=4.0, enable_precache=False)
    store = mod(pkg, "store").MemoryStore()
    transport = mod(pkg, "transport.inproc").InProcTransport(
        mod(pkg, "transport.broker").Broker(), client_id="server")
    server = server_mod.DpowServer(config, store, transport)
    runner = mod(pkg, "server.api").ServerRunner(server, config)
    await runner.start()
    await store.hset("service:svc", {"api_key": server_mod.hash_key("secret"),
                                     "public": "N", "display": "svc", "website": "",
                                     "precache": "0", "ondemand": "0"})
    await store.sadd("services", "svc")
    rng = np.random.default_rng(3)
    hashes = [rng.bytes(32).hex().upper() for _ in range(6)]
    url = f"http://127.0.0.1:{runner.ports['service']}/service/"
    try:
        async with aiohttp.ClientSession() as http:
            async def post(i, h):
                # staggered so that the arrival order is the script's order
                await asyncio.sleep(0.05 * i)
                async with http.post(url, json={"user": "svc", "api_key": "secret",
                                                "hash": h, "timeout": 1}) as r:
                    return r.status, r.headers.get("Retry-After"), await r.json()

            res = await asyncio.gather(*(post(i, h) for i, h in enumerate(hashes)))
            async with http.get(f"http://127.0.0.1:{runner.ports['upcheck']}/metrics") as r:
                page = await r.text()
    finally:
        await runner.stop()
    fams = mod(pkg, "obs").parse_text(page)
    totals = {name: sum(v for _l, v in fams.get(name, []))
              for name in ("dpow_sched_admitted_total", "dpow_sched_rejected_total",
                           "dpow_sched_shed_total")}
    return [(s, ra, json.dumps(b, sort_keys=True)) for s, ra, b in res], totals


def test_overload_burst_refuses_alike_over_http():
    res, totals = both(lambda pkg: run(_overload_hub(pkg)))
    assert sorted(s for s, _ra, _b in res) == [200, 200, 200, 429, 429, 429]
    assert all(ra == "4" for s, ra, _b in res if s == 429)
    assert totals["dpow_sched_admitted_total"] == 3
    assert totals["dpow_sched_rejected_total"] == 3
