"""The port's hub (server/: DpowServer, ServerRunner) held against
tpu_dpow's, differentially — twins of tests/test_server.py and
tests/test_server_api.py.

Each scenario runs once through each package on the same script: a
FakeClock, a MemoryStore on that clock, an in-process broker, and a
scripted worker that answers with the first valid nonce (computed by
hashlib, so both runs receive the same work). The two runs must give:

  * identical published (topic, payload, qos) sequences, byte for byte —
    trace ids are drawn from one deterministic counter per run;
  * identical service responses and errors;
  * identical ``MemoryStore.snapshot()`` strings;
  * identical metric series, apart from ``dpow_server_request_seconds``
    and ``dpow_trace_stage_seconds``, which are timed on the wall clock.

Where a scenario needs a timeout it is a real second (the hub's waits use
``asyncio.wait_for``), as in the reference tests.
"""

import asyncio
import hashlib
import importlib
import itertools
import json
import struct
import time

import aiohttp
import numpy as np
import pytest

PKGS = ("tpu_dpow", "tpu_dpow_torch")
EASY = 0xF000000000000000
#: Families timed on the wall clock: excluded from the series comparison.
WALL_TIMED = ("dpow_server_request_seconds", "dpow_trace_stage_seconds")


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def run(coro, timeout=30):
    return asyncio.run(asyncio.wait_for(coro, timeout=timeout))


def solve(block_hash: str, difficulty: int, start: int = 0, below: int = None) -> str:
    h = bytes.fromhex(block_hash)
    w = start
    while True:
        v = int.from_bytes(hashlib.blake2b(struct.pack("<Q", w) + h, digest_size=8).digest(),
                           "little")
        if v >= difficulty and (below is None or v < below):
            return f"{w:016x}"
        w += 1


def hashes(seed: int, n: int = 8) -> list:
    rng = np.random.default_rng(seed)
    return [rng.bytes(32).hex().upper() for _ in range(n)]


ACCOUNT = mod("tpu_dpow_torch", "utils.nanocrypto").encode_account(bytes(range(32)))
ACCOUNT2 = mod("tpu_dpow_torch", "utils.nanocrypto").encode_account(bytes(range(1, 33)))


async def settle(rounds: int = 60):
    for _ in range(rounds):
        await asyncio.sleep(0)


class Twin:
    """One package's hub on the scripted seams, recording what it publishes."""

    def __init__(self, pkg: str, **overrides):
        self.pkg = pkg
        self.nc = mod(pkg, "utils.nanocrypto")
        self.clock = mod(pkg, "resilience").FakeClock()
        server = mod(pkg, "server")
        settings = dict(base_difficulty=EASY, throttle=1000.0, heartbeat_interval=1.0,
                        statistics_interval=3600.0)
        settings.update(overrides)
        self.config = server.ServerConfig(**settings)
        self.broker = mod(pkg, "transport.broker").Broker()
        self.store = mod(pkg, "store").MemoryStore(clock=self.clock.time)
        self.transport = mod(pkg, "transport.inproc").InProcTransport(
            self.broker, client_id="server")
        self.published = []
        real = self.transport.publish

        async def recording_publish(topic, payload, qos=0):
            self.published.append((topic, payload, qos))
            return await real(topic, payload, qos=qos)

        self.transport.publish = recording_publish
        self.server = server.DpowServer(self.config, self.store, self.transport,
                                        clock=self.clock)
        self.behaviour = {}  # hash -> "silent" | "invalid"
        self.worker_task = None
        self.worker = None

    async def __aenter__(self):
        await self.server.setup()
        self.server.start_loops()
        await self.register("svc", "secret")
        return self

    async def __aexit__(self, *exc):
        if self.worker_task:
            self.worker_task.cancel()
            await asyncio.gather(self.worker_task, return_exceptions=True)
        await self.server.close()

    async def register(self, user, key, public="N"):
        await self.store.hset(f"service:{user}", {
            "api_key": mod(self.pkg, "server").hash_key(key), "public": public,
            "display": user, "website": "", "precache": "0", "ondemand": "0"})
        await self.store.sadd("services", user)

    def request(self, h, **kw):
        return {"user": "svc", "api_key": "secret", "hash": h, **kw}

    async def call(self, data):
        try:
            return await self.server.service_handler(data)
        except Exception as e:  # the outcome IS the error, on both sides
            return (type(e).__name__, str(e))

    async def start_worker(self, account=ACCOUNT):
        t = mod(self.pkg, "transport.inproc").InProcTransport(self.broker, client_id="worker")
        await t.connect()
        await t.subscribe("work/#")
        await t.subscribe("cancel/#", qos=1)
        wire = mod(self.pkg, "transport.wire")

        async def loop():
            async for msg in t.messages():
                if not msg.topic.startswith("work/"):
                    continue
                for bh, diff, _tid, _rng in wire.decode_work_any(msg.payload):
                    diff = int(diff, 16) if isinstance(diff, str) else diff
                    how = self.behaviour.get(bh)
                    if how == "silent":
                        continue
                    wt = msg.topic.split("/")[1]
                    if how == "invalid":
                        await t.publish(f"result/{wt}", f"{bh},0000000000000000,{account}")
                    await t.publish(f"result/{wt}", f"{bh},{solve(bh, diff)},{account}")

        self.worker = t
        self.worker_task = asyncio.ensure_future(loop())


def fresh_obs(pkg) -> None:
    """Clear the package's metrics and its resource ledger, which
    ``dpow_resource_outstanding`` mirrors and earlier tests may have left
    holding entries."""
    mod(pkg, "obs").LEDGER.reset()
    mod(pkg, "obs").reset()


def _series(pkg) -> dict:
    # Families other tests in this process registered stay registered with
    # no series after obs.reset(): only what the scenario wrote is compared.
    snap = mod(pkg, "obs").snapshot()
    return {k: v["series"] for k, v in sorted(snap.items())
            if k not in WALL_TIMED and v["series"]}


def twin_run(scenario, monkeypatch, **overrides):
    """Run ``scenario(twin)`` under each package; return both records."""
    monkeypatch.setattr(time, "time", lambda: 1.7e9)
    out = {}
    for pkg in PKGS:
        counter = itertools.count(1)
        monkeypatch.setattr(mod(pkg, "obs.trace"), "new_trace_id",
                            lambda: f"{next(counter):016x}")
        fresh_obs(pkg)

        async def main():
            async with Twin(pkg, **overrides) as tw:
                outcome = await scenario(tw)
                await settle()
                return tw, outcome, tw.store.snapshot()

        tw, outcome, snapshot = run(main())
        out[pkg] = {"outcome": outcome, "published": tw.published, "snapshot": snapshot,
                    "series": _series(pkg)}
    a, b = out["tpu_dpow"], out["tpu_dpow_torch"]
    for key in ("outcome", "published", "snapshot", "series"):
        assert a[key] == b[key], key
    return a


# -- scenarios (each a twin of tests/test_server.py tests) -------------------


async def s_ondemand_reward_and_cache(tw):
    h = hashes(1)
    await tw.start_worker()
    out = [await tw.call(tw.request(h[0], account=ACCOUNT))]
    out.append(await tw.call(tw.request(h[0])))  # a store hit: no second dispatch
    out.append(await tw.call(tw.request(h[1], multiplier=4.0)))
    out.append(await tw.call(tw.request(h[2], difficulty="fff8000000000000")))
    await settle()
    out.append(await tw.store.hget(f"client:{ACCOUNT}", "ondemand"))
    out.append(await tw.server.all_statistics())
    return out


async def s_validation_errors(tw):
    h = hashes(2)
    bad = [{"user": "svc"}, {"user": "svc", "api_key": "wrong", "hash": h[0]},
           {"user": "ghost", "api_key": "secret", "hash": h[0]}, tw.request("zz"),
           tw.request(h[0], account="nano_invalid"), tw.request(h[0], multiplier=100.0),
           tw.request(h[0], multiplier=0.001), tw.request(h[0], timeout="never"),
           tw.request(h[0], timeout=-3), tw.request(h[0], difficulty="zz"),
           tw.request(h[0], difficulty="ffffffffffffffff")]
    return [await tw.call(d) for d in bad]


async def s_winner_election_and_bad_results(tw):
    h = hashes(3)
    task = asyncio.ensure_future(tw.server.service_handler(tw.request(h[0], timeout=5)))
    await settle()
    w1 = solve(h[0], EASY)
    w2 = solve(h[0], EASY, start=int(w1, 16) + 1)
    await tw.server.client_result_handler("result/ondemand", f"{h[0]},0000000000000000,{ACCOUNT}")
    await tw.server.client_result_handler("result/ondemand", f"{h[0]},{w1},{ACCOUNT}")
    await tw.server.client_result_handler("result/ondemand", f"{h[0]},{w2},{ACCOUNT2}")
    out = [await task]
    # a result for an unknown hash, garbage payloads, an invalid payout
    await tw.server.client_result_handler("result/ondemand", f"{h[1]},{solve(h[1], EASY)},{ACCOUNT}")
    for junk in ("garbage", "a,b", f"{h[1]},zz,{ACCOUNT}", ""):
        await tw.server.client_result_handler("result/ondemand", junk)
    task = asyncio.ensure_future(tw.server.service_handler(tw.request(h[2], timeout=5)))
    await settle()
    await tw.server.client_result_handler("result/ondemand", f"{h[2]},{solve(h[2], EASY)},nano_bad")
    await settle()
    await tw.server.client_result_handler("result/ondemand", f"{h[2]},{solve(h[2], EASY)},{ACCOUNT}")
    out.append(await task)
    await settle()
    for acct in (ACCOUNT, ACCOUNT2):
        out.append(await tw.store.hgetall(f"client:{acct}"))
    return out


async def s_precache_and_hit(tw):
    h = hashes(4)
    await tw.start_worker()
    out = [await tw.call(tw.request(h[0], account=ACCOUNT))]
    await tw.server.block_arrival_handler(h[1], ACCOUNT, h[0])
    await settle(120)
    out.append(await tw.store.get(f"block:{h[1]}"))
    out.append(await tw.call(tw.request(h[1])))  # a precache hit
    await tw.server.block_arrival_handler(h[1], ACCOUNT, None)  # duplicate
    await tw.server.block_arrival_handler(h[2], ACCOUNT2, None)  # unknown account
    await tw.server.block_arrival_ws_handler({
        "message": {"hash": h[3], "account": ACCOUNT,
                    "block": {"previous": h[1], "subtype": "send"}}})
    await settle(120)
    out.append(await tw.call(tw.request(h[3])))
    out.append(await tw.server.all_statistics())
    return out


async def s_stale_and_weak_precache(tw):
    h = hashes(5)
    await tw.start_worker()
    nc = tw.nc
    target = nc.derive_work_difficulty(32.0, EASY)
    w = solve(h[0], EASY, below=target)
    await tw.store.set(f"block:{h[0]}", w)
    await tw.store.setnx(f"block-lock:{h[0]}", "1", expire=5)
    out = [await tw.call(tw.request(h[0], multiplier=32.0))]  # forced on-demand
    w1 = solve(h[1], EASY)
    await tw.store.set(f"block:{h[1]}", w1)
    mult = nc.derive_work_multiplier(nc.work_value(h[1], w1), EASY) * 1.1
    out.append(await tw.call(tw.request(h[1], multiplier=mult)))  # weak but usable
    return out


async def s_republish_raise_and_coalesce(tw):
    h = hashes(6)
    await tw.start_worker()
    tw.behaviour[h[0]] = "silent"
    base = asyncio.ensure_future(tw.server.service_handler(tw.request(h[0], timeout=20)))
    await settle()
    raised = asyncio.ensure_future(tw.server.service_handler(
        tw.request(h[0], multiplier=4.0, timeout=20)))
    await settle()
    for _ in range(3):  # the supervisor re-publishes (and hedges) on the clock
        await tw.clock.advance(2.0)
        await settle()
    tw.behaviour[h[0]] = "invalid"  # an invalid result first, then a valid one
    await tw.clock.advance(2.0)
    out = list(await asyncio.gather(base, raised))
    # a same-hash burst coalesces onto one dispatch
    burst = await asyncio.gather(*(tw.server.service_handler(tw.request(h[1], timeout=10))
                                   for _ in range(3)))
    out.append(burst)
    return out


async def s_timeout_and_cancel(tw):
    h = hashes(7)
    out = [await tw.call(tw.request(h[0], timeout=1))]
    patient = asyncio.ensure_future(tw.server.service_handler(tw.request(h[1], timeout=10)))
    await settle()
    out.append(await tw.call(tw.request(h[1], timeout=1)))  # short waiter times out
    await tw.server.client_result_handler("result/ondemand", f"{h[1]},{solve(h[1], EASY)},{ACCOUNT}")
    out.append(await patient)
    return out


async def s_heartbeat_statistics_and_control(tw):
    await tw.register("pub1", "k", public="Y")
    await tw.store.hset("service:pub1", {"display": "Public One", "website": "one.example",
                                         "precache": "5", "ondemand": "7"})
    await tw.store.set("stats:precache", "100")
    for _ in range(3):
        await tw.clock.advance(1.0)
        await settle()
    out = [await tw.server.all_statistics(), tw.server.control_state()]
    out.append(tw.server.apply_control({"drain": True, "precache_shed": True}))
    out.append(await tw.call(tw.request(hashes(8)[0])))  # draining: Busy
    out.append(tw.server.apply_control({"drain": False}))
    out.append(tw.server.control_state())
    return out


SCENARIOS = {
    "ondemand_reward_and_cache": (s_ondemand_reward_and_cache, {}),
    "validation_errors": (s_validation_errors, {}),
    "winner_election_and_bad_results": (s_winner_election_and_bad_results, {}),
    "precache_and_hit": (s_precache_and_hit, {}),
    "stale_and_weak_precache": (s_stale_and_weak_precache, {"max_multiplier": 64.0}),
    "republish_raise_and_coalesce": (s_republish_raise_and_coalesce, {}),
    "timeout_and_cancel": (s_timeout_and_cancel, {}),
    "heartbeat_statistics_and_control": (s_heartbeat_statistics_and_control, {}),
    "debug_precache_bounded_window": (s_precache_and_hit, {"debug": True,
                                                           "max_inflight_dispatches": 2,
                                                           "admission_queue_limit": 2}),
    "ondemand_fleet_off_codec_v0": (s_ondemand_reward_and_cache, {"fleet": False,
                                                                  "codec": "v0"}),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_hub_script_is_identical_across_packages(name, monkeypatch):
    scenario, overrides = SCENARIOS[name]
    rec = twin_run(scenario, monkeypatch, **overrides)
    assert rec["outcome"] and rec["published"]


def test_twin_scenarios_exercise_what_they_claim(monkeypatch):
    """Guards the differential tests against comparing two empty runs."""
    rec = twin_run(s_republish_raise_and_coalesce, monkeypatch)
    topics = [t for t, _p, _q in rec["published"]]
    assert topics.count("work/ondemand") >= 3 and "cancel/ondemand" in topics
    # the raised request attaches to the in-flight base dispatch, and two of
    # the burst's three attach to the first one's
    assert rec["series"]["dpow_coalesce_total"] == {"attached": 3.0}
    base, raised, burst = rec["outcome"]
    assert base == raised and len({r["work"] for r in burst}) == 1
    rec = twin_run(s_precache_and_hit, monkeypatch)
    assert rec["series"]["dpow_precache_requests_total"].get("hit", 0) >= 1
    rec = twin_run(s_timeout_and_cancel, monkeypatch)
    assert rec["outcome"][0][0] == "RequestTimeout"


def test_checkpoint_roundtrip_matches(tmp_path, monkeypatch):
    async def scenario(tw):
        await tw.start_worker()
        out = [await tw.call(tw.request(h, account=ACCOUNT)) for h in hashes(9, 3)]
        await tw.server.close()  # writes the checkpoint
        return out

    blobs = {}
    for pkg in PKGS:
        path = tmp_path / f"{pkg}.json"
        monkeypatch.setattr(time, "time", lambda: 1.7e9)
        counter = itertools.count(1)
        monkeypatch.setattr(mod(pkg, "obs.trace"), "new_trace_id",
                            lambda: f"{next(counter):016x}")

        async def main():
            tw = Twin(pkg, checkpoint_path=str(path))
            await tw.__aenter__()
            await scenario(tw)
            if tw.worker_task:
                tw.worker_task.cancel()
            reborn = Twin(pkg, checkpoint_path=str(path))
            await reborn.server.setup()
            got = await reborn.store.get(f"block:{hashes(9, 3)[0]}")
            await reborn.server.close()
            return got

        blobs[pkg] = (run(main()), path.read_text())
    assert blobs["tpu_dpow"] == blobs["tpu_dpow_torch"]
    assert blobs["tpu_dpow"][0]


# -- the HTTP and WebSocket faces --------------------------------------------


async def _api_script(pkg) -> list:
    tw = Twin(pkg, service_port=0, service_ws_port=0, upcheck_port=0, block_cb_port=0,
              heartbeat_interval=3600.0)
    runner = mod(pkg, "server.api").ServerRunner(tw.server, tw.config)
    await runner.start()
    await tw.register("svc", "secret")
    await tw.start_worker()
    h = hashes(10)
    url = lambda app, path: f"http://127.0.0.1:{runner.ports[app]}{path}"  # noqa: E731
    out = []
    try:
        async with aiohttp.ClientSession() as http:
            async def post(app, path, **kw):
                async with http.post(url(app, path), **kw) as r:
                    return r.status, r.headers.get("Content-Type"), await r.text()

            out.append(await post("service", "/service/", data=b"test"))
            out.append(await post("service", "/service/", json={
                "user": "svc", "api_key": "bad", "hash": h[0]}))
            out.append(await post("service", "/service/", json=tw.request(h[0], id=7)))
            out.append(await post("service", "/service/", json=tw.request(h[0])))
            async with http.ws_connect(url("service_ws", "/service_ws/")) as ws:
                await ws.send_json(tw.request(h[1], id="w1"))
                out.append(json.loads((await ws.receive()).data))
                await ws.send_str("not json")
                out.append(json.loads((await ws.receive()).data))
            for path in ("/upcheck/", "/upcheck/blocks/", "/upcheck/broker/"):
                async with http.get(url("upcheck", path)) as r:
                    out.append((path, r.status, await r.text()))
            out.append(await post("blocks", "/block/", json={
                "hash": h[2], "account": ACCOUNT, "block": {"previous": h[0]}}))
            async with http.get(url("upcheck", "/control/")) as r:
                out.append((r.status, await r.json()))
            out.append(await post("upcheck", "/control/", json={"precache_shed": True}))
            async with http.get(url("upcheck", "/metrics")) as r:
                page = await r.text()
    finally:
        tw.worker_task.cancel()
        await runner.stop()
    fams = mod(pkg, "obs").parse_text(page)
    out.append(sorted((name, sorted({tuple(sorted(labels)) for labels, _v in series}))
                      for name, series in fams.items()))
    return out


def test_http_and_ws_faces_answer_alike(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1.7e9)
    got = {}
    for pkg in PKGS:
        counter = itertools.count(1)
        monkeypatch.setattr(mod(pkg, "obs.trace"), "new_trace_id",
                            lambda: f"{next(counter):016x}")
        fresh_obs(pkg)
        got[pkg] = run(_api_script(pkg))
    assert got["tpu_dpow"] == got["tpu_dpow_torch"]
    families = dict(got["tpu_dpow"][-1])
    for fam in ("dpow_server_requests_total", "dpow_sched_admitted_total",
                "dpow_fleet_dispatch_total", "dpow_precache_decisions_total",
                "dpow_resource_outstanding"):
        assert fam in families, fam
