"""The port's load generator (``tpu_dpow_torch/loadgen``) against
``tpu_dpow.loadgen``, fed the same seeds and scripts.

Schedules (homogeneous and thinned non-homogeneous Poisson), rate
functions at 64 sample points, trace parsing and its line-numbered
refusals, the population's request and confirmation streams, store
seeding (``MemoryStore.snapshot()``), recorder summaries, timelines and
``dpow_loadgen_*`` series on a FakeClock, the open-loop driver's
timeout/cancel/shed_client outcomes against a scripted issue callable, and
``classify_response`` are equal in both packages. Then a FakeClock
open-loop smoke through each package's hub with its synthetic responder
gives equal summaries, and the port's WsDriver and HttpPostDriver speak to
the port's hub.
"""

import asyncio
import dataclasses
import json

import numpy as np
import pytest

import tpu_dpow.loadgen as jl
import tpu_dpow_torch.loadgen as tl
from tpu_dpow import obs as jobs
from tpu_dpow.loadgen import config as jconfig
from tpu_dpow.loadgen import driver as jdriver
from tpu_dpow.loadgen import population as jpopulation
from tpu_dpow.resilience import FakeClock as JFakeClock
from tpu_dpow_torch import obs as tobs
from tpu_dpow_torch.loadgen import config as tconfig
from tpu_dpow_torch.loadgen import driver as tdriver
from tpu_dpow_torch.loadgen import population as tpopulation
from tpu_dpow_torch.resilience import FakeClock as TFakeClock

PKG = {
    "port": dict(l=tl, obs=tobs, clock=TFakeClock, pop=tpopulation, root="tpu_dpow_torch"),
    "jax": dict(l=jl, obs=jobs, clock=JFakeClock, pop=jpopulation, root="tpu_dpow"),
}
RNG = np.random.default_rng(2040)


def run(coro, timeout=60):
    return asyncio.run(asyncio.wait_for(coro, timeout=timeout))


def fields(x):
    return dataclasses.astuple(x)


def seeds(n):
    return [int(s) for s in RNG.integers(0, 1 << 31, size=n)]


def loadgen_series(obs_mod) -> dict:
    snap = obs_mod.snapshot()
    return {k: v for k, v in snap.items() if k.startswith("dpow_loadgen_")}


# -- arrival schedules ----------------------------------------------------------


@pytest.mark.parametrize("seed", seeds(3))
def test_poisson_schedules_are_equal(seed):
    got = [fields(a) for a in tl.poisson_schedule(50.0, n=500, seed=seed)]
    want = [fields(a) for a in jl.poisson_schedule(50.0, n=500, seed=seed)]
    assert got == want and len(got) == 500


@pytest.mark.parametrize("seed", seeds(2))
def test_thinned_schedules_over_diurnal_and_spike_are_equal(seed):
    def rate(l):
        return l.SpikeOverlay(l.DiurnalRate(2.0, 40.0, period=400.0), at=150.0,
                              duration=20.0, factor=5.0)

    got = [fields(a) for a in tl.poisson_schedule(rate(tl), duration=400.0, seed=seed)]
    want = [fields(a) for a in jl.poisson_schedule(rate(jl), duration=400.0, seed=seed)]
    assert got == want and len(got) > 100


def test_rate_functions_agree_at_64_points():
    ts = [float(t) for t in np.sort(RNG.uniform(0.0, 1200.0, size=64))]
    for make in (
        lambda l: l.ConstantRate(7.5),
        lambda l: l.DiurnalRate(5.0, 50.0, period=600.0),
        lambda l: l.SpikeOverlay(l.DiurnalRate(5.0, 50.0, period=600.0), at=300.0,
                                 duration=30.0, factor=10.0),
        lambda l: l.SpikeOverlay(l.ConstantRate(20.0), at=0.0, duration=600.0, factor=3.0),
    ):
        t_rate, j_rate = make(tl), make(jl)
        assert [t_rate.rate(t) for t in ts] == [j_rate.rate(t) for t in ts]
        assert t_rate.ceiling() == j_rate.ceiling()


# -- trace replay -------------------------------------------------------------


def test_trace_parse_and_schedule_are_equal():
    text = "\n".join([
        "# a comment line",
        json.dumps({"t": 0.5}),
        json.dumps({"t": 1.0, "service": "svc-00001", "hash": "AB" * 32, "timeout": 3.5}),
        "",
        json.dumps({"t": 1.0}),
        json.dumps({"t": 7.25, "hash": "CD" * 32}),
    ])
    assert [fields(a) for a in tl.parse_trace(text)] == [fields(a) for a in jl.parse_trace(text)]
    for scale, repeat in ((1.0, 1), (0.1, 2), (2.5, 3)):
        got = [fields(a) for a in tl.trace_schedule(text, time_scale=scale, repeat=repeat)]
        want = [fields(a) for a in jl.trace_schedule(text, time_scale=scale, repeat=repeat)]
        assert got == want


@pytest.mark.parametrize("bad", [
    '{"t": 1.0}\n{"t": 2.0}\n{"t": 1.5}',
    '{"t": 1.0}\nnot json',
    '{"x": 1.0}',
    '{"t": "soon"}',
    '{"t": -1.0}',
    '{"t": NaN}',
    '{"t": 1.0, "timeout": 0}',
    '{"t": 0.0}\n\n# c\n{"t": 0.5, "timeout": -3}',
])
def test_trace_errors_are_equal_with_line_numbers(bad):
    with pytest.raises(tl.TraceError) as got:
        tl.parse_trace(bad)
    with pytest.raises(jl.TraceError) as want:
        jl.parse_trace(bad)
    assert str(got.value) == str(want.value) and "line" in str(got.value)


# -- population ---------------------------------------------------------------


@pytest.mark.parametrize("seed", seeds(2))
def test_request_and_confirm_streams_are_equal(seed):
    sched = [float(t) for t in np.cumsum(RNG.exponential(0.05, size=600))]
    tp = tl.ServicePopulation(40, seed=seed, n_accounts=200)
    jp = jl.ServicePopulation(40, seed=seed, n_accounts=200)
    assert [fields(p) for p in tp.profiles] == [fields(p) for p in jp.profiles]
    for i, t in enumerate(sched):
        if i % 3 == 2:
            got, want = tp.confirm_spec(tl.Arrival(t)), jp.confirm_spec(jl.Arrival(t))
        else:
            got, want = tp.spec(tl.Arrival(t)), jp.spec(jl.Arrival(t))
        assert fields(got) == fields(want), i
    over = tp.spec(tl.Arrival(1.0, service="svc-00004", hash="CD" * 32, timeout=9.0))
    assert (over.service, over.hash, over.timeout) == ("svc-00004", "CD" * 32, 9.0)


def test_seed_store_and_seed_accounts_give_equal_snapshots():
    from tpu_dpow.store import MemoryStore as JStore
    from tpu_dpow_torch.store import MemoryStore as TStore

    async def seed(l, store_cls):
        pop = l.ServicePopulation(25, seed=11, n_accounts=60)
        store = store_cls(clock=lambda: 1000.0)
        n = await pop.seed_store(store)
        m = await pop.seed_accounts(store, limit=40)
        return n, m, store.snapshot()

    async def main():
        return await seed(tl, TStore), await seed(jl, JStore)

    got, want = run(main())
    assert got == want and got[:2] == (25, 40)


def test_config_builders_are_equal():
    argv = ["--loadgen_rate", "20", "--loadgen_n", "300", "--loadgen_seed", "2040",
            "--loadgen_services", "100", "--loadgen_peak", "60", "--loadgen_period", "120"]
    tc, jc = tconfig.parse_args(argv), jconfig.parse_args(argv)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tc.loadgen_ws_fraction == 0.1
    got = [fields(a) for a in tconfig.build_schedule(tc)]
    want = [fields(a) for a in jconfig.build_schedule(jc)]
    assert got == want and len(got) == 300
    tp, jp = tconfig.build_population(tc), jconfig.build_population(jc)
    assert [fields(p) for p in tp.profiles] == [fields(p) for p in jp.profiles]
    with pytest.raises(ValueError):
        tconfig.build_rate(tconfig.LoadgenConfig())


# -- recorder -----------------------------------------------------------------


def recorder_script(pkg):
    """The same recorder calls in one package: issued-late requests,
    every outcome, two timeline windows, and a summary with SLO grading."""
    p = PKG[pkg]
    p["obs"].reset()
    clock = p["clock"]()
    rec = p["l"].OpenLoopRecorder(clock, window=5.0)
    rng = np.random.default_rng(7)
    outcomes = ["ok"] * 30 + ["busy", "timeout", "cancelled", "error", "shed_client"] * 2

    async def main():
        rec.begin()
        await clock.advance(3.0)
        rec.issued(1.0)
        await clock.advance(2.0)
        first = rec.done(1.0, "ok")
        lat = []
        for i, outcome in enumerate(outcomes):
            t = float(rng.uniform(0.0, 12.0))
            lat.append(rec.done(t, outcome, end_t=t + float(rng.exponential(0.4)),
                                issued=outcome != "shed_client"))
        return first, lat

    first, lat = run(main())
    return (first, lat, rec.summary(slo_p95_ms=1000.0), rec.summary(), rec.timeline(),
            rec.percentile(0.5), loadgen_series(p["obs"]))


def test_recorder_output_and_series_are_equal():
    got, want = recorder_script("port"), recorder_script("jax")
    assert got == want
    first, _lat, summary, _s, timeline, _p50, series = got
    assert first == 4.0 and summary["measured_from"] == "intended_arrival"
    assert len(timeline) == 3
    assert set(series) == {"dpow_loadgen_requests_total", "dpow_loadgen_latency_seconds",
                           "dpow_loadgen_issue_lag_seconds", "dpow_loadgen_inflight"}
    assert tl.FINE_BUCKETS == jl.FINE_BUCKETS
    with pytest.raises(ValueError):
        tl.OpenLoopRecorder(TFakeClock()).done(0.0, "mystery")


# -- the open-loop driver --------------------------------------------------------


class StubIssue:
    """Answers after ``delay`` on the fake clock with ``outcome``, and
    records when each request was issued."""

    def __init__(self, clock, delay=0.0, outcome="ok"):
        self.clock, self.delay, self.outcome = clock, delay, outcome
        self.issued_at = []

    async def __call__(self, spec):
        self.issued_at.append((spec.intended_t, self.clock.time()))
        if self.delay:
            await self.clock.sleep(self.delay)
        return self.outcome


async def drive(driver, schedule, clock, span, step=0.25):
    task = asyncio.ensure_future(driver.run(schedule))
    elapsed = 0.0
    while not task.done() and elapsed < span:
        await clock.advance(step)
        elapsed += step
    for _ in range(200):
        if task.done():
            break
        await clock.advance(step)
    return await task


def driver_script(pkg, case):
    p = PKG[pkg]
    p["obs"].reset()
    clock = p["clock"]()
    rec = p["l"].OpenLoopRecorder(clock, window=5.0)
    RequestSpec = p["pop"].RequestSpec

    class OnePop:
        def __init__(self, cancel_after=None, timeout=2.0):
            self.cancel_after, self.timeout = cancel_after, timeout

        def spec(self, a):
            return RequestSpec(intended_t=a.t, service="svc", api_key="k", hash="AB" * 32,
                               timeout=self.timeout, cancel_after=self.cancel_after)

    Arrival = p["l"].Arrival
    if case == "on_schedule":
        stub = StubIssue(clock, delay=0.1)
        pop = p["l"].ServicePopulation(3, seed=0, cancel_rate=(0.0, 0.0))
        d = p["l"].OpenLoopDriver(stub, rec, population=pop, clock=clock)
        sched, span, step = [Arrival(t) for t in (0.5, 1.0, 1.5, 2.0)], 6.0, 0.25
    elif case == "timeout":
        stub = StubIssue(clock, delay=1000.0)
        d = p["l"].OpenLoopDriver(stub, rec, population=OnePop(), clock=clock)
        sched, span, step = [Arrival(0.1)], 8.0, 0.5
    elif case == "cancel":
        stub = StubIssue(clock, delay=1000.0)
        d = p["l"].OpenLoopDriver(stub, rec, population=OnePop(cancel_after=0.5), clock=clock)
        sched, span, step = [Arrival(0.1)], 4.0, 0.25
    else:  # shed_client
        stub = StubIssue(clock, delay=1000.0)
        pop = p["l"].ServicePopulation(2, seed=0, cancel_rate=(0.0, 0.0))
        d = p["l"].OpenLoopDriver(stub, rec, population=pop, clock=clock, max_inflight=2)
        sched, span, step = [Arrival(0.1 * (i + 1)) for i in range(5)], 40.0, 1.0
    summary = run(drive(d, sched, clock, span, step))
    return summary, stub.issued_at, d.issued, d.shed_client, loadgen_series(p["obs"])


@pytest.mark.parametrize("case,outcomes", [
    ("on_schedule", {"ok": 4}),
    ("timeout", {"timeout": 1}),
    ("cancel", {"cancelled": 1}),
    ("shed_client", {"shed_client": 3, "timeout": 2}),
])
def test_open_loop_driver_outcomes_are_equal(case, outcomes):
    got, want = driver_script("port", case), driver_script("jax", case)
    assert got == want
    assert got[0]["outcomes"] == outcomes


def test_classify_response_table_is_equal():
    table = [
        (200, {"work": "ab", "hash": "CD"}), (429, {"error": "busy"}),
        (None, {"busy": True, "retry_after": 2}),
        (200, {"error": "Timeout reached without work", "timeout": True}),
        (200, {"error": "Invalid hash"}), (200, "garbage"), (500, {}), (None, None),
        (200, {"work": ""}), (503, {"busy": False}), (None, {"timeout": False}),
    ]
    got = [tdriver.classify_response(s, d) for s, d in table]
    assert got == [jdriver.classify_response(s, d) for s, d in table]
    assert got[:6] == ["ok", "busy", "busy", "timeout", "error", "error"]


def test_http_driver_benches_dead_faces():
    tobs.reset()

    async def main():
        d = tl.HttpPostDriver(["http://127.0.0.1:1", "http://127.0.0.1:2"],
                              clock=TFakeClock(), face_cooldown=5.0)
        out = await d(tpopulation.RequestSpec(0.0, "svc", "k", "AB" * 32, 2.0))
        assert out == "error" and d.retries == 2 and len(d._dead_until) == 2
        await d.close()

    run(main())


# -- open loop through each package's hub ------------------------------------------


def smoke_through_hub(pkg):
    """tests/test_loadgen.py's FakeClock smoke: 60 Poisson arrivals through
    the package's DpowServer over its in-process broker, served by its
    SyntheticResponder."""
    p = PKG[pkg]
    root = __import__(p["root"] + ".server", fromlist=["DpowServer"])
    store_mod = __import__(p["root"] + ".store", fromlist=["MemoryStore"])
    broker_mod = __import__(p["root"] + ".transport.broker", fromlist=["Broker"])
    inproc = __import__(p["root"] + ".transport.inproc", fromlist=["InProcTransport"])
    p["obs"].reset()
    clock = p["clock"]()
    broker = broker_mod.Broker()
    store = store_mod.MemoryStore(clock=clock.time)
    config = root.ServerConfig(base_difficulty=0xFF00000000000000, throttle=100000.0,
                               heartbeat_interval=3600.0, statistics_interval=3600.0,
                               work_republish_interval=2.0, fleet=False)
    server = root.DpowServer(config, store, inproc.InProcTransport(broker, client_id="server"),
                             clock=clock)
    pop = p["l"].ServicePopulation(8, seed=3, reuse_prob=(0.3, 0.5), cancel_rate=(0.0, 0.05),
                                   timeout_median=(8.0, 12.0))
    rec = p["l"].OpenLoopRecorder(clock, window=2.0)

    async def main():
        await server.setup()
        server.start_loops()
        await pop.seed_store(store)
        responder = p["l"].SyntheticResponder(
            inproc.InProcTransport(broker, client_id="responder"), latency=0.05, clock=clock)
        await responder.start()
        d = p["l"].OpenLoopDriver(p["l"].InprocDriver(server.service_handler), rec,
                                  population=pop, clock=clock)
        try:
            return await drive(d, p["l"].poisson_schedule(10.0, n=60, seed=11), clock, 30.0)
        finally:
            await responder.close()
            await server.close()

    summary = run(main())
    snap = p["obs"].snapshot()
    return (summary, rec.timeline(), loadgen_series(p["obs"]),
            snap["dpow_server_requests_total"]["series"],
            snap["dpow_loadgen_responder_served_total"]["series"])


def test_open_loop_smoke_through_each_hub_gives_equal_summaries():
    got, want = smoke_through_hub("port"), smoke_through_hub("jax")
    assert got == want
    summary, _timeline, _series, served, responder = got
    assert summary["n"] == 60 and set(summary["outcomes"]) <= {"ok", "cancelled"}
    assert summary["outcomes"]["ok"] >= 50
    assert served.get("precache", 0) >= 1  # hash reuse reached the store-hit path
    assert sum(responder.values()) >= 1


def test_ws_driver_round_trip_against_the_port_hub():
    tobs.reset()
    from tpu_dpow_torch.server import DpowServer, ServerConfig, hash_key
    from tpu_dpow_torch.server.api import ServerRunner
    from tpu_dpow_torch.store import MemoryStore
    from tpu_dpow_torch.transport.broker import Broker
    from tpu_dpow_torch.transport.inproc import InProcTransport

    clock = TFakeClock()
    broker = Broker()
    store = MemoryStore()
    config = ServerConfig(base_difficulty=0xFF00000000000000, throttle=100000.0,
                          heartbeat_interval=3600.0, statistics_interval=3600.0, fleet=False,
                          service_port=0, service_ws_port=0, upcheck_port=0, block_cb_port=0)
    server = DpowServer(config, store, InProcTransport(broker, client_id="server"), clock=clock)

    async def main():
        runner = ServerRunner(server, config)
        await runner.start()
        await store.hset("service:svc", {"api_key": hash_key("secret"), "public": "N",
                                         "display": "svc", "website": "", "precache": "0",
                                         "ondemand": "0"})
        await store.sadd("services", "svc")
        responder = tl.SyntheticResponder(InProcTransport(broker, client_id="responder"),
                                          latency=0.0, clock=clock)
        await responder.start()
        ws = tl.WsDriver([f"ws://127.0.0.1:{runner.ports['service_ws']}"], clock=clock,
                         conns_per_face=1)
        http = tl.HttpPostDriver([f"http://127.0.0.1:{runner.ports['service']}"], clock=clock)
        try:
            await ws.start()
            specs = [tpopulation.RequestSpec(0.0, "svc", "secret", f"{i:02X}" * 32, 10.0)
                     for i in range(4)]
            outs = await asyncio.gather(*(ws(s) for s in specs[:3]), http(specs[3]))
            assert list(outs) == ["ok"] * 4
            bad = tpopulation.RequestSpec(0.0, "svc", "wrong", "EE" * 32, 10.0)
            assert await ws(bad) == "error" and await http(bad) == "error"
        finally:
            await ws.close()
            await http.close()
            await responder.close()
            await runner.stop()

    run(main())
