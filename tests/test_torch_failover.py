"""The port's engine failover chain against tpu_dpow's (after
tests/test_resilience.py, tests/test_devfault.py and tests/test_chaos.py).

One fault script runs through both packages' ``FailoverBackend`` on their
FakeClocks: error x3 then open, a half-open probe that succeeds and one that
fails, a cancelled probe releasing its slot, a hang, a crash, an engine that
declares ``DevicesExhausted``, engines dropped at setup, and chains where
every engine fails. The served work, the error texts, the served and
failover counters and the breaker transitions must be equal. Then the
port's real engines: the torch engine's persistent fan of one on the CPU
wedged by ``FaultyDevice`` (against ``JaxWorkBackend`` wedged by tpu_dpow's
``FaultyDevice``), the worker client with the torch engine failing and the
native engine serving, and the client's ``_build_backend`` against the
reference's.
"""

import asyncio
import itertools
import json
from types import SimpleNamespace

import aiohttp
import numpy as np
import pytest
import torch

import tpu_dpow.backend as jbackend
import tpu_dpow.chaos as jchaos
import tpu_dpow.models as jmodels
import tpu_dpow.resilience as jresilience
import tpu_dpow_torch.backend as tbackend
import tpu_dpow_torch.chaos as tchaos
import tpu_dpow_torch.models as tmodels
import tpu_dpow_torch.resilience as tresilience
from tpu_dpow import obs as jobs
from tpu_dpow.backend.jax_backend import JaxWorkBackend
from tpu_dpow.client import parse_args as jax_parse_args
from tpu_dpow.client.app import DpowClient as JaxDpowClient
from tpu_dpow_torch import obs
from tpu_dpow_torch.backend.native_backend import NativeWorkBackend
from tpu_dpow_torch.backend.subprocess_backend import SubprocessWorkBackend
from tpu_dpow_torch.backend.torch_backend import TorchWorkBackend
from tpu_dpow_torch.chaos import ERROR, FaultSchedule, FaultyBackend, Rule
from tpu_dpow_torch.client import ClientConfig, DpowClient, parse_args
from tpu_dpow_torch.resilience import CLOSED, HEALTHY, OPEN, FailoverBackend
from tpu_dpow_torch.server import DpowServer, ServerConfig, hash_key
from tpu_dpow_torch.store import MemoryStore
from tpu_dpow_torch.transport.broker import Broker
from tpu_dpow_torch.transport.inproc import InProcTransport
from tpu_dpow_torch.utils import nanocrypto as nc

# The suite runs in parallel worker processes: one intra-op thread each
# keeps these tests from crowding out the others on the same cores.
torch.set_num_threads(1)

EASY = 0xFF00000000000000  # ~256 hashes expected: instant everywhere
PAYOUT = nc.encode_account(bytes(range(32)))
FAMILIES = (
    "dpow_client_backend_served_total",
    "dpow_client_backend_failover_total",
    "dpow_breaker_state",
    "dpow_breaker_transitions_total",
    "dpow_breaker_failures_total",
)
val = nc.work_value_int


def run(coro, timeout=60):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def brute(block_hash: str, difficulty: int) -> str:
    h = bytes.fromhex(block_hash)
    return f"{next(w for w in itertools.count() if val(h, w) >= difficulty):016x}"


def package(port: bool) -> SimpleNamespace:
    b, r, m, c, o = ((tbackend, tresilience, tmodels, tchaos, obs) if port
                     else (jbackend, jresilience, jmodels, jchaos, jobs))
    return SimpleNamespace(
        WorkBackend=b.WorkBackend, WorkError=b.WorkError, WorkCancelled=b.WorkCancelled,
        DevicesExhausted=b.DevicesExhausted, FailoverBackend=r.FailoverBackend,
        FakeClock=r.FakeClock, WorkRequest=m.WorkRequest, FaultyDevice=c.FaultyDevice,
        obs=o,
    )


def engines(P):
    """The scripted engines of the walk, built on one package's base class."""

    class Scripted(P.WorkBackend):
        """Per-call script: 'ok', 'error', 'cancelled', 'crash', 'exhausted'
        or 'hang' (until cancel); 'ok' brute-forces the request."""

        def __init__(self, script=(), setup_ok=True):
            self.script = list(script)
            self.setup_ok = setup_ok
            self.calls = 0
            self.cancels = []
            self.raises = []
            self._hung = {}

        async def setup(self):
            if not self.setup_ok:
                raise P.WorkError("engine unavailable")

        async def generate(self, request):
            self.calls += 1
            step = self.script.pop(0) if self.script else "ok"
            if step == "error":
                raise P.WorkError("scripted failure")
            if step == "cancelled":
                raise P.WorkCancelled(request.block_hash)
            if step == "crash":
                raise RuntimeError("scripted crash")
            if step == "exhausted":
                raise P.DevicesExhausted("all 1 device(s) quarantined")
            if step == "hang":
                fut = asyncio.get_running_loop().create_future()
                self._hung[request.block_hash] = fut
                return await fut
            return brute(request.block_hash, request.difficulty)

        async def cancel(self, block_hash):
            self.cancels.append(block_hash)
            fut = self._hung.pop(block_hash, None)
            if fut is not None and not fut.done():
                fut.set_exception(P.WorkCancelled(block_hash))

        async def raise_difficulty(self, block_hash, difficulty):
            self.raises.append((block_hash, difficulty))
            return True

    return Scripted


async def _walk(P) -> list:
    """One fault script through package P's FailoverBackend; everything it
    observes, in order."""
    P.obs.reset()
    Scripted = engines(P)
    seen = []
    hashes = (f"{i:064X}" for i in itertools.count(1))

    async def gen(chain, difficulty=EASY, tag=""):
        try:
            work = await chain.generate(P.WorkRequest(next(hashes), difficulty))
            seen.append((tag, "work", work))
        except BaseException as e:  # noqa: BLE001 — the walk records every outcome
            seen.append((tag, type(e).__name__, str(e)))

    async def settle():
        for _ in range(10):  # let the hang-budget timer park on the clock
            await asyncio.sleep(0)

    def note(tag, chain):
        seen.append((tag, {n: (b.state, b.failures) for n, b in chain.breakers.items()}))

    # error x3 then open; open skips; half-open probe succeeds
    clock = P.FakeClock()
    torch_e, native_e = Scripted(["error"] * 3), Scripted()
    chain = P.FailoverBackend([("torch", torch_e), ("native", native_e)],
                              failure_threshold=3, reset_timeout=30.0, clock=clock)
    await chain.setup()
    for i in range(4):
        await gen(chain, tag=f"errors {i}")
        note(f"errors {i}", chain)
    seen.append(("calls while open", torch_e.calls, native_e.calls))
    await clock.advance(30.0)
    await gen(chain, tag="probe ok")
    note("probe ok", chain)

    # half-open probe that fails: back to open, fallback serves
    clock = P.FakeClock()
    chain = P.FailoverBackend([("torch", Scripted(["error", "error"])), ("native", Scripted())],
                              failure_threshold=1, reset_timeout=10.0, clock=clock)
    await chain.setup()
    await gen(chain, tag="trip")
    await clock.advance(10.0)
    await gen(chain, tag="probe fails")
    note("probe fails", chain)

    # a cancelled probe releases its slot; the next request probes and recovers
    clock = P.FakeClock()
    chain = P.FailoverBackend([("torch", Scripted(["error", "cancelled"])),
                               ("native", Scripted())],
                              failure_threshold=1, reset_timeout=10.0, clock=clock)
    await chain.setup()
    await gen(chain, tag="trip")
    await clock.advance(10.0)
    await gen(chain, tag="probe cancelled")
    note("probe cancelled", chain)
    await gen(chain, tag="next probe")
    note("next probe", chain)

    # a hang past the budget: cancel sent to the hung engine, fallback serves
    clock = P.FakeClock()
    hung = Scripted(["hang"])
    chain = P.FailoverBackend([("torch", hung), ("native", Scripted())],
                              failure_threshold=3, hang_timeout=5.0, clock=clock)
    await chain.setup()
    task = asyncio.ensure_future(gen(chain, tag="hang"))
    await settle()
    await clock.advance(5.0)
    await task
    note("hang", chain)
    seen.append(("hang cancels", hung.cancels))

    # a crash, an exhausted engine (tripped outright), then both open
    clock = P.FakeClock()
    chain = P.FailoverBackend([("torch", Scripted(["crash", "exhausted"])),
                               ("native", Scripted(["error"] * 2))],
                              failure_threshold=2, reset_timeout=60.0, hang_timeout=30.0,
                              clock=clock)
    await chain.setup()
    await gen(chain, tag="crash")
    note("crash", chain)
    await gen(chain, tag="exhausted")
    note("exhausted", chain)
    await gen(chain, tag="all open")

    # every engine fails; the last error is a hang
    clock = P.FakeClock()
    chain = P.FailoverBackend([("torch", Scripted(["error"])), ("native", Scripted(["hang"]))],
                              failure_threshold=3, hang_timeout=2.0, clock=clock)
    await chain.setup()
    task = asyncio.ensure_future(gen(chain, tag="all fail"))
    await settle()
    await clock.advance(2.0)
    await task

    # a dead engine is dropped at setup; a chain of only dead ones refuses
    chain = P.FailoverBackend([("dead", Scripted(setup_ok=False)), ("live", Scripted())])
    await chain.setup()
    await gen(chain, tag="dropped at setup")
    try:
        await P.FailoverBackend([("dead", Scripted(setup_ok=False))]).setup()
    except P.WorkError as e:
        seen.append(("only dead", str(e)))

    # cancel and raise_difficulty reach the engine grinding the hash
    owner, other = Scripted(["hang"]), Scripted()
    chain = P.FailoverBackend([("torch", owner), ("native", other)])
    await chain.setup()
    h = f"{99:064X}"
    task = asyncio.ensure_future(chain.generate(P.WorkRequest(h, EASY)))
    await settle()
    seen.append(("raise", await chain.raise_difficulty(h, EASY + 1), owner.raises))
    await chain.cancel(h)
    try:
        await task
    except P.WorkCancelled as e:
        seen.append(("cancelled", str(e), owner.cancels, other.cancels))
    await chain.cancel(f"{98:064X}")  # no owner: fans out to every engine
    seen.append(("fan-out cancel", owner.cancels, other.cancels))
    seen.append(("raise without owner", await chain.raise_difficulty(h, EASY)))

    snap = P.obs.snapshot()
    seen.append(("metrics", {name: snap.get(name) for name in FAMILIES}))
    return seen


def test_failover_walk_matches_the_reference():
    got = run(_walk(package(port=True)))
    want = run(_walk(package(port=False)))
    assert got == want
    all_fail = next(rest for tag, *rest in got if tag == "all fail")
    assert all_fail[0] == "WorkError"
    assert all_fail[1].endswith("(last: native engine hung past 2.0s)")
    metrics = got[-1][1]
    assert metrics["dpow_client_backend_failover_total"]["series"] == {
        "torch,error": 7.0, "torch,hang": 1.0, "torch,crash": 1.0,
        "torch,devices_exhausted": 1.0, "native,error": 2.0, "native,hang": 1.0}
    assert metrics["dpow_client_backend_served_total"]["series"] == {
        "native": 8.0, "torch": 2.0, "live": 1.0}


# -- devices_exhausted from the real engines ------------------------------------------


def _wedged_engine(port: bool, clock):
    kw = dict(run_mode="persistent", persistent_steps=4, control_poll_steps=1, pipeline=1,
              clock=clock, device_suspect_after=5.0, device_probe_interval=20.0)
    if port:
        return TorchWorkBackend(device="cpu", devices=1, **kw)
    return JaxWorkBackend(kernel="xla", sublanes=8, iters=8, devices=1, **kw)


async def _exhausted_drill(port: bool) -> list:
    """The primary engine's only device wedges at its window-1 poll; the
    watchdog quarantines it, the engine raises DevicesExhausted, the chain
    trips its breaker and the fallback serves that same request; after the
    release, the probe re-admits the device and, past the breaker's reset,
    the primary serves again."""
    P = package(port)
    P.obs.reset()
    Scripted = engines(P)
    clock = P.FakeClock()
    eng = _wedged_engine(port, clock)
    chain = P.FailoverBackend([("primary", eng), ("fallback", Scripted())],
                              failure_threshold=3, reset_timeout=60.0, clock=clock)
    await chain.setup()
    # The primary scans from S; its first windows (the floor) hold no hit,
    # so it is still scanning when it reaches the wedged poll.
    rng = np.random.default_rng(41)
    hx = rng.bytes(32).hex().upper()
    S = 1 << 40
    floor = max(val(bytes.fromhex(hx), S + i) for i in range(4 * eng.chunk))
    seen = [("window", eng.chunk)]
    with P.FaultyDevice() as fd:
        fd.hang_at_poll(0, 1)
        task = asyncio.ensure_future(
            chain.generate(P.WorkRequest(hx, floor + 1, nonce_range=(S, 1 << 30))))
        deadline = asyncio.get_running_loop().time() + 30
        while not any(("poll", 0, k) in fd.events for k in (1, 2)):
            assert asyncio.get_running_loop().time() < deadline, "device never wedged"
            await asyncio.sleep(0.005)
        await clock.advance(7.0)
        work = await asyncio.wait_for(task, 30)
        seen.append(("served while wedged", work, chain.breakers["primary"].state))
        fd.release(0)
    await clock.advance(21.0)
    deadline = asyncio.get_running_loop().time() + 30
    while eng._dfd.state(0) != HEALTHY:  # the same state name in both packages
        assert asyncio.get_running_loop().time() < deadline, "probe never re-admitted"
        await asyncio.sleep(0.005)
    await clock.advance(40.0)  # past the breaker's reset: the next request probes
    h2 = rng.bytes(32).hex().upper()
    work2 = await asyncio.wait_for(chain.generate(P.WorkRequest(h2, EASY)), 30)
    nc.validate_work(h2, work2, EASY)
    seen.append(("after re-admission", chain.breakers["primary"].state))
    await chain.close()
    # The engines' own per-device breakers carry their engine's label.
    snap = json.loads(json.dumps(P.obs.snapshot()).replace("device:jax:", "device:torch:"))
    seen.append(("metrics", {name: snap.get(name) for name in FAMILIES}))
    return seen


def test_devices_exhausted_from_the_torch_engine_fails_over_like_the_reference():
    got = run(_exhausted_drill(port=True), 120)
    want = run(_exhausted_drill(port=False), 120)
    assert got == want
    assert got[1][2] == OPEN and got[2] == ("after re-admission", CLOSED)
    metrics = got[-1][1]
    assert metrics["dpow_client_backend_failover_total"]["series"] == {
        "primary,devices_exhausted": 1.0}
    assert metrics["dpow_client_backend_served_total"]["series"] == {
        "fallback": 1.0, "primary": 1.0}


# -- the worker client: torch fails, native serves, /metrics shows it -------------


def test_chaos_torch_failures_open_breaker_native_serves_metrics_visible():
    """Twin of tests/test_chaos.py's acceptance scenario 2: the torch
    engine throws WorkError three times → its breaker opens; the native
    engine serves every request (including while the breaker is open,
    without the torch engine even being tried); breaker state and
    per-engine serving counts are on the port worker's /metrics page."""

    async def main():
        obs.reset()
        broker = Broker()
        config = ServerConfig(base_difficulty=EASY, throttle=1000.0, heartbeat_interval=0.05,
                              statistics_interval=3600.0)
        store = MemoryStore()
        server = DpowServer(config, store, InProcTransport(broker, client_id="server"))
        await server.setup()
        server.start_loops()
        await store.hset("service:svc", {"api_key": hash_key("secret"), "public": "N",
                                         "precache": "0", "ondemand": "0"})
        await store.sadd("services", "svc")
        torch_faults = FaultSchedule([Rule(op="generate", action=ERROR, times=-1)])
        chain = FailoverBackend(
            [("torch", FaultyBackend(TorchWorkBackend(device="cpu"), torch_faults)),
             ("native", NativeWorkBackend())],
            failure_threshold=3, reset_timeout=3600.0,
        )
        client = DpowClient(
            ClientConfig(payout_address=PAYOUT, startup_heartbeat_wait=3.0, metrics_port=0),
            InProcTransport(broker, client_id="worker"), backend=chain,
        )
        await client.setup()
        client.start_loops()
        rng = np.random.default_rng(7)
        try:
            for i in range(5):
                resp = await asyncio.wait_for(server.service_handler(
                    {"user": "svc", "api_key": "secret", "hash": rng.bytes(32).hex().upper(),
                     "timeout": 20}), 15)
                nc.validate_work(resp["hash"], resp["work"], EASY)
                if i == 2:
                    assert chain.breakers["torch"].state == OPEN
            assert chain.breakers["torch"].state == OPEN
            assert torch_faults.fired(ERROR) == 3
            async with aiohttp.ClientSession() as http:
                url = f"http://127.0.0.1:{client.metrics_port}/metrics"
                async with http.get(url) as resp:
                    assert resp.status == 200
                    page = await resp.text()
            assert 'dpow_breaker_state{name="backend:torch"} 1' in page
            families = obs.parse_text(page)

            def value(metric, **labels):
                return next((v for found, v in families.get(metric, []) if found == labels), 0.0)

            assert value("dpow_breaker_transitions_total", name="backend:torch", to="open") == 1
            assert value("dpow_client_backend_served_total", backend="native") == 5
            assert value("dpow_client_backend_failover_total", backend="torch",
                         cause="error") == 3
            assert value("dpow_engine_solutions_total", engine="native") == 5
        finally:
            await client.close()
            await server.close()

    run(main())


# -- configuration and _build_backend -----------------------------------------------


def test_config_accepts_every_engine_and_a_fallback_chain():
    for backend in ("torch", "native", "subprocess"):
        assert parse_args(["--payout", PAYOUT, "--backend", backend]).backend == backend
    c = parse_args(["--payout", PAYOUT, "--backend_fallback", "native"])
    assert (c.backend, c.backend_fallback, c.fallback_names) == ("torch", "native", ["native"])
    assert ClientConfig(backend="native", backend_fallback=" subprocess , ").fallback_names == [
        "subprocess"]
    assert parse_args(["--payout", PAYOUT]).backend_fallback == ""  # no chain by default
    with pytest.raises(SystemExit):
        parse_args(["--payout", PAYOUT, "--backend", "jax"])


def _named(name: str) -> str:
    """The reference's GPU engine is 'jax' where the port's is 'torch'."""
    return "torch" if name == "jax" else name


def _describe(b) -> dict:
    kinds = {"JaxWorkBackend": "gpu", "TorchWorkBackend": "gpu",
             "NativeWorkBackend": "native", "SubprocessWorkBackend": "subprocess"}
    if not hasattr(b, "breakers"):
        out = {"kind": kinds[type(b).__name__]}
        if out["kind"] == "gpu":
            out["max_batch"] = b.max_batch
        if out["kind"] == "native":
            out.update(threads=b.threads, chunk=b.chunk)
        if out["kind"] == "subprocess":
            out["uri"] = b.uri
        return out
    return {
        "engines": [(_named(n), _describe(e)) for n, e in b.backends],
        "breakers": {_named(n): (br.name.replace("jax", "torch"), br.failure_threshold,
                                 br.reset_timeout) for n, br in b.breakers.items()},
        "hang_timeout": b.hang_timeout,
        "max_batch": getattr(b, "max_batch", None),
    }


@pytest.mark.parametrize("argv", [
    [],
    ["--backend", "native"],
    ["--backend", "subprocess", "--worker_uri", "127.0.0.1:7100"],
    ["--backend_fallback", "native", "--breaker_failures", "5", "--breaker_reset", "12",
     "--backend_hang_timeout", "9", "--max_batch", "8"],
    ["--backend", "native", "--backend_fallback", "subprocess,torch"],
])
def test_build_backend_builds_the_reference_chain(argv):
    common = ["--payout", PAYOUT]

    def swap(args, old, new):
        return [new if a == old else a for a in args]

    port_argv = common + ["--device", "cpu"] + swap(argv, "jax", "torch")
    ref_argv = common + swap(swap(argv, "torch", "jax"), "subprocess,torch", "subprocess,jax")
    got = DpowClient._build_backend(parse_args(port_argv))
    want = JaxDpowClient._build_backend(jax_parse_args(ref_argv))
    assert _describe(got) == _describe(want)
    if "--backend_fallback" in argv:
        assert isinstance(got, FailoverBackend)
    engines_ = [e for _n, e in got.backends] if isinstance(got, FailoverBackend) else [got]
    for e in engines_:
        if isinstance(e, TorchWorkBackend):
            assert e.device == torch.device("cpu")
        if isinstance(e, SubprocessWorkBackend) and "--worker_uri" in argv:
            assert e.uri == "http://127.0.0.1:7100"
