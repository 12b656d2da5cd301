"""The port's operator CLIs against tpu_dpow's (twins of tests/test_scripts.py).

Each twin runs one flow through both packages' scripts — the same CLI
arguments on the same seeded store — and requires equal results: equal
store snapshots, equal printed output, equal payouts and snapshot files
(uuid included: ``uuid.uuid4`` is pinned to one counter for both, and
``time.time`` to one instant, so the files' names match too). The latency
probe runs over the port's in-process, ``tcp://`` and ``mqtt://`` brokers,
``--from-metrics`` reads a page of the port's hub, and each script runs as
``python -m tpu_dpow_torch.scripts.<name>``.
"""

import asyncio
import contextlib
import http.server
import io
import itertools
import json
import os
import subprocess
import sys
import threading
import time
import uuid
from types import SimpleNamespace

import pytest

import tpu_dpow.scripts as jscripts
import tpu_dpow_torch.scripts as tscripts
from tpu_dpow import obs as jobs
from tpu_dpow.obs.registry import Registry as JaxRegistry
from tpu_dpow.scripts import check_latency as jcl
from tpu_dpow.scripts import client_snapshot as jcs
from tpu_dpow.scripts import payouts as jpayouts
from tpu_dpow.scripts import services as jservices
from tpu_dpow.store import MemoryStore as JaxMemoryStore
from tpu_dpow.store.sqlite_store import SqliteStore as JaxSqliteStore
from tpu_dpow.transport.broker import Broker as JaxBroker
from tpu_dpow.transport.inproc import InProcTransport as JaxInProcTransport
from tpu_dpow_torch import obs
from tpu_dpow_torch.backend import WorkBackend
from tpu_dpow_torch.client import ClientConfig, DpowClient
from tpu_dpow_torch.obs.registry import Registry
from tpu_dpow_torch.scripts import check_latency as cl
from tpu_dpow_torch.scripts import client_snapshot as cs
from tpu_dpow_torch.scripts import open_store, payouts, services
from tpu_dpow_torch.server import DpowServer, ServerConfig, hash_key
from tpu_dpow_torch.store import MemoryStore
from tpu_dpow_torch.store.sqlite_store import SqliteStore
from tpu_dpow_torch.transport import default_users
from tpu_dpow_torch.transport.broker import Broker
from tpu_dpow_torch.transport.inproc import InProcTransport
from tpu_dpow_torch.transport.tcp import TcpBrokerServer
from tpu_dpow_torch.utils import nanocrypto as nc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# A syntactically valid nano address for payout tests.
VALID_ACCOUNT = nc.encode_account(bytes(range(32)))
EASY = 0xFF00000000000000

PORT = SimpleNamespace(scripts=tscripts, services=services, cs=cs, payouts=payouts, cl=cl,
                       MemoryStore=MemoryStore, SqliteStore=SqliteStore, Broker=Broker,
                       InProcTransport=InProcTransport, obs=obs, Registry=Registry)
REF = SimpleNamespace(scripts=jscripts, services=jservices, cs=jcs, payouts=jpayouts, cl=jcl,
                      MemoryStore=JaxMemoryStore, SqliteStore=JaxSqliteStore, Broker=JaxBroker,
                      InProcTransport=JaxInProcTransport, obs=jobs, Registry=JaxRegistry)


def run(coro):
    return asyncio.run(coro)


def contents(store) -> dict:
    return json.loads(store.snapshot())


@pytest.fixture
def pinned(monkeypatch):
    """uuid4 from one counter (restarted per package) and a fixed time."""
    counter = {}

    def restart():
        counter["it"] = itertools.count(1)

    monkeypatch.setattr(uuid, "uuid4", lambda: uuid.UUID(int=next(counter["it"])))
    monkeypatch.setattr(time, "time", lambda: 1_760_000_000.0)
    restart()
    return restart


# ---------------------------------------------------------------- services


async def _services_flow(P) -> list:
    store = P.MemoryStore()
    seen = []
    parse = P.services.build_parser().parse_args
    args = parse(["add", "--user", "faucet", "--api_key", "s3cret", "--display",
                  "Faucet", "--website", "https://f.example", "--public"])
    seen.append(await P.services.add(store, args))
    seen.append(contents(store))
    seen.append(await P.services.add(store, args))  # duplicate add refused
    seen.append(await P.services.update(store, parse(
        ["update", "--user", "faucet", "--private", "--website", "https://g"])))
    seen.append(contents(store))
    seen.append(await P.services.check(store, parse(["check", "--user", "faucet"])))
    seen.append(await P.services.list_services(store, parse(["list"])))
    seen.append(await P.services.delete(store, parse(["delete", "--user", "faucet"])))
    seen.append(await P.services.delete(store, parse(["delete", "--user", "faucet"])))
    seen.append(contents(store))
    return seen


def test_services_add_check_list_delete(capsys):
    got = run(_services_flow(PORT))
    out = capsys.readouterr()
    want = run(_services_flow(REF))
    assert got == want and (out.out, out.err) == tuple(capsys.readouterr())
    rc_add, added, rc_dup, rc_upd, updated, *_rest, rc_del, rc_del2, final = got
    record = added["entries"]
    assert (rc_add, rc_dup, rc_upd, rc_del, rc_del2) == (0, 1, 0, 0, 1)
    assert "s3cret" not in json.dumps(added) and services.hash_api_key("s3cret") in json.dumps(
        record)
    assert "https://g" in json.dumps(updated)
    assert "faucet" not in json.dumps(final)


def _stats_seed(P):
    async def seed():
        store = P.MemoryStore()
        await store.set("stats:precache", "7")
        await store.set("stats:ondemand", "3")
        for name, public in (("a", "Y"), ("b", "N")):
            await store.hset(f"service:{name}",
                             {"api_key": "x", "precache": "2", "ondemand": "1", "public": public})
            await store.sadd("services", name)
        return await P.services.stats(store, P.services.build_parser().parse_args(["stats"]))

    return run(seed())


def test_services_stats_aggregation(capsys):
    assert _stats_seed(PORT) == 0
    out = capsys.readouterr().out
    assert _stats_seed(REF) == 0
    assert capsys.readouterr().out == out
    stats = json.loads(out)
    assert stats["work"] == {"precache": 7, "ondemand": 3}
    assert stats["services"]["a"]["public"] is True
    assert stats["services"]["b"]["ondemand"] == 1


def test_open_store_checkpoint_roundtrip(tmp_path):
    path = str(tmp_path / "state.json")

    async def flow():
        async with open_store(path) as store:
            await store.set("k", "v")
        async with open_store(path) as store:
            assert await store.get("k") == "v"
        # the reference's scripts read the port's checkpoint unchanged
        async with jscripts.open_store(path) as store:
            assert await store.get("k") == "v"

    run(flow())


# ---------------------------------------------------------- client_snapshot


async def _seed_clients(store):
    # busy client: 80 new works since last snapshot
    await store.sadd("clients", VALID_ACCOUNT)
    await store.hset(f"client:{VALID_ACCOUNT}",
                     {"precache": "100", "ondemand": "30", "snapshot_precache": "50",
                      "snapshot_ondemand": "0"})
    # idle client: below the 50-work threshold (reference :47)
    lazy = nc.encode_account(bytes(32))
    await store.sadd("clients", lazy)
    await store.hset(f"client:{lazy}", {"precache": "10", "ondemand": "0"})
    # junk address: skipped (reference :28-32)
    await store.sadd("clients", "not_an_address")
    await store.hset("client:not_an_address", {"ondemand": "1000"})


async def _snapshot_flow(P, out_dir, steps) -> list:
    """``steps``: keyword sets for successive ``snapshot`` calls on one seeded
    store; each result with its files' contents, then the store."""
    store = P.MemoryStore()
    await _seed_clients(store)
    seen = []
    for kw in steps:
        os.makedirs(out_dir, exist_ok=True)
        result = await P.cs.snapshot(store, out_dir=out_dir, **kw)
        files = {}
        for key in ("payouts_file", "snapshot_file"):
            if not result["dry_run"]:
                with open(result[key]) as f:
                    files[key] = json.load(f)
            result[key] = os.path.basename(result[key])
        seen.append((result, files))
    seen.append(contents(store))
    return seen


def _both_snapshot_flows(tmp_path, pinned, steps) -> list:
    got = run(_snapshot_flow(PORT, str(tmp_path / "port"), steps))
    pinned()
    want = run(_snapshot_flow(REF, str(tmp_path / "ref"), steps))
    assert got == want
    return got


def test_snapshot_thresholds_and_advance(tmp_path, pinned):
    (first, files), (second, _), _store = _both_snapshot_flows(tmp_path, pinned, [{}, {}])
    assert first["clients_eligible"] == 1
    assert first["total_works"] == 80
    payouts_data = files["payouts_file"]
    assert set(payouts_data) == {VALID_ACCOUNT}
    assert payouts_data[VALID_ACCOUNT]["works"] == 80
    assert "uuid" in payouts_data[VALID_ACCOUNT]
    # snapshot fields advanced: immediate re-run finds nothing new
    assert second["clients_eligible"] == 0


def test_snapshot_dry_run_does_not_advance(tmp_path, pinned):
    (dry, _), (real, _), _store = _both_snapshot_flows(
        tmp_path, pinned, [{"dry_run": True}, {}])
    assert dry["clients_eligible"] == 1
    assert real["clients_eligible"] == 1  # nothing was consumed


def test_snapshot_exclude(tmp_path, pinned):
    (result, _), _store = _both_snapshot_flows(
        tmp_path, pinned, [{"exclude": frozenset({VALID_ACCOUNT})}])
    assert result["clients_eligible"] == 0


# ----------------------------------------------------------------- payouts


def test_plan_payouts_proportional():
    table = {"a": {"works": 75, "uuid": "u1"}, "b": {"works": 25, "uuid": "u2"}}
    plan = payouts.plan_payouts(table, balance_raw=1000, fraction=0.5)
    assert plan == {"a": 375, "b": 125} == jpayouts.plan_payouts(table, 1000, 0.5)


def test_plan_payouts_zero_works():
    for table in ({}, {"a": {"works": 0, "uuid": "u"}}):
        assert payouts.plan_payouts(table, 1000, 1.0) == {} == jpayouts.plan_payouts(
            table, 1000, 1.0)


def test_plan_payouts_floors_dust():
    table = {"a": {"works": 1, "uuid": "u1"}, "b": {"works": 10**6, "uuid": "u2"}}
    plan = payouts.plan_payouts(table, balance_raw=10, fraction=1.0)
    assert "a" not in plan  # sub-raw share floored away
    assert plan == jpayouts.plan_payouts(table, 10, 1.0)


# ------------------------------------------------------------ check_latency


async def _probe_flow(P):
    broker = P.Broker()  # default users incl. dpowinterface observer
    observer = P.InProcTransport(broker, username="dpowinterface", password="dpowinterface")
    probe = P.cl.LatencyProbe(observer, quiet=True)
    server = P.InProcTransport(broker, username="dpowserver", password="dpowserver")
    client = P.InProcTransport(broker, username="client", password="client")
    await server.connect()
    await client.connect()
    runner = asyncio.ensure_future(probe.run())
    await asyncio.sleep(0.05)
    h1, h2 = "A" * 64, "B" * 64
    await server.publish("work/ondemand", f"{h1},ffffffc000000000")
    await server.publish("work/ondemand", f"{h2},ffffffc000000000")
    await asyncio.sleep(0.02)
    await client.publish("result/ondemand", f"{h1},deadbeef00000000,nano_xyz")
    await server.publish("cancel/ondemand", h2)
    await asyncio.sleep(0.05)
    runner.cancel()
    await asyncio.gather(runner, return_exceptions=True)
    for t in (observer, server, client):
        await t.close()
    return probe


def test_latency_probe_times_work_result_cancel():
    probe = run(_probe_flow(PORT))
    ref = run(_probe_flow(REF))
    assert len(probe.result_deltas) == 1
    assert len(probe.cancel_deltas) == 1
    summary, ref_summary = probe.summary(), ref.summary()
    assert summary["results"] == 1
    assert {k: summary[k] for k in ("results", "cancels")} == {
        k: ref_summary[k] for k in ("results", "cancels")}


@pytest.mark.parametrize("scheme", ["mqtt", "tcp"])
def test_latency_probe_over_mqtt_wire(scheme):
    """The probe's entry point observes the swarm over the port's broker as
    the dashboard user, the credentials merged into a URI given without
    them, over real MQTT (reference parity: its probe is a paho client) and
    over the JSON-lines TCP wire; every ACL grant it needs is the
    reference's."""

    async def flow():
        broker = Broker(users=default_users())
        srv = TcpBrokerServer(broker, port=0)
        await srv.start()
        server = InProcTransport(broker, username="dpowserver", password="dpowserver")
        client = InProcTransport(broker, username="client", password="client")
        await server.connect()
        await client.connect()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            probe = asyncio.ensure_future(cl.amain(
                ["--uri", f"{scheme}://127.0.0.1:{srv.port}", "--duration", "1.0", "--quiet"]))
            await asyncio.sleep(0.4)
            h1, h2 = "C" * 64, "D" * 64
            await server.publish("work/ondemand", f"{h1},ffffffc000000000")
            await server.publish("work/ondemand", f"{h2},ffffffc000000000")
            await asyncio.sleep(0.05)
            await client.publish("result/ondemand", f"{h1},deadbeef00000000,{VALID_ACCOUNT}")
            await server.publish("cancel/ondemand", h2)
            assert await asyncio.wait_for(probe, 10) == 0
        await server.close()
        await client.close()
        await srv.stop()
        return json.loads(out.getvalue().strip().splitlines()[-1])

    summary = run(flow())
    assert (summary["results"], summary["cancels"]) == (1, 1)


def _histogram_page(P) -> str:
    reg = P.Registry()
    reg.counter("dpow_server_requests_total", "", ("work_type",)).inc(3, "ondemand")
    lat = reg.histogram("dpow_server_request_seconds", "", ("work_type",))
    for v in (0.010, 0.020, 0.030):
        lat.observe(v, "ondemand")
    stage = reg.histogram("dpow_request_stage_seconds", "", ("stage",))
    for s in ("queue", "publish", "device"):
        stage.observe(0.004, s)
    return P.obs.render(reg)


def test_check_latency_from_metrics_summarizes_histograms():
    page = _histogram_page(PORT)
    assert page == _histogram_page(REF)
    summary = cl.summarize_metrics(page)
    assert summary == jcl.summarize_metrics(page)
    assert summary["requests_total"] == {"ondemand": 3}
    ond = summary["request_latency"]["ondemand"]
    assert ond["count"] == 3
    # p50 of three obs in the (15.6, 31.2] ms log2 bucket: inside that band
    assert 10 <= ond["p50_ms"] <= 32
    assert set(summary["stage_p50_ms"]) == {"queue", "publish", "device"}
    assert all(1 <= v <= 8 for v in summary["stage_p50_ms"].values())


def test_check_latency_from_metrics_end_to_end_http():
    """The flag scrapes a live /metrics endpoint of the port over HTTP."""
    from aiohttp import web

    async def flow():
        reg = Registry()
        reg.counter("dpow_server_requests_total", "", ("work_type",)).inc(1, "precache")
        app = web.Application()
        obs.add_metrics_route(app, reg)
        runner = web.AppRunner(app)
        await runner.setup()
        site = web.TCPSite(runner, "127.0.0.1", 0)
        await site.start()
        port = site._server.sockets[0].getsockname()[1]
        url = f"http://127.0.0.1:{port}/metrics"
        try:
            outs = []
            for amain in (cl.amain, jcl.amain):
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    assert await amain(["--from-metrics", url]) == 0
                outs.append(json.loads(buf.getvalue().strip().splitlines()[-1]))
            return outs
        finally:
            await runner.cleanup()

    out, ref = run(flow())
    assert out == ref
    assert out["source"] == "metrics"
    assert out["requests_total"] == {"precache": 1}


class _Brute(WorkBackend):
    async def setup(self):
        pass

    async def generate(self, request):
        h = bytes.fromhex(request.block_hash)
        w = next(w for w in itertools.count() if nc.work_value_int(h, w) >= request.difficulty)
        return f"{w:016x}"

    async def cancel(self, block_hash):
        pass


def test_from_metrics_reads_the_port_hubs_page():
    """Both packages' summaries of a page the port's hub rendered after
    serving requests agree, and count what it served."""

    async def flow():
        obs.reset()
        broker = Broker()
        server = DpowServer(
            ServerConfig(base_difficulty=EASY, throttle=1000.0, heartbeat_interval=0.05,
                         statistics_interval=3600.0),
            MemoryStore(), InProcTransport(broker, client_id="server"))
        await server.setup()
        server.start_loops()
        await server.store.hset("service:svc", {"api_key": hash_key("k"), "public": "N",
                                                "precache": "0", "ondemand": "0"})
        await server.store.sadd("services", "svc")
        client = DpowClient(ClientConfig(payout_address=VALID_ACCOUNT, startup_heartbeat_wait=3.0),
                            InProcTransport(broker, client_id="worker"), backend=_Brute())
        await client.setup()
        client.start_loops()
        try:
            for i in range(3):
                resp = await asyncio.wait_for(server.service_handler(
                    {"user": "svc", "api_key": "k", "hash": f"{i + 7:064X}", "timeout": 10}), 15)
                nc.validate_work(resp["hash"], resp["work"], EASY)
        finally:
            await client.close()
            await server.close()
        return obs.render()

    page = run(flow())
    summary = cl.summarize_metrics(page)
    assert summary == jcl.summarize_metrics(page)
    assert summary["requests_total"] == {"ondemand": 3}
    assert summary["request_latency"]["ondemand"]["count"] == 3
    assert {"queue", "publish", "winner"} <= set(summary["stage_p50_ms"])


# ------------------------------------------------------------ sqlite and reruns


def test_services_cli_on_sqlite_store(tmp_path, capsys):
    """The admin CLI operates on the server's live sqlite database — the
    reference's equivalent is redis-cli access to the shared Redis."""
    outs, tables = [], []
    for P in (PORT, REF):
        path = tmp_path / f"{'port' if P is PORT else 'ref'}.db"
        db = f"sqlite://{path}"
        rcs = [
            P.services.main(["add", "--store", db, "--user", "acme", "--api_key", "sekrit",
                             "--display", "Acme", "--private"]),
            P.services.main(["check", "--store", db, "--user", "acme"]),
            P.services.main(["check", "--store", db, "--user", "nobody"]),
        ]
        assert rcs[:2] == [0, 0] and rcs[2] != 0
        outs.append((rcs, capsys.readouterr()))

        async def inspect(path=path):
            # the other package's store reads the database the CLI wrote
            Other = REF if P is PORT else PORT
            s = Other.SqliteStore(str(path))
            await s.setup()
            members, record = await s.smembers("services"), await s.hgetall("service:acme")
            await s.close()
            return members, record

        tables.append(run(inspect()))
    assert outs[0] == outs[1] and tables[0] == tables[1]
    members, record = tables[0]
    assert members == {"acme"} and record["display"] == "Acme"


async def _uuid_windows(P, tmp_path) -> list:
    store = P.MemoryStore()
    await _seed_clients(store)
    real_hset = store.hset

    async def crashing_hset(key, mapping):
        if any(k.startswith("snapshot_") for k in mapping):
            raise RuntimeError("crash before advance")
        return await real_hset(key, mapping)

    # run 1 crashes AFTER writing the payout file, BEFORE advancing the counters
    store.hset = crashing_hset
    with pytest.raises(RuntimeError):
        await P.cs.snapshot(store, out_dir=str(tmp_path / "a"))
    store.hset = real_hset
    (payouts_a,) = (tmp_path / "a").glob("payouts_*.json")
    u1 = json.load(open(payouts_a))[VALID_ACCOUNT]["uuid"]
    # +50 more works land between the crash and the rerun
    await store.hset(f"client:{VALID_ACCOUNT}", {"precache": "150", "ondemand": "30"})
    r2 = await P.cs.snapshot(store, out_dir=str(tmp_path / "b"))
    u2 = json.load(open(r2["payouts_file"]))[VALID_ACCOUNT]["uuid"]
    # window 3 after a counter reset back to the SAME base values
    await store.hset(f"client:{VALID_ACCOUNT}",
                     {"precache": "100", "ondemand": "30", "snapshot_precache": "50",
                      "snapshot_ondemand": "0"})
    r3 = await P.cs.snapshot(store, out_dir=str(tmp_path / "c"))
    u3 = json.load(open(r3["payouts_file"]))[VALID_ACCOUNT]["uuid"]
    return [u1, u2, u3, contents(store)]


def test_snapshot_uuid_stable_across_crash_rerun_unique_across_windows(tmp_path, pinned):
    """The send id survives a crashed run's rerun unchanged (paying both
    files can't double-pay) and differs across distinct payout windows even
    when the counters return to identical values — and it is the
    reference's id for the same store history."""
    for name in ("port", "ref"):
        for sub in "abc":
            (tmp_path / name / sub).mkdir(parents=True)
    got = run(_uuid_windows(PORT, tmp_path / "port"))
    pinned()
    want = run(_uuid_windows(REF, tmp_path / "ref"))
    assert got == want
    u1, u2, u3, _store = got
    assert u1 == u2  # crash-rerun shares the send id
    assert u3 != u1  # fresh window, fresh send id


# ---------------------------------------------------------------- payouts e2e


def test_payouts_main_against_fake_node(tmp_path, monkeypatch, capsys):
    """Full payouts CLI flow against a fake node RPC: balance fetch,
    confirmation gate, idempotent send ids (the snapshot's uuid is the node
    'id'), and the dry-run short-circuit — identical sends and output from
    both packages."""
    sends = []

    class FakeNode(http.server.BaseHTTPRequestHandler):
        def do_POST(self):
            body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
            if body["action"] == "account_balance":
                reply = {"balance": str(10**30), "pending": "0"}
            elif body["action"] == "send":
                sends.append(body)
                reply = {"block": "B" * 64}
            else:
                reply = {"error": f"unknown action {body['action']}"}
            data = json.dumps(reply).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def log_message(self, *a):
            pass

    srv = http.server.HTTPServer(("127.0.0.1", 0), FakeNode)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        node_uri = f"http://127.0.0.1:{srv.server_port}/"
        addr2 = nc.encode_account(bytes([7] * 32))
        pf = tmp_path / "payouts_1.json"
        pf.write_text(json.dumps({VALID_ACCOUNT: {"works": 75, "uuid": "uuid-a"},
                                  addr2: {"works": 25, "uuid": "uuid-b"}}))
        base_args = [str(pf), "--node", node_uri, "--wallet", "W" * 64, "--source",
                     VALID_ACCOUNT]
        seen = []
        for P in (PORT, REF):
            sends.clear()
            # dry run: prints the plan, never sends
            assert P.payouts.main(base_args + ["--dry_run"]) == 0
            assert sends == []
            dry = capsys.readouterr().out
            assert "distributing" in dry and "75 works" in dry
            # wrong confirmation phrase aborts
            monkeypatch.setattr("builtins.input", lambda *_: "no")
            assert P.payouts.main(base_args) == 1
            assert sends == []
            # confirmed: sends carry the snapshot uuids as idempotency keys
            monkeypatch.setattr("builtins.input", lambda *_, P=P: P.payouts.CONFIRM_PHRASE)
            assert P.payouts.main(base_args) == 0
            assert {s["id"] for s in sends} == {"uuid-a", "uuid-b"}
            assert all(s["source"] == VALID_ACCOUNT and s["action"] == "send" for s in sends)
            by_id = {s["id"]: int(s["amount"]) for s in sends}
            assert by_id["uuid-a"] == 3 * by_id["uuid-b"]  # 75 vs 25 works
            seen.append((dry, capsys.readouterr().out, list(sends)))
        assert seen[0] == seen[1]
    finally:
        srv.shutdown()


# ------------------------------------------------------------- entry points


def test_scripts_run_as_modules_and_leave_the_references_store(tmp_path):
    """``python -m tpu_dpow_torch.scripts.<name>`` on a checkpoint: the
    same arguments leave the same store as tpu_dpow's scripts do."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    outs = []
    for pkg in ("tpu_dpow_torch", "tpu_dpow"):
        ckpt = str(tmp_path / f"{pkg}.json")
        argvs = [
            ["services", "add", "--store", ckpt, "--user", "demo", "--api_key", "k",
             "--public"],
            ["services", "stats", "--store", ckpt],
            ["client_snapshot", "--store", ckpt, "--dry_run", "--out_dir", str(tmp_path)],
            ["payouts", "--help"],
            ["check_latency", "--help"],
        ]
        for argv in argvs:
            out = subprocess.run([sys.executable, "-m", f"{pkg}.scripts.{argv[0]}", *argv[1:]],
                                 cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
            assert out.returncode == 0, (argv, out.stderr)
            outs.append((argv[0], out.stdout.replace(ckpt, "CKPT")))
        with open(ckpt) as f:
            outs.append(("store", json.load(f)))
    half = len(outs) // 2
    port, ref = outs[:half], outs[half:]
    for (name, a), (_n, b) in zip(port, ref):
        if name in ("services", "store"):
            assert a == b, name
    assert json.loads(port[1][1])["services"] == {
        "demo": {"precache": 0, "ondemand": 0, "public": True}}
