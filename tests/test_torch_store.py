"""The port's store layer (store/: MemoryStore, SqliteStore, RedisStore,
DegradedStore, get_store) held against tpu_dpow's, differentially.

The same numpy-seeded script of store operations runs through both
packages' stores and the transcripts (every return value, every raised
error's type) must be equal. Then the state carried across: a checkpoint
written by one package's ``MemoryStore.save`` and a database written by
one package's ``SqliteStore`` are read, unchanged, by the other, in both
directions, and the other package's DpowServer serves a service request
from them. RedisStore runs on tests/fake_redis.py, as tests/test_store.py
does (the ``redis`` package is not installed).
"""

import asyncio
import hashlib
import importlib
import os
import struct
import time

import numpy as np
import pytest

from fake_redis import FakeRedis

PKGS = ("tpu_dpow", "tpu_dpow_torch")
DIRECTIONS = [PKGS, PKGS[::-1]]
KINDS = ("memory", "sqlite", "redis", "degraded")
EASY = 0xF000000000000000
KEYS = ("account:a", "block:b", "service:s", "client:c", "stats:ondemand",
        "services", "k1", "k2")


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, timeout=30))


class Now:
    """One scripted clock for every store of a run: MemoryStore and
    FakeRedis read it, SqliteStore reads it through ``time.time``."""

    def __init__(self):
        self.t = 1_000.0

    def __call__(self) -> float:
        return self.t


def make_store(pkg: str, kind: str, path, now: Now):
    store = mod(pkg, "store")
    if kind == "memory":
        return store.MemoryStore(clock=now)
    if kind == "sqlite":
        return mod(pkg, "store.sqlite_store").SqliteStore(str(path))
    if kind == "redis":
        return mod(pkg, "store.redis_store").RedisStore(
            "redis://twin", client=FakeRedis(clock=now))
    chaos = mod(pkg, "chaos")
    # The 11th to 13th operations fail as connection errors: the
    # wrapper enters degraded mode, journals, and reconciles on a probe.
    schedule = chaos.FaultSchedule([chaos.Rule(op="*", action=chaos.ERROR,
                                               times=3, after=10)])
    clock = chaos.FakeClock()
    faulty = chaos.FaultyStore(store.MemoryStore(clock=now), schedule, clock=clock)
    return store.DegradedStore(faulty, clock=clock, probe_interval=1.0)


def op_script(seed: int, n: int = 160) -> list:
    """A seeded sequence of (op, args) over a small key set, including TTLs,
    clock advances and kind mismatches."""
    rng = np.random.default_rng(seed)
    ops = []
    names = ("get", "set", "setnx", "getset", "delete", "exists", "incrby",
             "hset", "hget", "hgetall", "hincrby", "sadd", "srem", "smembers",
             "keys", "advance")
    for _ in range(n):
        name = names[int(rng.integers(len(names)))]
        key = KEYS[int(rng.integers(len(KEYS)))]
        val = str(int(rng.integers(0, 50)))
        expire = [None, None, 2.0, 5.0][int(rng.integers(4))]
        field = f"f{int(rng.integers(3))}"
        args = {
            "get": (key,), "set": (key, val, expire), "setnx": (key, val, expire),
            "getset": (key, val, expire), "delete": (key, KEYS[int(rng.integers(len(KEYS)))]),
            "exists": (key,), "incrby": (key, int(rng.integers(-3, 9))),
            "hset": (key, {field: val}), "hget": (key, field), "hgetall": (key,),
            "hincrby": (key, field, int(rng.integers(1, 4))),
            "sadd": (key, val, str(int(rng.integers(0, 50)))), "srem": (key, val),
            "smembers": (key,), "keys": (["*", "block:*", "s*", "k?"][int(rng.integers(4))],),
            "advance": (float(rng.choice([0.5, 1.5, 3.0])),),
        }[name]
        ops.append((name, args))
    return ops


def _norm(value):
    if isinstance(value, set):
        return ("set", sorted(value))
    if isinstance(value, list):
        return ("list", sorted(value))
    return value


async def replay(store, ops, now: Now, clock=None) -> list:
    out = []
    for name, args in ops:
        if name == "advance":
            now.t += args[0]
            if clock is not None:
                await clock.advance(args[0])
            out.append(("advance", now.t))
            continue
        try:
            out.append((name, _norm(await getattr(store, name)(*args))))
        except TypeError as e:  # a kind mismatch: the same type on both sides
            out.append((name, "TypeError", "WRONGTYPE" in str(e) or "kind" in str(e)))
        except ValueError:  # incrby on a non-integer value
            out.append((name, "ValueError"))
    return out


async def _transcript(pkg, kind, tmp_path, ops, monkeypatch) -> list:
    now = Now()
    monkeypatch.setattr(time, "time", now)
    store = make_store(pkg, kind, tmp_path / f"{pkg}.db", now)
    await store.setup()
    clock = getattr(store, "clock", None)
    try:
        out = await replay(store, ops, now, clock)
        if kind == "degraded":
            # let the last probe reconcile, then read the primary back
            now.t += 2.0
            await clock.advance(2.0)
            await store.exists("k1")
            out.append(("degraded", store.degraded, len(store._journal)))
            out.append(("primary", store.primary.inner.snapshot()))
        return out
    finally:
        await store.close()


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("kind", KINDS)
def test_store_script_is_identical_across_packages(kind, seed, tmp_path, monkeypatch):
    ops = op_script(seed)
    got = {pkg: run(_transcript(pkg, kind, tmp_path, ops, monkeypatch)) for pkg in PKGS}
    assert got["tpu_dpow"] == got["tpu_dpow_torch"]
    assert len(got["tpu_dpow"]) >= len(ops)


def test_degraded_store_enters_journals_and_reconciles_alike(tmp_path, monkeypatch):
    """The degraded script really degrades: both packages enter degraded
    mode, journal, and drain to the same primary state."""
    ops = op_script(4, n=60)
    out = {}
    for pkg in PKGS:
        mod(pkg, "obs").reset()
        out[pkg] = run(_transcript(pkg, "degraded", tmp_path, ops, monkeypatch))
        snap = mod(pkg, "obs").snapshot()
        out[pkg].append(snap["dpow_store_degraded_transitions_total"])
    assert out["tpu_dpow"] == out["tpu_dpow_torch"]
    assert out["tpu_dpow"][-1]["series"], "the script never entered degraded mode"


@pytest.mark.parametrize("uri", ["memory", None, "sqlite://{tmp}/f.db",
                                 "degraded+memory", "redis://h:6379", "bogus://x"])
def test_get_store_factory_matches(uri, tmp_path):
    def kind(pkg):
        u = uri.format(tmp=tmp_path) if uri else uri
        try:
            s = mod(pkg, "store").get_store(u)
        except ValueError as e:
            return ("ValueError", str(e))
        inner = getattr(s, "primary", None)
        return (type(s).__name__, type(inner).__name__ if inner else None,
                getattr(s, "path", None))

    assert kind("tpu_dpow") == kind("tpu_dpow_torch")


async def _seed_state(pkg, store, now: Now) -> None:
    hash_key = mod(pkg, "utils").hash_key
    await store.hset("service:svc", {"api_key": hash_key("secret"), "public": "Y",
                                     "display": "svc", "website": "",
                                     "precache": "3", "ondemand": "5"})
    await store.sadd("services", "svc", "other")
    await store.set("account:nano_acct", "AB" * 32)
    await store.set("block:" + "CD" * 32, "00000000000000ff", expire=600.0)
    await store.hincrby("client:nano_payout", "ondemand", 7)
    await store.sadd("clients", "nano_payout")
    await store.incrby("stats:ondemand", 5)
    await store.set("expired:soon", "x", expire=1.0)
    now.t += 2.0


def test_hash_key_digest_is_identical():
    for key in ("secret", "", "ünïcode-key", "a" * 300):
        assert mod("tpu_dpow", "utils").hash_key(key) == mod("tpu_dpow_torch", "utils").hash_key(key)


def test_snapshot_restore_twin_preserves_ttl():
    def snap(pkg):
        now = Now()
        s = mod(pkg, "store").MemoryStore(clock=now)
        run(_seed_state(pkg, s, now))
        blob = s.snapshot()
        t = mod(pkg, "store").MemoryStore(clock=now)
        run(t.set("stale", "1"))
        t.restore(blob)  # replace, not merge
        return blob, t.snapshot(), run(t.keys())

    a, b = snap("tpu_dpow"), snap("tpu_dpow_torch")
    assert a == b
    assert "stale" not in a[2] and "expired:soon" not in a[2]


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_checkpoint_written_by_one_is_read_by_the_other(writer, reader, tmp_path):
    path = str(tmp_path / "dpow_state.json")
    now = Now()
    w = mod(writer, "store").MemoryStore(clock=now)
    run(_seed_state(writer, w, now))
    w.save(path)
    r = mod(reader, "store").MemoryStore(clock=now)
    r.load(path)
    assert r.snapshot() == w.snapshot()
    assert not os.path.exists(path + ".tmp")


async def _dump(store) -> dict:
    out = {}
    for key in sorted(await store.keys("*")):
        for read in (store.get, store.hgetall, store.smembers):
            try:
                out[key] = _norm(await read(key))
                break
            except TypeError:
                continue
    return out


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_sqlite_written_by_one_is_read_by_the_other(writer, reader, tmp_path, monkeypatch):
    path = str(tmp_path / "shared.db")
    now = Now()
    monkeypatch.setattr(time, "time", now)

    async def main():
        w = mod(writer, "store").get_store(f"sqlite://{path}")
        await w.setup()
        await _seed_state(writer, w, now)
        before = await _dump(w)
        await w.close()
        r = mod(reader, "store").get_store(f"sqlite://{path}")
        await r.setup()
        after = await _dump(r)
        # the reader writes on; the writer reads the reader's writes back
        await r.hincrby("client:nano_payout", "ondemand", 1)
        await r.close()
        w2 = mod(writer, "store").get_store(f"sqlite://{path}")
        await w2.setup()
        back = await w2.hget("client:nano_payout", "ondemand")
        await w2.close()
        return before, after, back

    before, after, back = run(main())
    assert before == after
    assert set(before) >= {"account:nano_acct", "service:svc", "services", "clients",
                           "client:nano_payout", "stats:ondemand", "block:" + "CD" * 32}
    assert "expired:soon" not in after
    assert back == "8"


def _solve(block_hash: str, difficulty: int) -> str:
    h = bytes.fromhex(block_hash)
    w = 0
    while True:
        v = int.from_bytes(hashlib.blake2b(struct.pack("<Q", w) + h, digest_size=8).digest(),
                           "little")
        if v >= difficulty:
            return f"{w:016x}"
        w += 1


@pytest.mark.parametrize("medium", ["checkpoint", "sqlite"])
@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_state_written_by_one_is_served_by_the_others_hub(writer, reader, medium, tmp_path):
    """An operator switches the hub: the other package's DpowServer
    authenticates the carried service and serves the carried work, and
    counts the request into the carried counters."""
    h = np.random.default_rng(5).bytes(32).hex().upper()
    work = _solve(h, EASY)

    async def main():
        if medium == "checkpoint":
            w = mod(writer, "store").MemoryStore()
        else:
            w = mod(writer, "store").get_store(f"sqlite://{tmp_path}/hub.db")
        await w.setup()
        await _seed_state(writer, w, Now())
        await w.set(f"block:{h}", work)
        if medium == "checkpoint":
            w.save(str(tmp_path / "hub.json"))
            r = mod(reader, "store").MemoryStore()
            r.load(str(tmp_path / "hub.json"))
        else:
            await w.close()
            r = mod(reader, "store").get_store(f"sqlite://{tmp_path}/hub.db")
        await r.setup()
        server_mod = mod(reader, "server")
        transport = mod(reader, "transport.inproc").InProcTransport(
            mod(reader, "transport.broker").Broker(), client_id="server")
        config = server_mod.ServerConfig(base_difficulty=EASY, throttle=1000.0,
                                         heartbeat_interval=3600.0,
                                         statistics_interval=3600.0)
        server = server_mod.DpowServer(config, r, transport)
        await server.setup()
        try:
            resp = await server.service_handler(
                {"user": "svc", "api_key": "secret", "hash": h})
            with pytest.raises(server_mod.InvalidRequest, match="Invalid credentials"):
                await server.service_handler({"user": "svc", "api_key": "nope", "hash": h})
            await asyncio.sleep(0.01)  # the spawned service counter
            counter = await r.hget("service:svc", "precache")
        finally:
            await server.close()
            await r.close()
        return resp, counter

    resp, counter = run(main())
    assert resp == {"work": work, "hash": h}
    assert counter == "4"


@pytest.mark.parametrize("pkg", PKGS)
def test_save_is_atomic_against_a_failed_write(pkg, tmp_path, monkeypatch):
    """Twin of test_store.py's crash-mid-write test: a failing fsync leaves
    the previous checkpoint whole, in both packages."""
    store = mod(pkg, "store")
    path = str(tmp_path / "ckpt.json")
    s = store.MemoryStore()
    run(s.set("a", "1"))
    s.save(path)
    run(s.set("a", "2"))

    def boom(fd):
        raise OSError("disk full")

    monkeypatch.setattr(os, "fsync", boom)
    with pytest.raises(OSError):
        s.save(path)
    monkeypatch.undo()
    t = store.MemoryStore()
    t.load(path)
    assert run(t.get("a")) == "1"
