"""The port's replica layer (replica/: ring, fence, registry, coordinator)
held against tpu_dpow's, differentially — twins of tests/test_replica.py's
unit tests, then a mixed ring.

``owner_of`` must hash identically for 10^4 seeded hashes over several
member sets, or a ring that mixes a JAX replica and a port replica would
disagree on who owns a hash. The membership and fence scripts give the
same epochs, liveness, fencing and store records in both packages. Last,
a tpu_dpow replica and a tpu_dpow_torch replica share one TCP broker and
one sqlite store: both agree on ownership, and each serves the request the
other forwards to it.
"""

import asyncio
import hashlib
import importlib
import struct
import time

import numpy as np
import pytest

PKGS = ("tpu_dpow", "tpu_dpow_torch")
EASY = 0xFF00000000000000


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def run(coro, timeout=30):
    return asyncio.run(asyncio.wait_for(coro, timeout=timeout))


def both(fn, *args):
    out = {pkg: fn(pkg, *args) for pkg in PKGS}
    assert out["tpu_dpow"] == out["tpu_dpow_torch"]
    return out["tpu_dpow"]


def seeded_hashes(n: int, seed: int = 9) -> list:
    rng = np.random.default_rng(seed)
    return [rng.bytes(32).hex().upper() for _ in range(n)]


MEMBER_SETS = [("ra",), ("ra", "rb"), ("r1", "r2", "r3"), ("server-a", "b", "c", "d", "e")]


@pytest.mark.parametrize("members", MEMBER_SETS, ids=lambda m: f"{len(m)}m")
def test_owner_of_is_identical_for_ten_thousand_hashes(members):
    hashes = seeded_hashes(10_000)
    a = [mod("tpu_dpow", "replica").owner_of(h, members) for h in hashes]
    b = [mod("tpu_dpow_torch", "replica").owner_of(h, members) for h in hashes]
    assert a == b
    ring_a = mod("tpu_dpow", "replica").HashRing(members, epoch=3)
    ring_b = mod("tpu_dpow_torch", "replica").HashRing(members, epoch=3)
    assert ring_a.slice_counts(hashes[:2000]) == ring_b.slice_counts(hashes[:2000])
    assert ring_a.members == ring_b.members and repr(ring_a) == repr(ring_b)
    smaller = members[:-1]
    assert (ring_a.moved(mod("tpu_dpow", "replica").HashRing(smaller), hashes[:2000])
            == ring_b.moved(mod("tpu_dpow_torch", "replica").HashRing(smaller), hashes[:2000]))


def test_owner_of_empty_and_score_match():
    for pkg in PKGS:
        assert mod(pkg, "replica").owner_of("AB" * 32, []) is None
    for h in seeded_hashes(50, seed=1):
        assert (mod("tpu_dpow", "replica.ring")._score("r1", h)
                == mod("tpu_dpow_torch", "replica.ring")._score("r1", h))


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


def test_registry_heartbeat_staleness_and_rejoin_match(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1.7e9)

    def script(pkg):
        rep = mod(pkg, "replica")
        fence = mod(pkg, "replica.fence")

        async def main():
            mod(pkg, "obs").reset()
            clock = mod(pkg, "resilience").FakeClock()
            store = mod(pkg, "store").MemoryStore()
            a = rep.ReplicaRegistry(store, "ra", clock=clock, ttl=2.0)
            b = rep.ReplicaRegistry(store, "rb", clock=clock, ttl=2.0)
            out = [await a.join(), await b.join()]
            await a.observe()
            out += [a.live_members(), a.ring().epoch]
            await clock.advance(1.5)
            out.append(await b.heartbeat())
            await a.observe()
            out += [a.is_live("rb"), [v.replica_id for v in a.stale_peers()]]
            await clock.advance(2.5)
            await a.observe()
            out += [a.is_live("rb"), [v.replica_id for v in a.stale_peers()]]
            await fence.retire_member(store, "rb", b.epoch)
            await a.observe()
            out += [a.live_members(), await b.heartbeat(), b.fenced]
            out += [await b.join(), b.fenced, await b.heartbeat()]
            await a.observe()
            out += [a.live_members(), await _dump(store)]
            snap = mod(pkg, "obs").snapshot()
            out.append({k: v["series"] for k, v in sorted(snap.items())
                        if k.startswith("dpow_replica_") and v["series"]})
            return out

        return run(main())

    out = both(script)
    assert out[0] == 1 and out[1] == 2


def test_fence_refuses_zombie_writes_and_elects_one_adopter_alike():
    def script(pkg):
        fence = mod(pkg, "replica.fence")
        StaleEpoch = mod(pkg, "replica").StaleEpoch

        async def main():
            mod(pkg, "obs").reset()
            store = mod(pkg, "store").MemoryStore()
            epoch = await fence.allocate_epoch(store)
            w = fence.FencedWriter(store, "rx", epoch)
            await w.journal_dispatch("AB" * 32, {"difficulty": 1})
            out = [epoch, await fence.read_dispatches(store, "rx")]
            out.append(await fence.raise_fence(store, "rx", epoch + 1))
            out.append(await fence.raise_fence(store, "rx", epoch))
            for op in (w.write_member(1, 0.0), w.journal_dispatch("CD" * 32, {}),
                       w.forget_dispatch("AB" * 32), w.delete_member()):
                try:
                    await op
                    out.append("written")
                except StaleEpoch:
                    out.append("fenced")
            out.append(await fence.read_dispatches(store, "rx"))
            out.append([await fence.claim_adoption(store, "rx", epoch, expire=30.0)
                        for _ in range(3)])
            out.append(await fence.claim_adoption(store, "rx", epoch + 7, expire=30.0))
            out.append(await _dump(store))
            out.append(mod(pkg, "obs").snapshot()["dpow_replica_fenced_total"]["series"])
            return out

        return run(main())

    out = both(script)
    assert out[4:8] == ["fenced"] * 4


@pytest.mark.parametrize("record", [
    {"deadline": 60.0, "remaining": 15.0, "wall": 1.7e9},
    {"deadline": 0.5, "remaining": 0.01, "wall": 1.7e9},
    {"deadline": 1.0, "remaining": 5.0, "wall": 1.7e9 - 60.0},
    {"deadline": "x"},
    {},
])
def test_adopted_deadline_matches(record, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1.7e9)
    both(lambda pkg: mod(pkg, "replica").ReplicaCoordinator.adopted_deadline(record, 50.0))


def test_dispatch_topic_and_result_lane_match():
    for rid in ("ra", "server-r2"):
        assert (mod("tpu_dpow", "replica").dispatch_topic(rid)
                == mod("tpu_dpow_torch", "replica").dispatch_topic(rid))
        for wt in ("ondemand", "precache"):
            assert (mod("tpu_dpow", "replica").result_lane(rid, wt)
                    == mod("tpu_dpow_torch", "replica").result_lane(rid, wt))


# -- a mixed ring: one JAX replica, one port replica --------------------------


def solve(block_hash: str, difficulty: int) -> str:
    h = bytes.fromhex(block_hash)
    w = 0
    while True:
        v = int.from_bytes(hashlib.blake2b(struct.pack("<Q", w) + h, digest_size=8).digest(),
                           "little")
        if v >= difficulty:
            return f"{w:016x}"
        w += 1


async def wait_until(pred, timeout=10.0):
    for _ in range(int(timeout / 0.02)):
        if pred():
            return
        await asyncio.sleep(0.02)
    raise TimeoutError("condition not met")


async def _replica(pkg, rid, port, db):
    server_mod = mod(pkg, "server")
    config = server_mod.ServerConfig(
        base_difficulty=EASY, throttle=1000.0, heartbeat_interval=3600.0,
        statistics_interval=3600.0, work_republish_interval=5.0, fleet=False,
        replicas=2, replica_id=rid, replica_ttl=30.0,
        replica_heartbeat_interval=3600.0)
    store = mod(pkg, "store").get_store(f"sqlite://{db}")
    transport = mod(pkg, "transport.tcp").TcpTransport(
        port=port, username="dpowserver", password="dpowserver", client_id=f"server-{rid}")
    server = server_mod.DpowServer(config, store, transport)
    await server.setup()
    server.start_loops()
    return server


def test_mixed_ring_agrees_on_ownership_and_serves_forwarded_requests(tmp_path):
    jax_tcp = mod("tpu_dpow", "transport.tcp")
    jax_transport = mod("tpu_dpow", "transport")
    payout = mod("tpu_dpow_torch", "utils.nanocrypto").encode_account(bytes(range(32)))

    async def main():
        mod("tpu_dpow", "obs").reset()
        mod("tpu_dpow_torch", "obs").reset()
        broker = jax_tcp.TcpBrokerServer(
            mod("tpu_dpow", "transport.broker").Broker(users=jax_transport.default_users()),
            port=0)
        await broker.start()
        db = tmp_path / "ring.db"
        seed = mod("tpu_dpow", "store").get_store(f"sqlite://{db}")
        await seed.setup()
        await seed.hset("service:svc", {"api_key": mod("tpu_dpow", "utils").hash_key("secret"),
                                        "public": "N", "display": "svc", "website": "",
                                        "precache": "0", "ondemand": "0"})
        await seed.sadd("services", "svc")
        await seed.close()
        ra = await _replica("tpu_dpow", "ra", broker.port, db)
        rb = await _replica("tpu_dpow_torch", "rb", broker.port, db)
        worker = jax_tcp.TcpTransport(port=broker.port, username="client", password="client",
                                      client_id="worker")
        await worker.connect()
        await worker.subscribe("work/#")
        solved = []

        async def work_loop():
            wire = mod("tpu_dpow", "transport.wire")
            async for msg in worker.messages():
                if msg.topic.startswith("work/"):
                    for bh, diff, _tid, _rng in wire.decode_work_any(msg.payload):
                        diff = int(diff, 16) if isinstance(diff, str) else diff
                        solved.append(bh)
                        await worker.publish(f"result/{msg.topic.split('/')[1]}",
                                             f"{bh},{solve(bh, diff)},{payout}")

        wtask = asyncio.ensure_future(work_loop())
        try:
            for _ in range(3):
                for s in (ra, rb):
                    await s.replica.poll()
                await asyncio.sleep(0.05)
            await wait_until(lambda: ra.replica.registry.live_members() == ["ra", "rb"]
                             and rb.replica.registry.live_members() == ["ra", "rb"])
            hashes = seeded_hashes(400, seed=23)
            owners_a = [ra.replica.registry.ring().owner_of(h) for h in hashes]
            owners_b = [rb.replica.registry.ring().owner_of(h) for h in hashes]
            assert owners_a == owners_b
            assert set(owners_a) == {"ra", "rb"}
            h_b = next(h for h, o in zip(hashes, owners_a) if o == "rb")
            h_a = next(h for h, o in zip(hashes, owners_a) if o == "ra")
            # the JAX replica forwards to the port owner, and the reverse
            got_b = await ra.service_handler({"user": "svc", "api_key": "secret",
                                              "hash": h_b, "timeout": 15})
            got_a = await rb.service_handler({"user": "svc", "api_key": "secret",
                                              "hash": h_a, "timeout": 15})
            for h, got in ((h_b, got_b), (h_a, got_a)):
                assert got["hash"] == h
                mod("tpu_dpow_torch", "utils.nanocrypto").validate_work(h, got["work"], EASY)
            fwd = [mod(pkg, "obs").snapshot()["dpow_replica_requests_total"]["series"]
                   for pkg in PKGS]
            assert fwd[0].get("forward") == 1 and fwd[1].get("forward") == 1
            assert set(solved) >= {h_a, h_b}
        finally:
            wtask.cancel()
            await asyncio.gather(wtask, return_exceptions=True)
            await worker.close()
            await ra.close()
            await rb.close()
            await broker.stop()

    run(main(), timeout=60)
