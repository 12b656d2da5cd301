"""The port's mesh gang (parallel/mesh_search.py, parallel/multihost.py and
the engine's ``mesh_devices=``) against tpu_dpow's shard_map mesh.

An 8-member CPU mesh of the port (eight logical members of
``torch.device("cpu")``) runs beside tpu_dpow's ``jax.shard_map`` mesh over
the 8 virtual CPU devices that tests/conftest.py forces, at ``batch_shards``
1, 2, 4 and 8. The same uint32 rows, made from a numpy seed, go through
both: global offsets and nonces must be bit-equal (tolerance: exact). The
controlled variant is held against tpu_dpow's at width 1 (the only width
the JAX package calls safe), ``LaunchControl`` bookkeeping included, and
against the port's own fan at width 8.

Then the engine: ``TorchWorkBackend(mesh_devices=N)`` against
``JaxWorkBackend(kernel="xla", mesh_devices=N)`` — the same ``_launch``
nonces for pinned rows, the same step ladder and contention cap, the same
refusals — and a two-process gloo twin of tests/test_multihost_procs.py.
"""

import asyncio
import hashlib
import json
import os
import socket
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_dpow.backend import WorkError as JaxWorkError
from tpu_dpow.backend.jax_backend import JaxWorkBackend
from tpu_dpow.models import WorkRequest as JaxWorkRequest
from tpu_dpow.ops import control as jctl
from tpu_dpow.parallel import mesh_search as jmesh
from tpu_dpow.parallel import multihost as jmulti
from tpu_dpow_torch.backend import WorkCancelled, WorkError, get_backend
from tpu_dpow_torch.backend.torch_backend import TorchWorkBackend
from tpu_dpow_torch.models import WorkRequest
from tpu_dpow_torch.obs import LEDGER
from tpu_dpow_torch.ops import control as tctl
from tpu_dpow_torch.ops import search
from tpu_dpow_torch.parallel import fan_search as tfan
from tpu_dpow_torch.parallel import mesh_search as tmesh
from tpu_dpow_torch.parallel import multihost as tmulti
from tpu_dpow_torch.utils import nanocrypto as nc

from conftest import requires_fan_devices, requires_shard_map

torch.set_num_threads(1)

pytestmark = [requires_fan_devices, requires_shard_map]

N = 8
CHUNK = 256  # tiny member windows: the plain versions stay fast on the CPU
CPU8 = [torch.device("cpu")] * N
EASY = 0xFFF0000000000000
UNREACH = (1 << 64) - 2
MAX_U64 = (1 << 64) - 1
RNG = np.random.default_rng(41)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def val(h: bytes, nonce: int) -> int:
    return int.from_bytes(
        hashlib.blake2b((nonce & MAX_U64).to_bytes(8, "little") + h, digest_size=8).digest(),
        "little",
    )


def rows_of(*spec) -> np.ndarray:
    return np.stack([search.pack_params(h, d, b) for h, d, b in spec])


def meshes(n: int = N, batch_shards: int = 1):
    return (tmesh.make_mesh(CPU8[:n], batch_shards=batch_shards),
            jmesh.make_mesh(jax.devices()[:n], batch_shards=batch_shards))


def chunk_both(rows, n: int = N, batch_shards: int = 1, chunk: int = CHUNK) -> np.ndarray:
    """sharded_search_chunk_batch through both packages; bit-equal or fail."""
    tm, jm = meshes(n, batch_shards)
    got = tmesh.sharded_search_chunk_batch(rows, mesh=tm, chunk_per_shard=chunk)
    want = jmesh.sharded_search_chunk_batch(jmesh.replicate_params(rows, jm), mesh=jm,
                                            chunk_per_shard=chunk)
    assert got.dtype == np.uint32
    assert np.array_equal(got, np.asarray(want))
    return got


def run_both(rows, active=None, n: int = N, batch_shards: int = 1, **kw) -> list:
    """sharded_search_run through both packages → the port's nonces."""
    tm, jm = meshes(n, batch_shards)
    lo_t, hi_t = tmesh.sharded_search_run(rows, active, mesh=tm, chunk_per_shard=CHUNK, **kw)
    lo_j, hi_j = jmesh.sharded_search_run(
        jmesh.replicate_params(rows, jm), None if active is None else jnp.asarray(active),
        mesh=jm, chunk_per_shard=CHUNK, **kw)
    assert np.array_equal(lo_t, np.asarray(lo_j)) and np.array_equal(hi_t, np.asarray(hi_j))
    return [(int(h) << 32) | int(x) for x, h in zip(lo_t, hi_t)]


@pytest.fixture(autouse=True)
def slot_ledger_clean():
    LEDGER.reset()
    yield
    assert LEDGER.outstanding() == {}, LEDGER.outstanding_keys()


# -- the mesh functions (tests/test_parallel.py, shard_map side) ----------------


def test_mesh_shape():
    tm, jm = meshes()
    assert tm.shape == dict(jm.shape) == {"batch": 1, "nonce": N}
    for bs in (2, 4, 8):
        tm, jm = meshes(batch_shards=bs)
        assert tm.shape == dict(jm.shape)
        assert tm.devices.shape == jm.devices.shape
    with pytest.raises(ValueError, match="divide"):
        tmesh.make_mesh(CPU8, batch_shards=3)
    with pytest.raises(ValueError, match="divide"):
        jmesh.make_mesh(jax.devices(), batch_shards=3)


@pytest.mark.parametrize("shard", range(N))
def test_finds_planted_nonce_in_any_shard(shard):
    h = bytes(range(32))
    base = 1 << 40
    offset = shard * CHUNK + CHUNK // 2
    diff = val(h, base + offset)
    got = int(chunk_both(rows_of((h, diff, base)))[0])
    assert got <= offset
    assert val(h, base + got) >= diff


def test_winner_election_picks_global_minimum():
    h = RNG.bytes(32)
    base = 7 << 33
    lo_off, hi_off = 2 * CHUNK + 17, 5 * CHUNK + 3
    diff = min(val(h, base + lo_off), val(h, base + hi_off))
    got = int(chunk_both(rows_of((h, diff, base)))[0])
    assert got <= lo_off and val(h, base + got) >= diff


def test_dry_window_returns_sentinel():
    assert int(chunk_both(rows_of((bytes(32), MAX_U64, 123)))[0]) == int(search.SENTINEL)


def test_matches_single_device_scan():
    h = RNG.bytes(32)
    rows = rows_of((h, EASY, int(RNG.integers(0, 1 << 63))))
    ganged = chunk_both(rows)
    single = search.search_chunk_batch(search.params_from_numpy(rows), chunk_size=CHUNK * N)
    assert int(ganged[0]) == int(search.offsets_to_numpy(single)[0])


def test_batched_requests_independent():
    h0, h1 = RNG.bytes(32), RNG.bytes(32)
    out = chunk_both(rows_of((h0, val(h0, 99 + 10), 99), (h1, MAX_U64, 99)))
    assert int(out[0]) <= 10 and int(out[1]) == int(search.SENTINEL)


def seeded_rows(rng, b: int) -> np.ndarray:
    """Rows with planted hits in different members' sub-ranges, a 2^64
    carry across the window, an easy row, pad rows and a dry row."""
    spec = []
    for r in range(b):
        h = rng.bytes(32)
        kind = r % 4
        if kind == 0:  # planted in member (r % N)'s sub-range
            base = int(rng.integers(0, 1 << 62))
            spec.append((h, val(h, base + (r % N) * CHUNK + 7), base))
        elif kind == 1:  # the window wraps past 2^64
            base = MAX_U64 - 3 * CHUNK
            spec.append((h, val(h, (base + 5 * CHUNK + 1) & MAX_U64), base))
        elif kind == 2:
            spec.append((bytes(32), 0, 0) if r % 8 == 6 else (h, MAX_U64, r))  # pad / dry
        else:
            spec.append((h, EASY, int(rng.integers(0, 1 << 63))))
    return rows_of(*spec)


@pytest.mark.parametrize("batch_shards", [1, 2, 4, 8])
def test_chunk_batch_over_every_batch_split(batch_shards):
    rows = seeded_rows(np.random.default_rng(100 + batch_shards), 8)
    out = chunk_both(rows, batch_shards=batch_shards)
    for r in range(8):
        h = search_hash(rows[r])
        d = (int(rows[r, search.DIFF_HI]) << 32) | int(rows[r, search.DIFF_LO])
        base = (int(rows[r, search.BASE_HI]) << 32) | int(rows[r, search.BASE_LO])
        if out[r] != search.SENTINEL:
            assert val(h, base + int(out[r])) >= d


@pytest.mark.parametrize("batch_shards", [1, 2, 4, 8])
def test_run_over_every_batch_split(batch_shards):
    rows = seeded_rows(np.random.default_rng(200 + batch_shards), 8)
    active = np.array([True] * 6 + [False, True])
    nonces = run_both(rows, active, batch_shards=batch_shards, max_steps=16)
    assert nonces[6] == MAX_U64  # inactive padding


def test_batch_must_divide_by_the_batch_shards():
    tm, _ = meshes(batch_shards=4)
    with pytest.raises(ValueError, match="batch"):
        tmesh.sharded_search_chunk_batch(rows_of(*[(bytes(32), 1, 0)] * 6), mesh=tm,
                                         chunk_per_shard=CHUNK)


def test_run_to_solution():
    h = RNG.bytes(32)
    diff = 0xFFFC000000000000
    steps = tmesh.expected_steps(diff, chunk_per_shard=CHUNK, n_nonce=N)
    assert steps == jmesh.expected_steps(diff, chunk_per_shard=CHUNK, n_nonce=N)
    nonce = run_both(rows_of((h, diff, int(RNG.integers(0, 1 << 63)))),
                     max_steps=max(steps * 8, 64))[0]
    assert nonce != MAX_U64 and val(h, nonce) >= diff


def test_run_active_mask_skips_padding():
    h = RNG.bytes(32)
    rows = rows_of((h, EASY, 4321), (bytes(32), MAX_U64, 0))
    nonces = run_both(rows, np.array([True, False]), max_steps=256)
    assert nonces[0] != MAX_U64 and val(h, nonces[0]) >= EASY
    assert nonces[1] == MAX_U64


def test_run_finds_the_unique_hit_of_four_ganged_windows():
    """The loop lies OUTSIDE the gang: the maximum value over four ganged
    windows is the only hit at its own difficulty, wherever it lies."""
    h = RNG.bytes(32)
    base = int(RNG.integers(0, 1 << 62))
    diff, j = max((val(h, base + j), j) for j in range(4 * CHUNK * N))
    assert run_both(rows_of((h, diff, base)), max_steps=8)[0] == base + j


def test_geometry_checks():
    tm, _ = meshes()
    with pytest.raises(ValueError, match="2\\^31"):
        tmesh.sharded_search_chunk_batch(rows_of((bytes(32), 1, 0)), mesh=tm,
                                         chunk_per_shard=1 << 28)
    with pytest.raises(ValueError, match="sublanes"):
        tmesh.sharded_search_chunk_batch(
            rows_of((bytes(32), 1, 0)), mesh=tmesh.make_mesh([torch.device("cuda", 0)]),
            chunk_per_shard=CHUNK)


@pytest.mark.parametrize("n", [2, 4])
def test_partial_width_tiles_its_window(n):
    h = RNG.bytes(32)
    base = 77
    planted = base + (n - 1) * CHUNK + 9
    off = int(chunk_both(rows_of((h, val(h, planted), base)), n=n)[0])
    assert off != 0xFFFFFFFF and off <= planted - base


def test_replicate_params_keeps_the_rows():
    rows = seeded_rows(RNG, 4)
    tm, _ = meshes()
    out = tmesh.replicate_params(rows, tm)
    assert out.dtype == np.uint32 and np.array_equal(out, rows)


# -- sharded_search_run_controlled ------------------------------------------------


class ZeroClock:
    def time(self) -> float:
        return 0.0


def scripted(base, script):
    """A LaunchControl of ``base``'s package that runs ``script(control, k)``
    inside each poll, before the poll reads."""

    class Scripted(base):
        def poll(self, dev, k, done):
            script(self, int(k))
            return super().poll(dev, k, done)

    return Scripted


def once(tag, k_min, fn):
    def step(c, k):
        fired = c.__dict__.setdefault("fired", set())
        if k >= k_min and tag not in fired:
            fired.add(tag)
            fn(c)

    return step


def bookkeeping(c, rows: int) -> dict:
    return {
        "polls": c.polls, "last_k": c.last_k,
        "done_at_k": dict(c.done_at_k), "delivered": sorted(c.delivered),
        "poll_k": c.last_poll(0)[1],
        "fields": [(c.effective_base(r), c.effective_difficulty(r), c.effective_epoch(r, -1),
                    c.applied_at_k(r), c.windows_run(r, 64), c.confirmed_no_hit_windows(r, 0, 1))
                   for r in range(rows)],
    }


def control_script(new_base):
    steps = [
        once("raise", 0, lambda c: c.raise_difficulty(2, 0xFFFF000000000000, epoch=2)),
        once("rebase", 1, lambda c: c.rebase(3, [new_base], epoch=5)),
        once("cancel", 2, lambda c: c.cancel(1)),
    ]

    def script(c, k):
        for s in steps:
            s(c, k)

    return script


def controlled_rows(rng):
    base = int(rng.integers(0, 1 << 62))
    return rows_of(
        (rng.bytes(32), UNREACH, base),  # keeps the gang polling
        (rng.bytes(32), UNREACH, base + 5),  # cancelled at k >= 2
        (rng.bytes(32), 0xFFF8000000000000, base + 9),  # raised at k = 0
        (rng.bytes(32), 0xFFFFF00000000000, base + 13),  # rebased at k >= 1
    )


def test_controlled_width_one_matches_jax_with_bookkeeping():
    rows = controlled_rows(np.random.default_rng(9))
    new_base = 3 << 40
    out = {}
    for name, ctl_mod, mesh_mod, mesh in (
        ("port", tctl, tmesh, tmesh.make_mesh(CPU8[:1])),
        ("jax", jctl, jmesh, jmesh.make_mesh(jax.devices()[:1])),
    ):
        c = scripted(ctl_mod.LaunchControl, control_script(new_base))(4, clock=ZeroClock())
        slot = ctl_mod.register(c)
        try:
            lo, hi = mesh_mod.sharded_search_run_controlled(
                rows, None, slot if name == "port" else jnp.uint32(slot), mesh=mesh,
                chunk_per_shard=CHUNK, max_steps=6, poll_steps=2)
            lo, hi = np.asarray(lo), np.asarray(hi)  # forced before the slot dies
        finally:
            ctl_mod.release(slot)
        out[name] = (lo, hi, bookkeeping(c, 4))
    (lo_t, hi_t, book_t), (lo_j, hi_j, book_j) = out["port"], out["jax"]
    assert np.array_equal(lo_t, lo_j) and np.array_equal(hi_t, hi_j)
    assert book_t == book_j
    assert book_t["done_at_k"][(1, 0)] == 2 and lo_t[1] == 0xFFFFFFFF
    assert book_t["fields"][3][0] == new_base


def test_controlled_width_eight_matches_the_ports_interleaved_fan():
    """The ganged loop against the port's fan with interleaved strides
    (member i's window k = base + k*N*CHUNK + i*CHUNK): after the host
    election, the same nonces for the same script. Every fan member polls
    with its own index, so its rebase takes the member-staggered bases."""
    rows = controlled_rows(np.random.default_rng(10))
    new_base = 5 << 40

    c = scripted(tctl.LaunchControl, control_script(new_base))(4, clock=ZeroClock())
    slot = tctl.register(c)
    try:
        lo_m, hi_m = tmesh.sharded_search_run_controlled(
            rows, None, slot, mesh=tmesh.make_mesh(CPU8), chunk_per_shard=CHUNK,
            max_steps=6, poll_steps=2)
    finally:
        tctl.release(slot)

    lock = threading.Lock()
    member_script = [
        once("raise", 0, lambda c: c.raise_difficulty(2, 0xFFFF000000000000, epoch=2)),
        once("rebase", 1, lambda c: c.rebase(3, [new_base + d * CHUNK for d in range(N)],
                                              epoch=5)),
        once("cancel", 2, lambda c: c.cancel(1)),
    ]

    class Lockstep(tctl.LaunchControl):
        barrier = threading.Barrier(N, timeout=60)

        def poll(self, dev, k, done):
            self.barrier.wait()
            if int(dev) == 0:
                with lock:
                    for s in member_script:
                        s(self, int(k))
            self.barrier.wait()
            return super().poll(dev, k, done)

    fc = Lockstep(4, clock=ZeroClock(), n_dev=N)
    slot = tctl.register(fc)
    try:
        lo_d, hi_d = tfan.fan_search_run_controlled(
            tfan.stagger(rows, N, CHUNK), slot, devices=CPU8, chunk_per_shard=CHUNK,
            max_steps=6, poll_steps=2, stride=CHUNK * N)
    finally:
        tctl.release(slot)
    lo_f, hi_f = tfan.elect(rows, lo_d, hi_d)
    # The rebased row is elected against its new base, not the dispatch's.
    rebased = rows.copy()
    rebased[3, search.BASE_LO], rebased[3, search.BASE_HI] = new_base & 0xFFFFFFFF, new_base >> 32
    lo_r, hi_r = tfan.elect(rebased, lo_d, hi_d)
    lo_f[3], hi_f[3] = lo_r[3], hi_r[3]
    assert np.array_equal(lo_m, lo_f) and np.array_equal(hi_m, hi_f)
    assert lo_m[1] == 0xFFFFFFFF and hi_m[1] == 0xFFFFFFFF  # cancelled


# -- multi-host topology (parallel/multihost.py) --------------------------------


class _StubDev:
    def __init__(self, id, process_index):
        self.id = id
        self.process_index = process_index


def test_arrange_by_host_groups_rows_like_jax():
    devs = [_StubDev(5, 1), _StubDev(0, 0), _StubDev(4, 1),
            _StubDev(1, 0), _StubDev(2, 0), _StubDev(3, 1)]
    got, want = tmulti.arrange_by_host(devs), jmulti.arrange_by_host(devs)
    assert got.shape == want.shape == (2, 3)
    assert [[d.id for d in r] for r in got] == [[d.id for d in r] for r in want]
    with pytest.raises(ValueError, match="uneven"):
        tmulti.arrange_by_host([_StubDev(0, 0), _StubDev(1, 0), _StubDev(2, 1)])


def test_multihost_mesh_single_process_runs_search():
    mesh = tmulti.make_multihost_mesh(local_devices=CPU8[:4])
    assert mesh.shape == {"batch": 1, "nonce": 4} and mesh.local_rows == (0,)
    h = RNG.bytes(32)
    base = 77
    planted = base + 2 * CHUNK + 9
    rows = rows_of((h, val(h, planted), base))
    got = tmesh.sharded_search_chunk_batch(rows, mesh=mesh, chunk_per_shard=CHUNK)
    jm = jmulti.make_multihost_mesh(jax.devices()[:4])
    want = jmesh.sharded_search_chunk_batch(rows, mesh=jm, chunk_per_shard=CHUNK)
    assert np.array_equal(got, np.asarray(want))
    assert int(got[0]) <= planted - base


def test_multihost_mesh_computes_only_its_own_batch_row():
    devs = [tmesh.MeshDevice(p, p * 2 + i, CPU8[0] if p == 0 else None)
            for p in (1, 0) for i in range(2)]
    mesh = tmulti.make_multihost_mesh(devs)
    assert mesh.shape == {"batch": 2, "nonce": 2} and mesh.local_rows == (0,)
    assert list(mesh.addressable_rows(4)) == [0, 1]
    rows = rows_of(*[(bytes(32), 1, 0)] * 4)
    out = tmesh.sharded_search_chunk_batch(rows, mesh=mesh, chunk_per_shard=CHUNK)
    assert list(out) == [0, 0, 0xFFFFFFFF, 0xFFFFFFFF]
    lo, hi = tmesh.sharded_search_run(rows, mesh=mesh, chunk_per_shard=CHUNK, max_steps=2)
    assert list(lo) == [0, 0, 0xFFFFFFFF, 0xFFFFFFFF]


def test_init_distributed_noop_without_coordinator(monkeypatch):
    monkeypatch.delenv("TPU_DPOW_COORDINATOR", raising=False)
    tmulti.init_distributed()
    assert not torch.distributed.is_initialized()


def test_init_distributed_maps_the_env_contract(monkeypatch):
    seen = {}
    monkeypatch.setenv("TPU_DPOW_COORDINATOR", "127.0.0.1:4567")
    monkeypatch.setenv("TPU_DPOW_NUM_PROCESSES", "3")
    monkeypatch.setenv("TPU_DPOW_PROCESS_ID", "2")
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda backend, **kw: seen.update(backend=backend, **kw))
    from tpu_dpow_torch.utils import maybe_init_distributed

    maybe_init_distributed()
    assert seen == {"backend": "gloo", "init_method": "tcp://127.0.0.1:4567",
                    "world_size": 3, "rank": 2}
    monkeypatch.delenv("TPU_DPOW_PROCESS_ID")
    with pytest.raises(ValueError, match="PROCESS_ID"):
        tmulti.init_distributed()


_WORKER = r"""
import hashlib, json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
from tpu_dpow_torch.ops import search
from tpu_dpow_torch.parallel import fan_devices, make_multihost_mesh, sharded_search_run
from tpu_dpow_torch.utils import maybe_init_distributed

DIFFICULTY = 0xFFF0000000000000
maybe_init_distributed()  # the TPU_DPOW_* env contract
try:
    assert torch.distributed.get_world_size() == 2
    mesh = make_multihost_mesh(local_devices=fan_devices(4, "cpu"))
    assert mesh.shape == {"batch": 2, "nonce": 4}, mesh.shape
    for r in range(2):
        assert len({d.process_index for d in mesh.devices[r]}) == 1
    rng = np.random.default_rng(int(os.environ["TEST_SEED"]))
    hashes = [rng.bytes(32) for _ in range(2)]
    params = np.stack([search.pack_params(h, DIFFICULTY, 0) for h in hashes])
    lo, hi = sharded_search_run(params, mesh=mesh, chunk_per_shard=4096, max_steps=8)
    rows = {}
    mine = set(int(r) for r in mesh.addressable_rows(2))
    for row in range(2):
        nonce = (int(hi[row]) << 32) | int(lo[row])
        if row not in mine:
            assert nonce == (1 << 64) - 1, "computed a row of another process"
            continue
        digest = hashlib.blake2b(nonce.to_bytes(8, "little") + hashes[row], digest_size=8)
        assert int.from_bytes(digest.digest(), "little") >= DIFFICULTY
        rows[str(row)] = f"{nonce:016x}"
    print(json.dumps({"process_id": torch.distributed.get_rank(), "rows": rows}), flush=True)
finally:
    torch.distributed.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_multihost_search():
    """Two processes joined by gloo over loopback through the TPU_DPOW_* env
    contract: batch = process, nonce = that process's 4 members, each
    process solves its own row and only that one."""
    env_base = {**os.environ, "TPU_DPOW_COORDINATOR": f"127.0.0.1:{_free_port()}",
                "TPU_DPOW_NUM_PROCESSES": "2", "TEST_SEED": "1234",
                "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    procs = []
    try:
        for pid in range(2):
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _WORKER], env=dict(env_base, TPU_DPOW_PROCESS_ID=str(pid)),
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO))
        outs = []
        for p in procs:
            stdout, stderr = p.communicate(timeout=150)
            assert p.returncode == 0, f"worker failed:\n{stderr[-3000:]}"
            outs.append(json.loads(stdout.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    by_pid = {o["process_id"]: o for o in outs}
    assert set(by_pid) == {0, 1}
    assert set(by_pid[0]["rows"]) == {"0"} and set(by_pid[1]["rows"]) == {"1"}


# -- the mesh engine against JaxWorkBackend(mesh_devices=N) -------------------------


def both_engines(**kw):
    port = TorchWorkBackend(device="cpu", **kw)
    ref = JaxWorkBackend(kernel="xla", sublanes=8, iters=8, warm_shapes=False, **kw)
    return port, ref


def search_hash(row) -> bytes:
    return np.ascontiguousarray(row[:8], dtype=np.uint32).tobytes()


@pytest.mark.parametrize("n,steps", [(1, 1), (2, 3), (8, 1)])
def test_engine_launch_nonces_match_jax(n, steps):
    port, ref = both_engines(mesh_devices=n, pipeline=1)
    assert port.chunk == ref.chunk == n * port.chunk_per_shard
    rng = np.random.default_rng(300 + n)
    spec = []
    for r in range(4):
        h = rng.bytes(32)
        base = int(rng.integers(0, 1 << 63))
        spec.append((h, val(h, base + (r * 997 * steps) % (port.chunk * steps)), base))
    rows = np.concatenate([rows_of(*spec), np.stack([port._PAD_ROW] * 4)])
    lo_t, hi_t = port._launch(rows, steps)
    lo_j, hi_j = ref._launch(rows, steps)
    assert np.array_equal(lo_t, np.asarray(lo_j)) and np.array_equal(hi_t, np.asarray(hi_j))
    for r, (h, d, _b) in enumerate(spec):
        nonce = (int(hi_t[r]) << 32) | int(lo_t[r])
        assert nonce != MAX_U64 and val(h, nonce) >= d


def test_mesh_engine_generates_valid_work():
    async def go():
        b = TorchWorkBackend(device="cpu", mesh_devices=N)
        assert b.mesh is not None and b.fan is None
        assert b.chunk == N * b.chunk_per_shard
        await b.setup()
        h = RNG.bytes(32).hex().upper()
        work = await b.generate(WorkRequest(h, EASY))
        nc.validate_work(h, work, EASY)
        await b.close()

    asyncio.run(asyncio.wait_for(go(), 60))


def test_mesh_engine_concurrent_and_cancel():
    async def go():
        b = TorchWorkBackend(device="cpu", mesh_devices=N)
        await b.setup()
        reqs = [WorkRequest(RNG.bytes(32).hex().upper(), EASY) for _ in range(3)]
        works = await asyncio.gather(*(b.generate(r) for r in reqs))
        for r, w in zip(reqs, works):
            nc.validate_work(r.block_hash, w, EASY)
        hard = RNG.bytes(32).hex().upper()
        t = asyncio.ensure_future(b.generate(WorkRequest(hard, UNREACH)))
        await asyncio.sleep(0.2)
        await b.cancel(hard)
        with pytest.raises(WorkCancelled):
            await t
        await b.close()
        assert not b._jobs

    asyncio.run(asyncio.wait_for(go(), 60))


def test_mesh_width_one_builds_real_gang():
    async def go():
        b = TorchWorkBackend(device="cpu", mesh_devices=1)
        assert b.mesh is not None and b.mesh.shape == {"batch": 1, "nonce": 1}
        assert b.chunk == b.chunk_per_shard
        await b.setup()
        h = RNG.bytes(32).hex().upper()
        nc.validate_work(h, await b.generate(WorkRequest(h, EASY)), EASY)
        await b.close()

    asyncio.run(asyncio.wait_for(go(), 60))
    plain = TorchWorkBackend(device="cpu")
    assert plain.mesh is None and plain.fan is None


def test_mesh_engine_refusals_match_jax():
    for kw in (dict(mesh_devices=len(jax.devices()) + 1), dict(devices=2, mesh_devices=2),
               dict(mesh_devices=1, run_mode="persistent")):
        with pytest.raises(JaxWorkError) as want:
            JaxWorkBackend(kernel="xla", **kw)
        with pytest.raises(WorkError) as got:
            TorchWorkBackend(device="cpu", **kw)
        for word in ("visible", "exclusive", "persistent"):
            assert (word in str(want.value)) == (word in str(got.value)), (kw, word)
    with pytest.raises(WorkError, match="mesh_devices"):
        TorchWorkBackend(device="cpu", mesh_devices=8, sublanes=8, iters=1 << 18)
    b = get_backend("torch", device="cpu", mesh_devices=2)
    assert b.mesh.shape == {"batch": 1, "nonce": 2}


@pytest.mark.parametrize("ladder,run_steps,cap", [
    ("x4", 16, None), ("x2", 16, None), ("x2", 16, 3), ("x4", 7, 100), ("x2", 1, None),
])
def test_step_ladder_and_shared_cap_match_jax(ladder, run_steps, cap):
    port, ref = both_engines(step_ladder=ladder, run_steps=run_steps, shared_steps_cap=cap)
    assert port._step_counts() == ref._step_counts()
    assert port.shared_steps_cap == ref.shared_steps_cap
    for mult in (1.0, 8.0, 64.0, 4096.0, 1e6):
        d = nc.derive_work_difficulty(mult)
        assert port._steps_for(d) == ref._steps_for(d), mult
    with pytest.raises(WorkError, match="step_ladder"):
        TorchWorkBackend(device="cpu", step_ladder="x3")
    with pytest.raises(JaxWorkError, match="step_ladder"):
        JaxWorkBackend(kernel="xla", step_ladder="x3")


def test_both_mesh_engines_return_the_same_work_for_a_pinned_request():
    """The slice as a whole: one pinned request through both mesh engines
    (8 members, pipeline 1) returns the same work."""
    h = RNG.bytes(32).hex().upper()
    base = (11 << 32) - 3000

    async def solve(b, req):
        await b.setup()
        try:
            return await b.generate(req)
        finally:
            await b.close()

    port, ref = both_engines(mesh_devices=N, pipeline=1)
    work_t = asyncio.run(asyncio.wait_for(solve(port, WorkRequest(h, EASY, nonce_range=(base, 0))), 60))
    work_j = asyncio.run(asyncio.wait_for(
        solve(ref, JaxWorkRequest(h, EASY, nonce_range=(base, 0))), 120))
    assert work_t == work_j
    nc.validate_work(h, work_t, EASY)


def test_workserver_entry_point_gangs_mesh_devices(monkeypatch):
    from tpu_dpow_torch.workserver import __main__ as entry

    built = []

    class Started(Exception):
        pass

    class FakeServer:
        def __init__(self, backend, host, port):
            built.append((backend, host, port))

        async def start(self):
            raise Started

        async def stop(self):
            pass

    monkeypatch.setattr(entry, "WorkServer", FakeServer)
    for argv, shape in ((["--mesh_devices", "4"], {"batch": 1, "nonce": 4}), ([], None)):
        with pytest.raises(Started):
            asyncio.run(entry.amain(["--device", "cpu", "--listen", "127.0.0.1:7001", *argv]))
        backend, host, port = built.pop()
        assert (host, port) == ("127.0.0.1", 7001)
        assert (backend.mesh.shape if backend.mesh is not None else None) == shape
