"""Package-level checks of the PyTorch + CUDA port.

* Importing ``tpu_dpow_torch`` and every submodule loads neither ``jax`` nor
  any module of ``tpu_dpow`` (checked in a fresh interpreter), the device
  fan, the mesh gang, the multi-host layout, the chaos seam, the fault
  domains, the logging helper, the worker client, the transport, the
  tracer and the hub with its store, sched, fleet, replica and precache
  layers, the MQTT and websocket faces, the load generator, the native and
  subprocess engines, the failover chain, the work server and the six
  operator scripts included; ``python -m tpu_dpow_torch.client --help``
  exits 0.
* The kernel's arithmetic header (``ops/csrc/blake2b_search.cuh``), built for
  the host with ``g++``, gives hashlib's work values.
* ``chip_smoke.py`` and ``chip_cover_stress.py`` fail, and print no result,
  where no card is visible; the smoke's mid-launch cover check counts the
  launches that re-dispatched a job.
* On a card (marker ``cuda``, skipped here): each kernel equals its plain
  version bit for bit — the persistent run kernel with and without a
  scripted control channel, its LaunchControl bookkeeping included, and with
  strided windows — each launch moves its counter by one, and the fan and
  mesh functions over every visible card equal their plain versions. The
  search kernel counts the nonces each row ran, and a row whose out word is
  lowered mid-launch from another stream stops short of its span.
"""

import asyncio
import ctypes
import hashlib
import importlib.util
import json
import os
import shutil
import struct
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tpu_dpow_torch.ops import control, cuda_kernel, runloop, search

# The suite runs in parallel worker processes: one intra-op thread each
# keeps these tests from crowding out the others on the same cores.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CUH = os.path.join(REPO, "tpu_dpow_torch", "ops", "csrc", "blake2b_search.cuh")
MAX_U64 = (1 << 64) - 1
EASY = 0xFFF0000000000000


def ref_value(nonce: int, h: bytes) -> int:
    return int.from_bytes(
        hashlib.blake2b(struct.pack("<Q", nonce & MAX_U64) + h, digest_size=8).digest(),
        "little",
    )


def test_import_loads_neither_jax_nor_the_jax_package():
    probe = (
        "import importlib, pkgutil, sys\n"
        "import tpu_dpow_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(tpu_dpow_torch.__path__, 'tpu_dpow_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'jax' or m.startswith('jax.') or m == 'tpu_dpow'\n"
        "             or m.startswith('tpu_dpow.'))\n"
        "need = {'tpu_dpow_torch.parallel', 'tpu_dpow_torch.parallel.fan_search',\n"
        "        'tpu_dpow_torch.chaos', 'tpu_dpow_torch.chaos.device',\n"
        "        'tpu_dpow_torch.resilience.devfault', 'tpu_dpow_torch.resilience.breaker',\n"
        "        'tpu_dpow_torch.utils.logging', 'tpu_dpow_torch.parallel.mesh_search',\n"
        "        'tpu_dpow_torch.parallel.multihost', 'tpu_dpow_torch.client',\n"
        "        'tpu_dpow_torch.client.__main__', 'tpu_dpow_torch.client.app',\n"
        "        'tpu_dpow_torch.transport', 'tpu_dpow_torch.transport.tcp',\n"
        "        'tpu_dpow_torch.transport.wire', 'tpu_dpow_torch.obs.prom',\n"
        "        'tpu_dpow_torch.obs.trace', 'tpu_dpow_torch.server',\n"
        "        'tpu_dpow_torch.server.__main__', 'tpu_dpow_torch.server.app',\n"
        "        'tpu_dpow_torch.server.api', 'tpu_dpow_torch.server.nano_ws',\n"
        "        'tpu_dpow_torch.store', 'tpu_dpow_torch.store.sqlite_store',\n"
        "        'tpu_dpow_torch.store.redis_store', 'tpu_dpow_torch.store.degraded',\n"
        "        'tpu_dpow_torch.sched', 'tpu_dpow_torch.sched.window',\n"
        "        'tpu_dpow_torch.fleet', 'tpu_dpow_torch.fleet.coordinator',\n"
        "        'tpu_dpow_torch.replica', 'tpu_dpow_torch.replica.ring',\n"
        "        'tpu_dpow_torch.precache', 'tpu_dpow_torch.precache.pipeline',\n"
        "        'tpu_dpow_torch.chaos.store', 'tpu_dpow_torch.chaos.transport',\n"
        "        'tpu_dpow_torch.chaos.backend', 'tpu_dpow_torch.resilience.supervisor',\n"
        "        'tpu_dpow_torch.utils.throttle', 'tpu_dpow_torch.transport.mqtt',\n"
        "        'tpu_dpow_torch.transport.ws', 'tpu_dpow_torch.transport.__main__',\n"
        "        'tpu_dpow_torch.loadgen', 'tpu_dpow_torch.loadgen.arrival',\n"
        "        'tpu_dpow_torch.loadgen.population', 'tpu_dpow_torch.loadgen.recorder',\n"
        "        'tpu_dpow_torch.loadgen.driver', 'tpu_dpow_torch.loadgen.responder',\n"
        "        'tpu_dpow_torch.loadgen.config', 'tpu_dpow_torch.backend.native_backend',\n"
        "        'tpu_dpow_torch.backend.subprocess_backend', 'tpu_dpow_torch.resilience.failover',\n"
        "        'tpu_dpow_torch.workserver', 'tpu_dpow_torch.workserver.__main__',\n"
        "        'tpu_dpow_torch.scripts', 'tpu_dpow_torch.scripts.services',\n"
        "        'tpu_dpow_torch.scripts.client_snapshot', 'tpu_dpow_torch.scripts.payouts',\n"
        "        'tpu_dpow_torch.scripts.check_latency', 'tpu_dpow_torch.scripts.chaos_demo',\n"
        "        'tpu_dpow_torch.autoscale', 'tpu_dpow_torch.autoscale.config',\n"
        "        'tpu_dpow_torch.autoscale.signals', 'tpu_dpow_torch.autoscale.controller',\n"
        "        'tpu_dpow_torch.autoscale.journal', 'tpu_dpow_torch.autoscale.actuator',\n"
        "        'tpu_dpow_torch.autoscale.__main__', 'tpu_dpow_torch.loadgen.sim',\n"
        "        'tpu_dpow_torch.analysis', 'tpu_dpow_torch.analysis.sanitizer',\n"
        "        'tpu_dpow_torch.analysis.__main__'}\n"
        "print(len(names), sorted(need - set(names)), bad)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", probe], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    count, missing, bad = out.stdout.strip().split(" ", 2)
    assert int(count) >= 40  # every module of the port was imported
    assert missing == "[]" and bad == "[]"


def test_autoscaler_and_sim_load_no_torch():
    """A replica the autoscaler spawns, and the autoscaler itself, open no
    CUDA context: the autoscale package, the sim and the hub they drive
    import without torch (and without jax or tpu_dpow)."""
    probe = (
        "import sys\n"
        "import tpu_dpow_torch.autoscale, tpu_dpow_torch.autoscale.__main__\n"
        "import tpu_dpow_torch.autoscale.actuator, tpu_dpow_torch.loadgen.sim\n"
        "import tpu_dpow_torch.server.app\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in ('torch', 'jax', 'tpu_dpow')))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", probe], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_client_entry_point_help_exits_zero():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-m", "tpu_dpow_torch.client", "--help"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert "--mesh_devices" in out.stdout and "--device" in out.stdout


def test_cuh_host_build_matches_hashlib(tmp_path):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the header's host build cannot be compiled")
    src = tmp_path / "pow.cc"
    src.write_text(
        f'#include "{CUH}"\n'
        'extern "C" uint64_t pow_value(uint64_t n, const uint64_t* h) {\n'
        "  return b2pow::pow_value(n, h[0], h[1], h[2], h[3]);\n"
        "}\n"
    )
    lib_path = tmp_path / "libpow.so"
    subprocess.run(
        [gxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-o", str(lib_path), str(src)],
        check=True, capture_output=True, timeout=120,
    )
    lib = ctypes.CDLL(str(lib_path))
    lib.pow_value.argtypes = [ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint64)]
    lib.pow_value.restype = ctypes.c_uint64
    rng = np.random.default_rng(2)
    edges = [0, 1, 0xFFFFFFFF, 1 << 32, (1 << 63) - 1, 1 << 63, MAX_U64 - 1, MAX_U64]
    for _ in range(16):
        h = rng.bytes(32)
        words = (ctypes.c_uint64 * 4)(*struct.unpack("<4Q", h))
        nonces = edges + [int(x) for x in rng.integers(0, 1 << 64, size=8, dtype=np.uint64)]
        for n in nonces:
            assert lib.pow_value(n, words) == ref_value(n, h), (h.hex(), n)


def test_chip_smoke_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_cover_stress_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_cover_stress.py"), "--runs", "1"], cwd=REPO,
        env=env, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0
    assert out.stdout == ""


def test_cover_check_counts_launches_dispatched_after_the_rebase():
    """chip_smoke.py's mid-launch cover check: an in-flight launch that
    carries the job and was not among the launches the rebase was written
    into counts as a re-dispatch; those known before and other jobs' do not."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    job, other = SimpleNamespace(block_hash="AA"), SimpleNamespace(block_hash="BB")
    known = SimpleNamespace(jobs=[job])
    backend = SimpleNamespace(_inflight=[known])

    async def drive():
        task = asyncio.get_running_loop().create_future()

        async def engine():
            await asyncio.sleep(0.01)
            backend._inflight = [known, SimpleNamespace(jobs=[other]),
                                 SimpleNamespace(jobs=[other, job])]
            await asyncio.sleep(0.01)
            backend._inflight = []
            task.set_result("00000000000000ff")

        pending = asyncio.ensure_future(engine())
        got = await smoke._result_tracking(backend, task, "AA", [(known, 0)], "the job")
        await pending
        return got

    assert asyncio.run(drive()) == ("00000000000000ff", 1)


STORE_DIR_CHILD = """
import json, os, shutil, sys, tempfile
sys.path.insert(0, sys.argv[1])
import chip_smoke
w = tempfile.mkdtemp()
chip_smoke.NETWORK_FS = (chip_smoke._fs_type(w),) if sys.argv[2] == "network" else ()
try:
    with chip_smoke._store_dir(w) as (path, fs):
        open(os.path.join(path, "shared.db"), "w").write("x")
        mounted = [ln.split()[1] for ln in open("/proc/self/mounts") if path in ln]
    print(json.dumps({"path": path, "fs": fs, "mounted": mounted,
                      "left": os.listdir(path)}))
except AssertionError as e:
    print(json.dumps({"refused": str(e)}))
shutil.rmtree(w)
"""


@pytest.mark.parametrize("kind", ["local", "network"])
def test_autoscale_store_stays_inside_the_workdir(kind):
    """The autoscale phase's shared sqlite store lives in ``workdir/store``.
    On a local filesystem it is that directory; on a network one the phase
    mounts a private tmpfs there, in a mount namespace of its own (gone with
    the process tree), or refuses and names the fix. Run in a child, whose
    namespace dies with it."""
    out = subprocess.run([sys.executable, "-c", STORE_DIR_CHILD, REPO, kind], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    if "refused" in got:
        assert kind == "network" and "point TMPDIR at a tmpfs" in got["refused"]
        return
    assert os.path.basename(got["path"]) == "store"
    if kind == "local":
        assert got["mounted"] == [] and got["left"] == ["shared.db"]
    else:
        assert got["fs"].startswith("tmpfs (private, over ")
        assert got["mounted"] == [got["path"]] and got["left"] == []
    with open("/proc/self/mounts") as f:
        assert got["path"] not in f.read()


def test_queued_launch_sleeps_until_its_start_event():
    """A persistent launch queued behind another sleeps, its naps doubling
    from 20 µs, until the event recorded before its kernel completes."""

    class Event:
        queries = 0

        def query(self):
            self.queries += 1
            return self.queries == 4

    event = Event()
    waited_ns = cuda_kernel._sleep_until(event)
    assert event.queries == 4
    assert waited_ns >= (20 + 40 + 80) * 1000


class _FakeFn:
    """Stands in for a ctypes function: takes argtypes and restype and
    returns ``ret``."""

    def __init__(self, ret=0):
        self.ret = ret

    def __call__(self, *args):
        return self.ret


class _OutWords(_FakeFn):
    """``b2_run_out_words``: a launch's lo and hi words, then its statistics."""

    def __call__(self, rows):
        return 2 * rows + cuda_kernel._OUT_STATS


class _FakeLib:
    """Stands in for a kernel library loaded from ``path`` (its name)."""

    def __init__(self, path):
        self.b2_abi_version = _FakeFn(cuda_kernel._ABI_VERSIONS[path])
        self.b2_run_out_words = _OutWords()

    def __getattr__(self, attr):
        fn = _FakeFn()
        setattr(self, attr, fn)
        return fn


@pytest.fixture
def four_fake_cards(monkeypatch):
    """Four visible cards as far as the port asks, kernel libraries that
    load without nvcc, and mailboxes that record the card they are made
    on (the list returned)."""
    made = []

    class Mailbox:
        def __init__(self, lib, rows, device):
            self.rows, self.device = rows, device
            made.append(device)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(cuda_kernel, "build_libraries", lambda names: {n: n for n in names})
    monkeypatch.setattr(cuda_kernel.ctypes, "CDLL", _FakeLib)
    monkeypatch.setattr(cuda_kernel, "_libs", {})
    monkeypatch.setattr(cuda_kernel, "_lib_paths", {})
    monkeypatch.setattr(cuda_kernel, "_mailboxes", {})
    monkeypatch.setattr(cuda_kernel, "_Mailbox", Mailbox)
    return made


@pytest.mark.parametrize("kw,cards", [
    (dict(device="cuda:2", run_mode="persistent"), [2]),
    (dict(devices=2, run_mode="persistent"), [0, 1]),
    (dict(device="cuda:3"), []),  # chunked: no controlled launch, no mailbox
])
def test_mailboxes_are_pooled_only_on_the_engines_cards(four_fake_cards, kw, cards):
    """Loading the kernels makes no mailbox; an engine's setup pools them on
    its own cards only (a CUDA context on no other card), and a second
    setup tops the pools up without adding more. A launch on a card with
    no pool allocates its mailbox there."""
    from tpu_dpow_torch.backend.torch_backend import TorchWorkBackend

    cuda_kernel.load_libraries()
    assert four_fake_cards == []
    engine = TorchWorkBackend(**kw)
    engine._load_kernels()
    engine._load_kernels()
    assert sorted(four_fake_cards) == [c for c in cards
                                       for _ in range(cuda_kernel._MAILBOXES_PER_CARD)]
    box = cuda_kernel._take_mailbox(cuda_kernel.load_run_library(), 16, 3)
    assert box.device == 3 and four_fake_cards[-1] == 3


def seeded_rows() -> np.ndarray:
    """Pads, a 2^32 and a 2^64 carry, easy rows and a dry row."""
    rng = np.random.default_rng(41)
    rows = [
        (rng.bytes(32), 0, int(rng.integers(0, 1 << 62))),
        (bytes(32), 0, 0),
        (rng.bytes(32), EASY, (5 << 32) - 100),
        (rng.bytes(32), EASY, MAX_U64 - 100),
        (rng.bytes(32), 0xFFFE000000000000, int(rng.integers(0, 1 << 62))),
        (rng.bytes(32), 0xFFFFC00000000000, int(rng.integers(0, 1 << 62))),
        (rng.bytes(32), MAX_U64, int(rng.integers(0, 1 << 62))),
    ]
    return np.stack([search.pack_params(h, d, b) for h, d, b in rows])


@pytest.mark.cuda
@pytest.mark.parametrize("nblocks", [1, 3, 16])
def test_kernel_matches_plain_on_the_card(nblocks):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    params = search.params_from_numpy(seeded_rows(), "cuda")
    geo = dict(sublanes=8, iters=16, nblocks=nblocks, group=2)
    before = cuda_kernel.launches
    got = cuda_kernel.cuda_search_chunk_batch(params, **geo)
    assert cuda_kernel.launches == before + 1
    torch.cuda.synchronize()
    want = search.search_chunk_batch(params, chunk_size=cuda_kernel.window(**geo))
    assert torch.equal(got, want)
    single = cuda_kernel.cuda_search_chunk(params[2], sublanes=8, iters=16, group=2)
    assert int(single) == int(search.search_chunk(params[2], chunk_size=8 * 128 * 16))
    with pytest.raises(TypeError):
        cuda_kernel.cuda_search_chunk_batch(params.to(torch.int64), **geo)


@pytest.mark.cuda
def test_kernel_counts_what_rows_ran_and_stops_a_row_lowered_mid_launch():
    """With ``scanned`` the offsets stay the plain version's (and those of
    the launch without it, scanned == nullptr); a dry row counts exactly
    its span, a hit row at least its offset + 1. A RowStopper lowering one
    row's out word from its own stream while the kernel runs stops that
    row short of its span, and leaves every other row as it was."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    params = search.params_from_numpy(seeded_rows(), "cuda")
    rows = params.shape[0]
    geo = dict(sublanes=8, iters=16, nblocks=3, group=2)
    span = cuda_kernel.window(**geo)
    bare = cuda_kernel.cuda_search_chunk_batch(params, **geo)
    out = torch.full((rows,), -1, dtype=torch.int32, device="cuda")
    scanned = torch.zeros(rows, dtype=torch.int32, device="cuda")
    assert cuda_kernel.cuda_search_chunk_batch(params, out=out, scanned=scanned, **geo) is out
    torch.cuda.synchronize()
    plain = search.search_chunk_batch(params, chunk_size=span)
    assert torch.equal(bare, plain) and torch.equal(out, plain)
    for off, n in zip(search.offsets_to_numpy(out), search.offsets_to_numpy(scanned)):
        assert n == span if off == search.SENTINEL else off + 1 <= n <= span

    # Four rows of 2^28 nonces (~0.1 s): two hit early, two are dry; row 1
    # is stopped ~30 ms in.
    rng = np.random.default_rng(16)
    hard = [(rng.bytes(32), 0xFFFC000000000000, int(rng.integers(0, 1 << 62))),
            (rng.bytes(32), MAX_U64, int(rng.integers(0, 1 << 62))),
            (rng.bytes(32), MAX_U64, int(rng.integers(0, 1 << 62))),
            (rng.bytes(32), 0xFFFC000000000000, (1 << 64) - 5000)]
    params = search.params_from_numpy(
        np.stack([search.pack_params(h, d, b) for h, d, b in hard]), "cuda")
    geo = dict(sublanes=32, iters=1024, nblocks=64, group=8)
    span = cuda_kernel.window(**geo)
    want = search.offsets_to_numpy(cuda_kernel.cuda_search_chunk_batch(params, **geo))
    out = torch.full((4,), -1, dtype=torch.int32, device="cuda")
    scanned = torch.zeros(4, dtype=torch.int32, device="cuda")
    stopper = cuda_kernel.RowStopper(out)
    cuda_kernel.cuda_search_chunk_batch(params, out=out, scanned=scanned, **geo)
    time.sleep(0.03)
    stopper.stop(1)
    stopper.drain()
    torch.cuda.synchronize()
    got, ran = search.offsets_to_numpy(out), search.offsets_to_numpy(scanned)
    assert got[1] == 0 and 0 < ran[1] < span
    assert ran[2] == span and got[2] == want[2] == search.SENTINEL
    for r in (0, 3):
        h, d, base = hard[r]
        assert got[r] == want[r] < span and ran[r] >= got[r] + 1
        assert ref_value(base + int(got[r]), h) >= d
        assert all(ref_value(base + o, h) < d for o in range(int(got[r])))
    one = search.search_chunk_batch(params[[0, 3]], chunk_size=span)
    assert search.offsets_to_numpy(one).tolist() == [got[0], got[3]]


class TickClock:
    def __init__(self):
        self.t = 0.0

    def time(self) -> float:
        self.t += 0.125
        return self.t


class ScriptedControl(control.LaunchControl):
    """Raise row 4 at k >= 0, rebase row 3 at k >= 1, cancel row 6 at
    k >= 2, each once, from inside the poll."""

    EVENTS = (
        (0, lambda c: c.raise_difficulty(4, 0xFFFFF00000000000, epoch=2)),
        (1, lambda c: c.rebase(3, MAX_U64 - 900, epoch=4)),
        (2, lambda c: c.cancel(6)),
    )

    def poll(self, dev, k, done):
        for i, (k_min, fire) in enumerate(self.EVENTS):
            if k >= k_min and i not in self.fired:
                self.fired.add(i)
                fire(self)
        return super().poll(dev, k, done)


def run_both_sides(params, window, poll_steps, stride=None):
    """The run kernel and the plain run loop on the same rows, windows
    ``stride`` apart (None: contiguous) → per side (nonces, bookkeeping or
    None)."""
    out = []
    for on_card in (True, False):
        c = slot = None
        if poll_steps is not None:
            c = ScriptedControl(params.shape[0], clock=TickClock())
            c.fired = set()
            slot = control.register(c)
        try:
            if on_card:
                before = cuda_kernel.run_launches
                strided = cuda_kernel.run_strided_launches
                if slot is None:
                    lo, hi = runloop.search_run_batch(params, None, max_steps=11, sublanes=8,
                                                      iters=16, stride=stride)
                else:
                    lo, hi = runloop.search_run_batch_controlled(
                        params, None, slot, max_steps=11, poll_steps=poll_steps,
                        sublanes=8, iters=16, stride=stride)
                assert cuda_kernel.run_launches == before + 1
                assert cuda_kernel.run_strided_launches == strided + (
                    stride is not None and stride != window)
            else:
                lo, hi = runloop.run_loop_core(
                    params, None, launch=runloop.plain_launch(window), window=stride or window,
                    max_steps=11, poll_steps=poll_steps or 0,
                    control_poll=None if slot is None else runloop.make_control_poll(slot))
            lo, hi = search.offsets_to_numpy(lo), search.offsets_to_numpy(hi)
        finally:
            if slot is not None:
                control.release(slot)
        book = None if c is None else (
            c.polls, c.last_k, sorted(c.done_at_k.items()), c.delivered,
            [(c.effective_base(r), c.effective_difficulty(r), c.effective_epoch(r, -1))
             for r in range(c.rows)])
        out.append(([(int(h) << 32) | int(x) for x, h in zip(lo, hi)], book))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("poll_steps", [None, 1, 3])
def test_run_kernel_matches_plain_on_the_card(poll_steps):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the persistent kernel has no CPU mode")
    params = search.params_from_numpy(seeded_rows(), "cuda")
    card, plain = run_both_sides(params, cuda_kernel.window(8, 16), poll_steps)
    assert card == plain
    with pytest.raises(TypeError):
        runloop.search_run_batch(params.to(torch.int64), None, max_steps=1, sublanes=8, iters=16)


@pytest.mark.cuda
@pytest.mark.parametrize("poll_steps,stride_windows", [(None, 4), (1, 4), (2, 3), (None, 1)])
def test_strided_run_kernel_matches_plain_on_the_card(poll_steps, stride_windows):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the persistent kernel has no CPU mode")
    params = search.params_from_numpy(seeded_rows(), "cuda")
    window = cuda_kernel.window(8, 16)
    card, plain = run_both_sides(params, window, poll_steps, stride=stride_windows * window)
    assert card == plain


@pytest.mark.cuda
def test_fan_functions_match_plain_on_the_cards():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fan's kernels have no CPU mode")
    from tpu_dpow_torch.parallel import fan_search

    devs = fan_search.fan_devices(-1, "cuda")
    n, window = len(devs), cuda_kernel.window(8, 16)
    rows = seeded_rows()
    before = cuda_kernel.launches
    got = fan_search.fan_search_chunk_batch(rows, devices=devs, chunk_per_shard=window,
                                            sublanes=8, iters=16)
    assert cuda_kernel.launches == before + n
    want = search.offsets_to_numpy(search.search_chunk_batch(
        search.params_from_numpy(rows, "cuda"), chunk_size=n * window))
    assert np.array_equal(got, want)
    lo, hi = fan_search.fan_search_run(rows, devices=devs, chunk_per_shard=window,
                                       max_steps=9, sublanes=8, iters=16)
    stacked = fan_search.stagger(rows, n, window)
    plain = [runloop.run_loop_core(search.params_from_numpy(stacked[i], "cuda"), None,
                                   launch=runloop.plain_launch(window), window=n * window,
                                   max_steps=9) for i in range(n)]
    want_lo, want_hi = fan_search.elect(
        rows, np.stack([search.offsets_to_numpy(p[0]) for p in plain]),
        np.stack([search.offsets_to_numpy(p[1]) for p in plain]))
    assert np.array_equal(lo, want_lo) and np.array_equal(hi, want_hi)


@pytest.mark.cuda
@pytest.mark.parametrize("batch_shards", [1, 2, 4])
def test_mesh_functions_match_plain_on_the_cards(batch_shards):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the mesh's kernel has no CPU mode")
    from tpu_dpow_torch.parallel import fan_search, mesh_search

    devs = fan_search.fan_devices(-1, "cuda")
    if len(devs) % batch_shards:
        pytest.skip(f"{batch_shards} batch shards do not divide {len(devs)} cards")
    mesh = mesh_search.make_mesh(devs, batch_shards=batch_shards)
    window = cuda_kernel.window(8, 16)
    plain = mesh_search.make_mesh([torch.device("cpu")] * len(devs), batch_shards=batch_shards)
    rows = np.concatenate([seeded_rows(), seeded_rows()[1:2]])  # 8 rows: every split
    before = cuda_kernel.launches
    got = mesh_search.sharded_search_chunk_batch(rows, mesh=mesh, chunk_per_shard=window,
                                                 sublanes=8, iters=16)
    assert cuda_kernel.launches == before + len(devs)
    want = mesh_search.sharded_search_chunk_batch(rows, mesh=plain, chunk_per_shard=window)
    assert np.array_equal(got, want)
    active = np.arange(rows.shape[0]) % 3 != 2
    for act in (None, active):
        lo, hi = mesh_search.sharded_search_run(rows, act, mesh=mesh, chunk_per_shard=window,
                                                max_steps=5, sublanes=8, iters=16)
        wlo, whi = mesh_search.sharded_search_run(rows, act, mesh=plain, chunk_per_shard=window,
                                                  max_steps=5)
        assert np.array_equal(lo, wlo) and np.array_equal(hi, whi)
