"""The port's device fan (parallel/fan_search.py and the engine's
``devices=``) against tpu_dpow's.

An 8-member CPU fan of the port (eight logical members of
``torch.device("cpu")``, each served from a worker thread of its own) runs
beside tpu_dpow's pmap fan over the 8 virtual CPU devices that
tests/conftest.py forces. The same uint32 rows, made from a numpy seed, go
through both: global offsets, per-member local offsets and nonces must be
bit-equal, and for controlled launches every ``LaunchControl`` field per
(row, member). Controlled launches are scripted in lockstep: every member
meets at a barrier inside its poll, member 0 issues the poll's commands, and
all members read after a second barrier, so each member observes each
command at the same window in both packages.

Then the fan engine, ``TorchWorkBackend(devices=N)`` against
``JaxWorkBackend(devices=N)`` on the same scripts (after
tests/test_backend.py's fan tests): cover_range rebases every member shard,
a win is attributed on the winning member's scan clock, a raise reaches
every shard, and the six ``dpow_backend_device_*`` families.
"""

import asyncio
import hashlib
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_dpow.backend.jax_backend import JaxWorkBackend
from tpu_dpow.models import WorkRequest as JaxWorkRequest
from tpu_dpow.ops import control as jctl
from tpu_dpow.ops import search as jsearch
from tpu_dpow.parallel import fan_search as jfan
from tpu_dpow_torch import obs
from tpu_dpow_torch.backend import WorkError, get_backend
from tpu_dpow_torch.backend.torch_backend import TorchWorkBackend
from tpu_dpow_torch.models import WorkRequest
from tpu_dpow_torch.obs import LEDGER
from tpu_dpow_torch.ops import control as tctl
from tpu_dpow_torch.ops import search
from tpu_dpow_torch.parallel import fan_search as tfan
from tpu_dpow_torch.resilience.clock import FakeClock
from tpu_dpow_torch.utils import nanocrypto as nc

from conftest import requires_fan_devices

# The suite runs in parallel worker processes: one intra-op thread each
# keeps these tests from crowding out the others on the same cores.
torch.set_num_threads(1)

pytestmark = requires_fan_devices

N = 8
CHUNK = 256  # tiny member windows: the plain versions stay fast on the CPU
CPU8 = [torch.device("cpu")] * N
EASY = 0xFFF0000000000000
UNREACH = (1 << 64) - 2
MAX_U64 = (1 << 64) - 1
RNG = np.random.default_rng(31)


def val(h: bytes, nonce: int) -> int:
    return int.from_bytes(
        hashlib.blake2b((nonce & MAX_U64).to_bytes(8, "little") + h, digest_size=8).digest(),
        "little",
    )


def rows_of(*spec) -> np.ndarray:
    return np.stack([search.pack_params(h, d, b) for h, d, b in spec])


def jdevs(n: int = N) -> list:
    return jax.devices()[:n]


def chunk_both(rows, n: int = N, chunk: int = CHUNK) -> np.ndarray:
    """fan_search_chunk_batch through both packages; bit-equal or fail."""
    got = tfan.fan_search_chunk_batch(rows, devices=CPU8[:n], chunk_per_shard=chunk)
    want = jfan.fan_search_chunk_batch(rows, devices=jdevs(n), chunk_per_shard=chunk)
    assert got.dtype == np.uint32
    assert np.array_equal(got, np.asarray(want))
    return got


def run_both(rows, active=None, n: int = N, **kw) -> list:
    """fan_search_run through both packages → the port's nonces."""
    lo_t, hi_t = tfan.fan_search_run(rows, active, devices=CPU8[:n], chunk_per_shard=CHUNK, **kw)
    lo_j, hi_j = jfan.fan_search_run(rows, active, devices=jdevs(n), chunk_per_shard=CHUNK, **kw)
    assert np.array_equal(lo_t, np.asarray(lo_j)) and np.array_equal(hi_t, np.asarray(hi_j))
    return [(int(h) << 32) | int(x) for x, h in zip(lo_t, hi_t)]


@pytest.fixture(autouse=True)
def slot_ledger_clean():
    LEDGER.reset()
    yield
    assert LEDGER.outstanding() == {}, LEDGER.outstanding_keys()


# -- the fan functions (tests/test_parallel.py, fan side) ----------------------


@pytest.mark.parametrize("shard", [0, 3, 7])
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
    rows = rows_of((RNG.bytes(32), EASY, int(RNG.integers(0, 1 << 63))))
    fanned = chunk_both(rows)
    single = search.offsets_to_numpy(
        search.search_chunk_batch(search.params_from_numpy(rows), chunk_size=CHUNK * N)
    )
    assert np.array_equal(fanned, single)


def test_batched_requests_independent():
    h0, h1 = RNG.bytes(32), RNG.bytes(32)
    base = 99
    out = chunk_both(rows_of((h0, val(h0, base + 10), base), (h1, MAX_U64, base)))
    assert int(out[0]) <= 10 and int(out[1]) == int(search.SENTINEL)


@pytest.mark.parametrize("n", [2, 4])
def test_partial_width_tiles_its_window(n):
    """A fan narrower than the complement: every row is fanned over the
    same n members, and a nonce planted in the LAST member's sub-range is
    found."""
    h = RNG.bytes(32)
    base = 5000
    rows = rows_of(*[(h, val(h, base + 3), base)] * 4,
                   (h, val(h, base + (n - 1) * CHUNK + 9), base + 11))
    out = chunk_both(rows, n=n)
    assert all(int(o) <= 3 for o in out[:4])
    assert int(out[4]) <= (n - 1) * CHUNK + 9 - 11


def test_fan_search_devices_returns_local_offsets():
    """Caller-baked member bases in, per-member LOCAL offsets out."""
    rows = rows_of(*[(RNG.bytes(32), 0xFFC0000000000000, int(RNG.integers(0, 1 << 63)))
                     for _ in range(3)])
    stacked = np.stack([tfan.stagger(rows, N, 1 << 20)[i] for i in range(N)])
    got = tfan.fan_search_devices(stacked, devices=CPU8, chunk_per_shard=CHUNK)
    want = jfan.fan_search_devices(stacked, devices=jdevs(), chunk_per_shard=CHUNK)
    assert got.shape == (N, 3) and np.array_equal(got, np.asarray(want))
    assert (got != search.SENTINEL).any()
    with pytest.raises(ValueError):
        tfan.fan_search_devices(stacked[:3], devices=CPU8, chunk_per_shard=CHUNK)


def test_stagger_is_the_host_form_of_advance_base():
    rows = rows_of((RNG.bytes(32), EASY, MAX_U64 - 700), (RNG.bytes(32), EASY, 12))
    stacked = tfan.stagger(rows, N, 300)
    for i in range(N):
        want = np.asarray(jsearch.advance_base_batch(jnp.asarray(rows), jnp.uint32(i * 300)))
        assert np.array_equal(stacked[i], want)


def test_run_to_solution():
    h = RNG.bytes(32)
    diff = 0xFFFC000000000000  # ~2^14 expected hashes: a few fanned windows
    nonce = run_both(rows_of((h, diff, int(RNG.integers(0, 1 << 63)))), max_steps=32)[0]
    assert nonce != MAX_U64 and val(h, nonce) >= diff


def test_run_active_mask_skips_padding():
    h = RNG.bytes(32)
    rows = rows_of((h, EASY, 4321), (bytes(32), MAX_U64, 0))
    got = run_both(rows, np.array([True, False]), max_steps=256)
    assert got[0] != MAX_U64 and val(h, got[0]) >= EASY
    assert got[1] == MAX_U64


def test_run_with_a_hit_in_a_later_window_of_a_middle_member():
    """Strided windows: member i's window k covers base + k*N*CHUNK +
    i*CHUNK. The target is the best value over every offset up to the end
    of member 5's third window, for a hash whose best lies in that window:
    that nonce is the election's winner."""
    base = 3 << 50
    lo, hi = 2 * N * CHUNK + 5 * CHUNK, 2 * N * CHUNK + 6 * CHUNK
    rng = np.random.default_rng(5)
    while True:
        h = rng.bytes(32)
        best = max(range(hi), key=lambda j: val(h, base + j))
        if lo <= best:
            break
    assert run_both(rows_of((h, val(h, base + best), base)), max_steps=8) == [base + best]


def test_geometry_and_width_checks():
    with pytest.raises(ValueError):
        tfan.fan_search_chunk_batch(rows_of((bytes(32), 1, 0)), devices=CPU8,
                                    chunk_per_shard=1 << 30)
    with pytest.raises(ValueError, match="visible"):
        tfan.fan_devices(N + 1, "cpu")
    with pytest.raises(ValueError, match="visible"):
        jfan.fan_devices(len(jax.local_devices()) + 1)
    assert tfan.fan_devices(-1, "cpu") == CPU8 and tfan.fan_devices(1, "cpu") == CPU8[:1]
    with pytest.raises(ValueError, match="sublanes"):
        tfan.fan_search_devices(np.zeros((1, 1, 12), np.uint32),
                                devices=[torch.device("cuda", 0)], chunk_per_shard=CHUNK)


# -- fan_search_run_controlled, lockstep-scripted -------------------------------


class ZeroClock:
    def time(self) -> float:
        return 0.0


def lockstep(base, n: int, script):
    """A LaunchControl of ``base``'s package whose members meet at every
    poll: all arrive, member 0 runs ``script(control, k)``, all read."""

    class Lockstep(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.barrier = threading.Barrier(n, timeout=60)

        def poll(self, dev, k, done):
            self.barrier.wait()
            if int(dev) == 0:
                script(self, int(k))
            self.barrier.wait()
            return super().poll(dev, k, done)

    return Lockstep


def per_member(c, rows: int, n: int) -> dict:
    return {
        "polls": c.polls, "last_k": c.last_k,
        "done_at_k": dict(c.done_at_k), "delivered": sorted(c.delivered),
        "poll_k": {d: c.last_poll(d)[1] for d in range(n)},
        "fields": [(c.effective_base(r, d), c.effective_difficulty(r, d),
                    c.effective_epoch(r, -1, d), c.applied_at_k(r, d),
                    c.windows_run(r, 64, d), c.confirmed_no_hit_windows(r, d, 1))
                   for r in range(rows) for d in range(n)],
    }


def controlled_both(stacked, script, *, stride, max_steps, poll_steps):
    n, b = stacked.shape[:2]
    out = {}
    for name, ctl_mod, fan, devs in (("port", tctl, tfan, CPU8), ("jax", jctl, jfan, jdevs())):
        c = lockstep(ctl_mod.LaunchControl, n, script)(b, clock=ZeroClock(), n_dev=n)
        slot = ctl_mod.register(c)
        try:
            lo, hi = fan.fan_search_run_controlled(
                stacked, slot, devices=devs, chunk_per_shard=CHUNK, max_steps=max_steps,
                poll_steps=poll_steps, stride=stride)
            lo, hi = np.asarray(lo), np.asarray(hi)  # forced before the slot dies
        finally:
            ctl_mod.release(slot)
        out[name] = (lo, hi, per_member(c, b, n))
    (lo_t, hi_t, book_t), (lo_j, hi_j, book_j) = out["port"], out["jax"]
    assert np.array_equal(lo_t, lo_j) and np.array_equal(hi_t, hi_j)
    assert book_t == book_j
    return lo_t, hi_t, book_t


def once(tag, k_min, fn):
    def step(c, k):
        fired = c.__dict__.setdefault("fired", set())
        if k >= k_min and tag not in fired:
            fired.add(tag)
            fn(c)

    return step


@pytest.mark.parametrize("policy", ["split", "interleave"])
def test_controlled_fan_with_cancel_raise_and_member_rebase(policy):
    """The engine's two partition policies: 'split' scans contiguously per
    member (stride = the member window), 'interleave' deals windows
    round-robin (stride = N member windows, members staggered by one).
    Row 0 never solves, so every member polls at every block; a cancel, a
    raise and a per-member rebase land at fixed windows."""
    rng = np.random.default_rng(7 if policy == "split" else 8)
    base = int(rng.integers(0, 1 << 62))
    rows = rows_of(
        (rng.bytes(32), UNREACH, base),  # keeps every member polling
        (rng.bytes(32), UNREACH, base + 5),  # cancelled at k >= 2
        (rng.bytes(32), 0xFFF8000000000000, base + 9),  # raised at k = 0
        (rng.bytes(32), 0xFFFFF00000000000, base + 13),  # rebased per member at k >= 1
    )
    if policy == "split":
        stacked, stride = tfan.stagger(rows, N, 1 << 30), CHUNK
    else:
        stacked, stride = tfan.stagger(rows, N, CHUNK), CHUNK * N
    new_bases = [(3 << 40) + d * (1 << 24) for d in range(N)]
    script_steps = [
        once("raise", 0, lambda c: c.raise_difficulty(2, 0xFFFF000000000000, epoch=2)),
        once("rebase", 1, lambda c: c.rebase(3, new_bases, epoch=5)),
        once("cancel", 2, lambda c: c.cancel(1)),
    ]

    def script(c, k):
        for s in script_steps:
            s(c, k)

    lo, hi, book = controlled_both(stacked, script, stride=stride, max_steps=6, poll_steps=1)
    nonces = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    assert (nonces[:, :2] == np.uint64(MAX_U64)).all()  # dry, and cancelled
    assert all(book["done_at_k"][(1, d)] == 2 for d in range(N))
    raised = [int(x) for x in nonces[:, 2] if x != np.uint64(MAX_U64)]
    h2 = search_hash(rows[2])
    assert all(val(h2, x) >= 0xFFFF000000000000 for x in raised)
    for d in range(N):
        assert book["fields"][3 * N + d][0] == new_bases[d]  # member d's own base


def search_hash(row) -> bytes:
    return np.ascontiguousarray(row[:8], dtype=np.uint32).tobytes()


# -- the fan engine against JaxWorkBackend(devices=N) ---------------------------


def both_engines(**kw):
    port = TorchWorkBackend(device="cpu", **kw)
    ref = JaxWorkBackend(kernel="xla", sublanes=8, iters=8, warm_shapes=False, **kw)
    return port, ref


def recording(b, sink, field):
    """Wrap ``b._launch`` to record each fanned launch's per-member row-0
    ``field`` (base or difficulty words)."""
    real = b._launch
    lo_i, hi_i = (search.BASE_LO, search.BASE_HI) if field == "base" else (
        search.DIFF_LO, search.DIFF_HI)

    def launch(params, steps, *args, **kw):
        if params.ndim == 3:
            sink.append([(int(params[d, 0, hi_i]) << 32) | int(params[d, 0, lo_i])
                         for d in range(params.shape[0])])
        return real(params, steps, *args, **kw)

    b._launch = launch


async def _until(pred, what, timeout=15.0):
    deadline = asyncio.get_running_loop().time() + timeout
    while not pred():
        assert asyncio.get_running_loop().time() < deadline, what
        await asyncio.sleep(0.01)


@pytest.mark.parametrize("run_mode", ["chunked", "persistent"])
def test_engine_cover_range_rebases_every_member_shard(run_mode):
    n = 4
    h = RNG.bytes(32).hex().upper()
    start_a, length, start_b = 1 << 30, 1 << 20, 1 << 50
    stride = length // n
    want_a = [start_a + d * stride for d in range(n)]
    want_b = [start_b + d * stride for d in range(n)]

    async def go(b, request):
        await b.setup()
        seen = []
        recording(b, seen, "base")
        t = asyncio.ensure_future(b.generate(request(h, UNREACH, nonce_range=(start_a, length))))
        await _until(lambda: seen, "no fanned launch")
        first = seen[0]
        assert await b.cover_range(h, (start_b, length))
        job = b._jobs[h]
        parts = (job.part_start, job.part_len, list(job.dev_bases))
        if run_mode == "chunked":
            await _until(lambda: want_b in seen, "no launch rebased every shard")
        else:
            rec = next(r for r in b._inflight if r.control is not None)
            await _until(lambda: any(a == "rebase" for _r, a, _l, _t in rec.control.delivered),
                         "the rebase never reached the running launch")
        await b.cancel(h)
        with pytest.raises(Exception) as err:
            await t
        assert "Cancelled" in type(err.value).__name__
        await b.close()
        return first, parts

    port, ref = both_engines(devices=n, device_shard="split", clock=FakeClock(),
                             run_mode=run_mode, pipeline=1, persistent_steps=64)
    got = asyncio.run(asyncio.wait_for(go(port, WorkRequest), 60))
    want = asyncio.run(asyncio.wait_for(go(ref, JaxWorkRequest), 60))
    assert got[0] == want_a == want[0]
    assert got[1][0] == want[1][0] == start_b and got[1][1] == want[1][1] == length
    assert got[1][2][:n] == want_b


def test_engine_win_after_a_mid_launch_cover_runs_on_the_covers_clock():
    """A persistent launch re-aimed by cover_range before it scans: its win
    from range B is attributed with elapsed = FakeClock time since the
    cover (2 s), not left without a scan clock. (The reference stamps the
    clocks only at a dispatch, so at pipeline 1 it attributes nothing here,
    and with a successor dispatched just before the win it attributes a
    huge rate: ROADMAP Queue 3.)"""
    n = 4
    hx = RNG.bytes(32).hex().upper()
    hb = bytes.fromhex(hx)
    start_a, start_b, length = 1 << 40, 5 << 50, n * (1 << 20)
    stride = length // n
    diff, k, off = max((val(hb, start_b + d * stride + j), d, j)
                       for d in range(n) for j in range(8192))

    async def go():
        clock = FakeClock()
        b = TorchWorkBackend(device="cpu", devices=n, run_mode="persistent", pipeline=1,
                             persistent_steps=4, control_poll_steps=1, clock=clock)
        await b.setup()
        start, ran, finish = threading.Event(), threading.Event(), threading.Event()
        real = b._launch

        def gated(params, steps, *args):
            if not start.wait(timeout=10):
                raise TimeoutError("launch never started")
            out = real(params, steps, *args)
            ran.set()
            if not finish.wait(timeout=10):
                raise TimeoutError("launch never finished")
            return out

        b._launch = gated
        task = asyncio.ensure_future(
            b.generate(WorkRequest(hx, diff, nonce_range=(start_a, length))))
        await _until(lambda: any(r.control is not None for r in b._inflight), "no launch")
        await clock.advance(3.0)
        assert await b.cover_range(hx, (start_b, length))
        start.set()
        await _until(ran.is_set, "the launch never ran")
        await clock.advance(2.0)
        finish.set()
        work = await asyncio.wait_for(task, 20)
        await b.close()
        return work, b.last_win

    work, last_win = asyncio.run(asyncio.wait_for(go(), 60))
    assert int(work, 16) == start_b + k * stride + off
    assert last_win["device"] == k and last_win["hashes"] == off + 1
    assert last_win["elapsed"] == pytest.approx(2.0)


def test_engine_win_attributed_on_the_members_scan_clock():
    """The max-value nonce over every member's first window is the target:
    the first fanned launch's unique hit. Both engines attribute it to the
    same member, with hashes = offset + 1 and elapsed = the 2 s the FakeClock
    moved between dispatch and the launch's return."""
    n = 4
    hx = RNG.bytes(32).hex().upper()
    hb = bytes.fromhex(hx)
    start, length = 1 << 40, n * (1 << 20)
    stride = length // n
    best = max((val(hb, start + d * stride + j), d, j)
               for d in range(n) for j in range(8192))
    diff, k, off = best

    async def go(b, request):
        clock = b._clock
        await b.setup()
        gate = threading.Event()
        real = b._launch

        def gated(params, steps, *args, **kw):
            if not gate.wait(timeout=10):
                raise TimeoutError("fan launch gate never released")
            return real(params, steps, *args, **kw)

        b._launch = gated
        task = asyncio.ensure_future(b.generate(request(hx, diff, nonce_range=(start, length))))
        await _until(lambda: b._jobs and next(iter(b._jobs.values())).dev_t0 is not None,
                     "no dispatch")
        await clock.advance(2.0)
        gate.set()
        work = await asyncio.wait_for(task, 20)
        await b.close()
        return work, dict(b.last_win), list(b.device_ema)

    wins0 = obs.snapshot().get("dpow_backend_device_wins_total", {}).get("series", {}).get(str(k), 0)
    port, _ = both_engines(devices=n, clock=FakeClock(), pipeline=1)
    from tpu_dpow.resilience.clock import FakeClock as JaxFakeClock

    ref = JaxWorkBackend(kernel="xla", sublanes=8, iters=8, warm_shapes=False, devices=n,
                         clock=JaxFakeClock(), pipeline=1)
    got = asyncio.run(asyncio.wait_for(go(port, WorkRequest), 60))
    want = asyncio.run(asyncio.wait_for(go(ref, JaxWorkRequest), 60))
    assert got == want
    nc.validate_work(hx, got[0], diff)
    assert got[1]["device"] == k and got[1]["hashes"] == off + 1
    assert got[1]["elapsed"] == pytest.approx(2.0)
    assert obs.snapshot()["dpow_backend_device_wins_total"]["series"][str(k)] == wins0 + 1


def test_engine_raise_reaches_every_member_shard():
    n = 4
    h = RNG.bytes(32).hex().upper()
    low, raised = (1 << 64) - (1 << 30), (1 << 64) - (1 << 20)

    async def go(b, request):
        await b.setup()
        seen = []
        recording(b, seen, "difficulty")
        t = asyncio.ensure_future(b.generate(request(h, low)))
        await _until(lambda: seen, "no fanned launch")
        assert await b.raise_difficulty(h, raised)
        await _until(lambda: [raised] * n in seen, "the raise never reached every shard")
        await b.cancel(h)
        with pytest.raises(Exception):
            await t
        await b.close()
        return seen[0]

    port, ref = both_engines(devices=n, clock=FakeClock())
    assert asyncio.run(asyncio.wait_for(go(port, WorkRequest), 60)) == [low] * n
    assert asyncio.run(asyncio.wait_for(go(ref, JaxWorkRequest), 60)) == [low] * n


@pytest.mark.parametrize("run_mode,policy", [("chunked", "split"), ("persistent", "interleave")])
def test_engine_fan_solves_and_exports_the_device_families(run_mode, policy):
    fams = ("dpow_backend_device_hash_rate_hs", "dpow_backend_device_launches_total",
            "dpow_backend_device_hashes_total", "dpow_backend_device_busy_fraction",
            "dpow_backend_device_wins_total", "dpow_backend_device_ema_hs")

    def series(fam):
        return dict(obs.snapshot().get(fam, {}).get("series", {}))

    launches0 = series(fams[1])

    async def go():
        b = TorchWorkBackend(device="cpu", devices=N, run_mode=run_mode, device_shard=policy)
        await b.setup()
        hashes = [RNG.bytes(32).hex().upper() for _ in range(3)]
        works = await asyncio.gather(*(b.generate(WorkRequest(h, EASY)) for h in hashes))
        for h, w in zip(hashes, works):
            nc.validate_work(h, w, EASY)
        await b.close()
        return b

    b = asyncio.run(asyncio.wait_for(go(), 60))
    assert b.last_win is not None and 0 <= b.last_win["device"] < N
    snap = obs.snapshot()
    for fam in fams:
        assert snap[fam]["labels"] == ["device"], fam
    for d in map(str, range(N)):
        assert series(fams[1]).get(d, 0) > launches0.get(d, 0), d
        assert series(fams[2]).get(d, 0) > 0
        assert 0.0 <= series(fams[3])[d] <= 1.0
        assert series(fams[0]).get(d, 0) >= 0


def test_engine_fan_options():
    with pytest.raises(WorkError, match="visible"):
        TorchWorkBackend(device="cpu", devices=N + 1)
    with pytest.raises(WorkError):
        TorchWorkBackend(device="cpu", devices=2, device_shard="diagonal")
    b = TorchWorkBackend(device="cpu", devices=-1)
    assert len(b.fan) == N and b.chunk == N * b.chunk_per_shard
    one = TorchWorkBackend(device="cpu", devices=1)
    assert one.fan == CPU8[:1] and one.chunk == one.chunk_per_shard
    ref = JaxWorkBackend(kernel="xla", sublanes=8, iters=8, devices=-1)
    assert b.chunk == ref.chunk and b.chunk_per_shard == ref.chunk_per_shard
    got = get_backend("torch", device="cpu", devices=2, device_shard="interleave")
    assert len(got.fan) == 2 and got.device_shard == "interleave"


def test_both_fan_engines_return_the_same_work_for_a_pinned_request():
    """The slice as a whole: one pinned request through both fan engines
    (8 members, split, pipeline 1) returns the same work."""
    h = RNG.bytes(32).hex().upper()
    base = (11 << 32) - 3000

    async def solve(b, req):
        await b.setup()
        try:
            return await b.generate(req)
        finally:
            await b.close()

    port, ref = both_engines(devices=N, pipeline=1)
    work_t = asyncio.run(asyncio.wait_for(solve(port, WorkRequest(h, EASY, nonce_range=(base, 0))), 60))
    work_j = asyncio.run(asyncio.wait_for(solve(ref, JaxWorkRequest(h, EASY, nonce_range=(base, 0))), 120))
    assert work_t == work_j
    nc.validate_work(h, work_t, EASY)
