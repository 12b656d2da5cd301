"""TorchWorkBackend in persistent run mode, on the CPU (plain version).

Mirrors tests/test_persistent.py's engine-level scenarios on the plain
single-device path: generate and validate, mid-launch cancel, raise and
cover_range delivered to a RUNNING launch, the stale-epoch kill, the four
``dpow_backend_persistent_*`` families, FakeClock effect latency, bad
options, and dedup with a concurrent batch. For the slice as a whole, one
pinned ``WorkRequest`` returns the same work from ``JaxWorkBackend`` and
``TorchWorkBackend`` in persistent mode. The port's slot ledger reads zero
outstanding after every engine test.
"""

import asyncio
import hashlib
import itertools

import numpy as np
import pytest
import torch

from tpu_dpow.backend.jax_backend import JaxWorkBackend
from tpu_dpow_torch import obs
from tpu_dpow_torch.backend import WorkCancelled, WorkError, get_backend
from tpu_dpow_torch.backend.torch_backend import TorchWorkBackend
from tpu_dpow_torch.models import WorkRequest
from tpu_dpow_torch.obs import LEDGER
from tpu_dpow_torch.resilience.clock import FakeClock
from tpu_dpow_torch.utils import nanocrypto as nc

# The suite runs in parallel worker processes: one intra-op thread each
# keeps these tests from crowding out the others on the same cores.
torch.set_num_threads(1)

RNG = np.random.default_rng(12)
EASY = 0xFFF0000000000000
UNREACH = (1 << 64) - 2  # unreachable target that is still a valid raise
MAX_U64 = (1 << 64) - 1


def val(h: bytes, nonce: int) -> int:
    return int.from_bytes(
        hashlib.blake2b(nonce.to_bytes(8, "little") + h, digest_size=8).digest(), "little"
    )


def plant_above(h: bytes, start: int, floor: int) -> int:
    return next(n for n in itertools.count(start) if val(h, n) > floor)


def random_hash() -> str:
    return RNG.bytes(32).hex().upper()


def make_persistent(**kw) -> TorchWorkBackend:
    return TorchWorkBackend(device="cpu", run_mode="persistent", **kw)


def run(coro, timeout=60):
    return asyncio.run(asyncio.wait_for(coro, timeout))


@pytest.fixture(autouse=True)
def slot_ledger_clean():
    LEDGER.reset()
    yield
    assert LEDGER.outstanding() == {}, LEDGER.outstanding_keys()


async def _inflight_control(b, h):
    """Wait until a live persistent launch carries the job; (rec, row)."""
    loop = asyncio.get_running_loop()
    deadline = loop.time() + 10.0
    while True:
        job = b._jobs.get(h)
        if job is not None:
            recs = b._live_controls(job)
            if recs:
                return recs[-1]
        assert loop.time() < deadline, "no persistent launch picked up the job"
        await asyncio.sleep(0.005)


async def _drained(b, timeout=20.0):
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    while b._inflight:
        assert loop.time() < deadline, "persistent launches never drained"
        await asyncio.sleep(0.005)


def _metric(name, label=None):
    series = obs.snapshot().get(name, {}).get("series", {})
    if label is None:
        return series
    v = series.get(label, 0)
    return v.get("count", 0) if isinstance(v, dict) else v


def test_persistent_defaults_match_the_jax_engine():
    torch_b = make_persistent()
    jax_b = JaxWorkBackend(kernel="xla", sublanes=8, iters=8, run_mode="persistent")
    assert torch_b.chunk == jax_b.chunk
    assert torch_b.persistent_steps == jax_b.persistent_steps >= 10 * torch_b.run_steps
    assert torch_b.control_poll_steps == jax_b.control_poll_steps == 1
    assert torch_b._step_counts() == jax_b._step_counts() == [1, torch_b.persistent_steps]
    for d in (1, EASY, UNREACH):
        assert torch_b._steps_for(d) == jax_b._steps_for(d) == torch_b.persistent_steps
    assert get_backend("torch", device="cpu").run_mode == "chunked"


def test_gpu_persistent_defaults():
    """Read without a card: polls every 2 windows, launches of 16x run_steps."""
    from tpu_dpow_torch.backend import torch_backend as tb

    assert tb._POLL_STEPS["cuda"] == 2
    b = make_persistent(run_steps=16)
    assert b.persistent_steps == 256


def test_persistent_generate_and_validate():
    async def go():
        b = make_persistent()
        await b.setup()
        h = random_hash()
        work = await b.generate(WorkRequest(h, EASY))
        nc.validate_work(h, work, EASY)
        await b.close()

    run(go())


def test_successor_launches_keep_their_full_span():
    """The shared_steps_cap demotion does not apply to persistent launches:
    a pipelined successor is steerable and runs span-sized."""
    from tpu_dpow_torch.backend.torch_backend import _Job
    from tpu_dpow_torch.ops import control as ctl
    from tpu_dpow_torch.ops import search

    async def go():
        b = make_persistent(run_steps=4)
        loop = asyncio.get_running_loop()
        b._submit_launch = lambda params, steps, slot=0, **kw: loop.create_future()
        h = random_hash()
        params = search.pack_params(bytes.fromhex(h), UNREACH, 0)
        b._jobs[h] = _Job(h, UNREACH, params, loop.create_future(), 0)
        rec = b._dispatch_next(inflight=1)
        assert rec.steps == b.persistent_steps > b.shared_steps_cap
        assert rec.control is not None and rec.slot
        ctl.release(rec.slot)

    run(go())


def test_persistent_cancel_lands_mid_launch():
    async def go():
        b = make_persistent()
        await b.setup()
        before = _metric("dpow_backend_persistent_control_total", "cancel")
        h = random_hash()
        t = asyncio.ensure_future(b.generate(WorkRequest(h, UNREACH)))
        rec, _row = await _inflight_control(b, h)
        await b.cancel(h)
        with pytest.raises(WorkCancelled):
            await t
        await _drained(b)  # the launch returned: rows freed, not ground out
        assert "cancel" in {a for _r, a, _l, _t in rec.control.delivered}
        assert _metric("dpow_backend_persistent_control_total", "cancel") > before
        assert rec.control.windows_run(0, rec.steps) < rec.steps
        await b.close()

    run(go())


def test_persistent_raise_difficulty_lands_mid_launch():
    async def go():
        b = make_persistent()
        await b.setup()
        h = random_hash()
        t = asyncio.ensure_future(b.generate(WorkRequest(h, UNREACH - 1)))
        rec, row = await _inflight_control(b, h)
        assert await b.raise_difficulty(h, UNREACH)
        loop = asyncio.get_running_loop()
        deadline = loop.time() + 10.0
        while not any(a == "raise" for _r, a, _l, _t in rec.control.delivered):
            assert loop.time() < deadline, "raise never delivered to the running launch"
            await asyncio.sleep(0.005)
        assert rec.control.effective_difficulty(row) == UNREACH
        job = b._jobs[h]
        assert job.difficulty == UNREACH
        assert job.inflight_miss < 1.0, "raised job lost its coverage"
        await b.cancel(h)
        with pytest.raises(WorkCancelled):
            await t
        await b.close()

    run(go())


def test_persistent_cover_range_rebases_mid_launch():
    async def go():
        b = make_persistent()
        await b.setup()
        hx = random_hash()
        h = bytes.fromhex(hx)
        start_a, length = 1 << 30, 1 << 22
        span = b.chunk * b.persistent_steps
        floor = max(val(h, start_a + j) for j in range(min(span * 2, 1 << 19)))
        start_b = 5 << 45
        planted = plant_above(h, start_b, floor)
        diff = val(h, planted)
        t = asyncio.ensure_future(
            b.generate(WorkRequest(hx, diff, nonce_range=(start_a, length)))
        )
        rec, row = await _inflight_control(b, hx)
        epoch_before = rec.epochs[row]
        assert await b.cover_range(hx, (start_b, length))
        assert b._jobs[hx].epoch == epoch_before + 1
        work = await asyncio.wait_for(t, 30)
        assert int(work, 16) >= start_b, f"winner {work} is not from the re-covered range"
        nc.validate_work(hx, work, diff)
        assert "rebase" in [a for _r, a, _l, _t in rec.control.delivered]
        assert rec.control.effective_base(row) == start_b
        await b.close()

    run(go(), timeout=90)


def test_persistent_stale_epoch_launch_is_killed_not_rebased():
    """Two live launches carry the job: cover_range rebases the NEWEST and
    kills the job's row in the older one — its control word is dead."""

    async def go():
        b = make_persistent()
        await b.setup()
        h = random_hash()
        t = asyncio.ensure_future(b.generate(WorkRequest(h, UNREACH)))
        loop = asyncio.get_running_loop()
        ready = loop.time() + 15.0
        while True:
            job = b._jobs.get(h)
            recs = b._live_controls(job) if job is not None else []
            if len(recs) >= 2:
                break
            assert loop.time() < ready, f"pipeline never filled ({len(recs)})"
            await asyncio.sleep(0.005)
        (old_rec, old_row), (new_rec, _new_row) = recs[0], recs[-1]
        assert await b.cover_range(h, (7 << 40, 1 << 24))
        assert not old_rec.control.rebase(old_row, 1, epoch=99)  # dead word
        deadline = loop.time() + 15.0
        while True:
            old_acts = {a for _r, a, _l, _t in old_rec.control.delivered}
            new_acts = {a for _r, a, _l, _t in new_rec.control.delivered}
            if "cancel" in old_acts and "rebase" in new_acts:
                break
            assert loop.time() < deadline, (old_acts, new_acts)
            await asyncio.sleep(0.005)
        assert "rebase" not in old_acts, "stale launch was steered"
        await b.cancel(h)
        with pytest.raises(WorkCancelled):
            await t
        await b.close()

    run(go())


def test_persistent_metrics_exported():
    async def go():
        polls0 = _metric("dpow_backend_persistent_polls_total").get("", 0)
        windows0 = _metric("dpow_backend_persistent_launch_windows", "")
        b = make_persistent()
        await b.setup()
        h = random_hash()
        t = asyncio.ensure_future(b.generate(WorkRequest(h, UNREACH)))
        await _inflight_control(b, h)
        await b.cancel(h)
        with pytest.raises(WorkCancelled):
            await t
        await _drained(b)
        await b.close()
        snap = obs.snapshot()
        assert snap["dpow_backend_persistent_polls_total"]["series"][""] > polls0
        assert snap["dpow_backend_persistent_launch_windows"]["series"][""]["count"] > windows0
        assert snap["dpow_backend_persistent_effect_seconds"]["series"][""]["count"] >= 1
        assert snap["dpow_backend_persistent_control_total"]["labels"] == ["action"]

    run(go())


def test_persistent_effect_latency_deterministic_under_fake_clock():
    async def go():
        b = make_persistent(clock=FakeClock())
        await b.setup()
        h = random_hash()
        t = asyncio.ensure_future(b.generate(WorkRequest(h, UNREACH)))
        rec, _row = await _inflight_control(b, h)
        await b.cancel(h)
        with pytest.raises(WorkCancelled):
            await t
        loop = asyncio.get_running_loop()
        deadline = loop.time() + 20.0
        while not rec.control.delivered:
            assert loop.time() < deadline
            await asyncio.sleep(0.005)
        assert all(lat == 0.0 for _r, _a, lat, _t in rec.control.delivered)
        await b.close()

    run(go())


def test_persistent_rejects_bad_options():
    with pytest.raises(WorkError):
        TorchWorkBackend(device="cpu", run_mode="sideways")
    with pytest.raises(WorkError):
        make_persistent(control_poll_steps=-1)


def test_persistent_dedup_and_concurrent_batch():
    async def go():
        b = make_persistent(max_batch=8)
        await b.setup()
        hashes = [random_hash() for _ in range(6)]
        works = await asyncio.gather(*(b.generate(WorkRequest(h, EASY)) for h in hashes))
        for h, w in zip(hashes, works):
            nc.validate_work(h, w, EASY)
        h = random_hash()
        a, bb = await asyncio.gather(
            b.generate(WorkRequest(h, EASY)), b.generate(WorkRequest(h, 0xFFF8000000000000))
        )
        assert a == bb
        nc.validate_work(h, a, 0xFFF8000000000000)
        await b.close()

    run(go(), timeout=120)


def test_close_cancels_running_persistent_launches():
    async def go():
        b = make_persistent()
        await b.setup()
        h = random_hash()
        t = asyncio.ensure_future(b.generate(WorkRequest(h, UNREACH)))
        rec, _row = await _inflight_control(b, h)
        await b.close()
        with pytest.raises(WorkCancelled):
            await t
        assert "cancel" in {a for _r, a, _l, _t in rec.control.delivered}

    run(go())


def test_both_engines_return_the_same_work_for_a_pinned_request():
    """The slice as a whole: one pinned request through both engines in
    persistent mode at pipeline=1."""
    from tpu_dpow.models import WorkRequest as JaxWorkRequest

    h = random_hash()
    base = (11 << 32) - 3000

    async def solve(b, req):
        await b.setup()
        try:
            return await b.generate(req)
        finally:
            await b.close()

    work_t = run(solve(make_persistent(pipeline=1), WorkRequest(h, EASY, nonce_range=(base, 0))))
    jax_b = JaxWorkBackend(
        kernel="xla", sublanes=8, iters=8, run_mode="persistent", pipeline=1,
        warm_shapes=False,
    )
    work_j = run(solve(jax_b, JaxWorkRequest(h, EASY, nonce_range=(base, 0))), timeout=120)
    assert work_t == work_j
    nc.validate_work(h, work_t, EASY)


def test_close_lets_a_queued_launch_start_and_take_its_cancel():
    """close() with a pipelined successor whose thread has not started: the
    successor is not cancelled unstarted (its rows' cancel would then never
    be delivered, as the reference never does); it starts, takes the
    cancel at its first poll and returns, and its slot is released."""
    import concurrent.futures
    import threading

    async def go():
        b = make_persistent()
        await b.setup()
        b._executor = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        gate = threading.Event()
        real = b._launch

        def gated(*args):
            gate.wait(10)
            return real(*args)

        b._launch = gated
        h = random_hash()
        t = asyncio.ensure_future(b.generate(WorkRequest(h, UNREACH)))
        loop = asyncio.get_running_loop()
        deadline = loop.time() + 10.0
        while len(b._live_controls(b._jobs[h]) if h in b._jobs else ()) < 2:
            assert loop.time() < deadline, "the pipeline never filled"
            await asyncio.sleep(0.005)
        recs = [rec for rec, _row in b._live_controls(b._jobs[h])]
        closer = asyncio.ensure_future(b.close())
        await asyncio.sleep(0.05)
        gate.set()
        await asyncio.wait_for(closer, 20)
        with pytest.raises(WorkCancelled):
            await t
        for rec in recs:
            assert rec.thread_done.is_set()
            assert "cancel" in {a for _r, a, _l, _t in rec.control.delivered}

    run(go())
