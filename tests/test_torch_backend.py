"""TorchWorkBackend on the CPU (plain version) and against JaxWorkBackend.

The engine-level checks mirror tests/test_backend.py's: self-test, dedup,
cancel race, raise, cover_range and host revalidation. For the slice as a
whole, the same rows at the same geometry go through
``TorchWorkBackend._launch`` and ``JaxWorkBackend(kernel="pallas",
interpret=True)._launch``, and one pinned ``WorkRequest`` through both
engines; everything is bit-exact.
"""

import asyncio
import hashlib
import struct
import threading

import numpy as np
import pytest
import torch

from tpu_dpow.backend.jax_backend import JaxWorkBackend
from tpu_dpow.ops import search as jax_search
from tpu_dpow_torch.backend import WorkCancelled, WorkError, get_backend
from tpu_dpow_torch.backend.torch_backend import TorchWorkBackend
from tpu_dpow_torch.models import WorkRequest
from tpu_dpow_torch.ops import search
from tpu_dpow_torch.utils import nanocrypto as nc

# The suite runs in parallel worker processes: one intra-op thread each
# keeps these tests from crowding out the others on the same cores.
torch.set_num_threads(1)

RNG = np.random.default_rng(23)
EASY = 0xFFF0000000000000
HARD = 0xFFFFFFFFFFFFF000
MAX_U64 = (1 << 64) - 1
GEOMETRY = dict(sublanes=8, iters=4, nblocks=2, group=2)


def random_hash() -> str:
    return RNG.bytes(32).hex().upper()


def ref_value(nonce: int, h: bytes) -> int:
    return int.from_bytes(
        hashlib.blake2b(struct.pack("<Q", nonce & MAX_U64) + h, digest_size=8).digest(),
        "little",
    )


def cpu_backend(**kw) -> TorchWorkBackend:
    return TorchWorkBackend(device="cpu", **kw)


def run(coro, timeout=60):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def test_get_backend_and_defaults():
    b = get_backend("torch", device="cpu")
    assert isinstance(b, TorchWorkBackend)
    assert b.device.type == "cpu" and b.max_batch == 16
    assert (b.sublanes, b.iters, b.nblocks, b.group) == (8, 8, 1, 1)
    with pytest.raises(ValueError):
        get_backend("jax")
    with pytest.raises(WorkError):
        cpu_backend(sublanes=1024, iters=1 << 16)  # window >= 2^31
    with pytest.raises(WorkError):
        TorchWorkBackend(device="meta")


def test_default_device_is_cuda_and_refuses_without_one():
    if torch.cuda.is_available():
        assert TorchWorkBackend().device.type == "cuda"
    else:
        with pytest.raises(WorkError, match="device='cpu'"):
            TorchWorkBackend()


def test_gpu_geometry_defaults_keep_the_window_limits():
    """The GPU defaults (read without a card): one window of 2^25 nonces,
    and run_steps windows per launch below 2^31."""
    from tpu_dpow_torch.backend import torch_backend as tb

    sub, it, nb, grp = tb._GEOMETRY["cuda"]
    window = sub * 128 * it * nb
    assert window == 1 << 25
    assert tb._RUN_STEPS["cuda"] * window < 1 << 31


def test_setup_self_test_and_generate():
    async def go():
        b = cpu_backend()
        await b.setup()
        h = random_hash()
        work = await b.generate(WorkRequest(h, EASY))
        nc.validate_work(h, work, EASY)
        assert b.total_solutions == 1 and b.total_hashes > 0
        await b.close()

    run(go())


def test_setup_fails_when_the_launch_is_wrong():
    async def go():
        b = cpu_backend()
        b._launch = lambda p, s, slot=0, devices=None: (np.array([5], np.uint32), np.array([0], np.uint32))
        with pytest.raises(WorkError, match="self-test"):
            await b.setup()
        await b.close()

    run(go())


def test_batch_of_distinct_hashes():
    async def go():
        b = cpu_backend()
        await b.setup()
        hashes = [random_hash() for _ in range(5)]
        works = await asyncio.gather(*[b.generate(WorkRequest(h, EASY)) for h in hashes])
        for h, w in zip(hashes, works):
            nc.validate_work(h, w, EASY)
        await b.close()

    run(go())


def test_dedup_shares_one_job_and_raises_its_target():
    async def go():
        b = cpu_backend()
        await b.setup()
        h = random_hash()
        t1 = asyncio.ensure_future(b.generate(WorkRequest(h, EASY)))
        await asyncio.sleep(0)
        assert len(b._jobs) == 1
        t2 = asyncio.ensure_future(b.generate(WorkRequest(h, 0xFFF8000000000000)))
        await asyncio.sleep(0)
        assert len(b._jobs) == 1
        assert b._jobs[nc.validate_block_hash(h)].difficulty == 0xFFF8000000000000
        w1, w2 = await asyncio.gather(t1, t2)
        assert w1 == w2
        nc.validate_work(h, w1, 0xFFF8000000000000)
        await b.close()

    run(go())


def test_last_waiter_out_keeps_shared_job():
    async def go():
        b = cpu_backend()
        await b.setup()
        h = random_hash()
        keeper = asyncio.ensure_future(b.generate(WorkRequest(h, EASY)))
        impatient = asyncio.ensure_future(b.generate(WorkRequest(h, EASY)))
        await asyncio.sleep(0)
        impatient.cancel()
        work = await keeper
        nc.validate_work(h, work, EASY)
        await b.close()

    run(go())


def test_cancel_race_mid_flight():
    async def go():
        b = cpu_backend()
        await b.setup()
        h = random_hash()
        task = asyncio.ensure_future(b.generate(WorkRequest(h, MAX_U64)))
        await asyncio.sleep(0.2)
        assert b._inflight  # a launch is on the device
        await b.cancel(h)
        await b.cancel(h)  # idempotent
        with pytest.raises(WorkCancelled):
            await task
        # The engine keeps serving after the cancelled job drains.
        h2 = random_hash()
        nc.validate_work(h2, await b.generate(WorkRequest(h2, EASY)), EASY)
        await b.close()

    run(go())


def test_raise_difficulty_on_a_running_job():
    async def go():
        b = cpu_backend()
        await b.setup()
        h = random_hash()
        task = asyncio.ensure_future(b.generate(WorkRequest(h, EASY)))
        await asyncio.sleep(0)
        assert await b.raise_difficulty(h, 0xFFFE000000000000)
        work = await task
        nc.validate_work(h, work, 0xFFFE000000000000)
        assert not await b.raise_difficulty(h, MAX_U64)  # solved: too late
        assert not await b.raise_difficulty(random_hash(), EASY)  # unknown
        await b.close()

    run(go())


def test_weak_hit_after_raise_searches_on():
    """A launch dispatched at the old target returns a nonce that only meets
    it: the engine rewinds past that nonce and keeps searching."""
    async def go():
        b = cpu_backend(pipeline=1)
        await b.setup()
        h = random_hash()
        hb = bytes.fromhex(h)
        launched, raised = [], threading.Event()
        real = b._launch

        def spy(params, steps, slot=0, devices=None):
            launched.append(int(params[0, search.DIFF_HI]) << 32 | int(params[0, search.DIFF_LO]))
            raised.wait(10)  # the first launch returns only after the raise
            return real(params, steps, slot)

        b._launch = spy
        task = asyncio.ensure_future(b.generate(WorkRequest(h, 0xFF00000000000000)))
        while not launched:
            await asyncio.sleep(0.001)
        assert await b.raise_difficulty(h, 0xFFFF000000000000)
        raised.set()
        work = await task
        assert ref_value(int(work, 16), hb) >= 0xFFFF000000000000
        assert launched[0] == 0xFF00000000000000
        await b.close()

    run(go())


def test_cover_range_rebases_a_running_job():
    async def go():
        b = cpu_backend(pipeline=1)
        await b.setup()
        h = random_hash()
        task = asyncio.ensure_future(b.generate(WorkRequest(h, MAX_U64)))
        await asyncio.sleep(0.1)
        job = b._jobs[nc.validate_block_hash(h)]
        assert await b.cover_range(h, (123 << 40, 1 << 30))
        assert job.base == 123 << 40 and job.epoch == 1
        assert not await b.cover_range(random_hash(), (0, 0))
        await b.cancel(h)
        with pytest.raises(WorkCancelled):
            await task
        await b.close()

    run(go())


def test_nonce_range_pins_the_base():
    async def go():
        b = cpu_backend(pipeline=1)
        await b.setup()
        h = random_hash()
        base = (7 << 32) - 50
        work = await b.generate(WorkRequest(h, EASY, nonce_range=(base, 0)))
        nonce = int(work, 16)
        # The first hit at or after the pinned base, found by brute force.
        hb = bytes.fromhex(h)
        first = next(n for n in range(base, base + 200000) if ref_value(n, hb) >= EASY)
        assert nonce == first
        await b.close()

    run(go())


def test_host_revalidation_rejects_bad_device_results():
    async def go():
        b = cpu_backend()
        await b.setup()

        def bogus(params, steps, slot=0, devices=None):  # claims offset 0 solves every row
            n = params.shape[0]
            return params[:, search.BASE_LO].copy(), params[:, search.BASE_HI].copy()

        b._launch = bogus
        with pytest.raises(WorkError, match="invalid work"):
            await b.generate(WorkRequest(random_hash(), HARD))
        await b.close()

    run(go())


def test_close_fails_waiters_and_generate_after_close():
    async def go():
        b = cpu_backend()
        await b.setup()
        task = asyncio.ensure_future(b.generate(WorkRequest(random_hash(), MAX_U64)))
        await asyncio.sleep(0.1)
        await b.close()
        with pytest.raises(WorkCancelled):
            await task
        with pytest.raises(WorkError):
            await b.generate(WorkRequest(random_hash(), EASY))

    run(go())


# -- parity with the JAX engine -----------------------------------------------


def jax_engine(**kw) -> JaxWorkBackend:
    return JaxWorkBackend(kernel="pallas", interpret=True, warm_shapes=False, **GEOMETRY, **kw)


def test_step_ladder_and_rungs_match_jax_engine():
    torch_b = cpu_backend(run_steps=16, **GEOMETRY)
    jax_b = jax_engine(run_steps=16)
    assert torch_b.chunk == jax_b.chunk
    assert torch_b._step_counts() == jax_b._step_counts()
    assert torch_b._batch_sizes() == jax_b._batch_sizes()
    assert torch_b.shared_steps_cap == jax_b.shared_steps_cap
    for d in (1, EASY, 0xFFFF000000000000, HARD, MAX_U64):
        assert torch_b._steps_for(d) == jax_b._steps_for(d), hex(d)
        assert torch_b._miss_factor(d, 4096) == jax_b._miss_factor(d, 4096)
    np.testing.assert_array_equal(TorchWorkBackend._PAD_ROW, jax_search.pack_params(bytes(32), 0, 0))


def test_offsets_to_nonces_matches_jax_engine():
    rows = np.stack([
        search.pack_params(bytes(32), EASY, b)
        for b in (0, (1 << 32) - 1, MAX_U64 - 3, 12345)
    ])
    offs = np.array([0, 5, 10, 0xFFFFFFFF], dtype=np.uint32)
    got = TorchWorkBackend._offsets_to_nonces(rows, offs)
    want = JaxWorkBackend._offsets_to_nonces(rows, offs)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("steps", [1, 2])
def test_launch_matches_jax_pallas_engine(steps):
    """The slice as a whole: the same rows at the same geometry through both
    engines' ``_launch`` (pads, 2^32 and 2^64 carries, easy, dry rows)."""
    rng = np.random.default_rng(31 + steps)
    rows = np.stack([
        search.pack_params(rng.bytes(32), EASY, int(rng.integers(0, 1 << 62))),
        search.pack_params(rng.bytes(32), EASY, (3 << 32) - 40),
        search.pack_params(rng.bytes(32), 0xFFFC000000000000, MAX_U64 - 40),
        search.pack_params(rng.bytes(32), MAX_U64, int(rng.integers(0, 1 << 62))),
        TorchWorkBackend._PAD_ROW,
        TorchWorkBackend._PAD_ROW,
    ])
    lo_t, hi_t = cpu_backend(run_steps=4, **GEOMETRY)._launch(rows, steps)
    lo_j, hi_j = jax_engine(run_steps=4)._launch(rows, steps)
    np.testing.assert_array_equal(lo_t, lo_j)
    np.testing.assert_array_equal(hi_t, hi_j)
    assert lo_t[3] == hi_t[3] == 0xFFFFFFFF  # the dry row


def test_both_engines_return_the_same_work_for_a_pinned_request():
    h = random_hash()
    base = (9 << 32) - 1000
    req = WorkRequest(h, EASY, nonce_range=(base, 0))

    async def solve(b):
        await b.setup()
        try:
            return await b.generate(req)
        finally:
            await b.close()

    from tpu_dpow.models import WorkRequest as JaxWorkRequest

    work_t = run(solve(cpu_backend(pipeline=1, **GEOMETRY)))
    jax_b = jax_engine(pipeline=1)

    async def solve_jax():
        await jax_b.setup()
        try:
            return await jax_b.generate(JaxWorkRequest(h, EASY, nonce_range=(base, 0)))
        finally:
            await jax_b.close()

    work_j = run(solve_jax(), timeout=120)
    assert work_t == work_j
    nc.validate_work(h, work_t, EASY)
