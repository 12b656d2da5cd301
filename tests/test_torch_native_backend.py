"""The port's native C++ engine against tpu_dpow's (after
tests/test_native_backend.py).

``tpu_dpow_torch.backend.native_backend`` builds its own copy of
``blake2b_worker.cc`` into ``tpu_dpow_torch/native/_build/``. Its library
must give the reference library's work values and nonces bit for bit (and
hashlib's), its engine must pass the reference engine's suite, and its build
must write nowhere but its own build directory.
"""

import asyncio
import ctypes
import hashlib
import os
import shutil

import numpy as np
import pytest

from tpu_dpow.backend import native_backend as jnb
from tpu_dpow_torch.backend import WorkCancelled, get_backend
from tpu_dpow_torch.backend import native_backend as nb
from tpu_dpow_torch.models import WorkRequest
from tpu_dpow_torch.utils import nanocrypto as nc

pytestmark = pytest.mark.skipif(
    shutil.which("g++") is None, reason="no C++ toolchain"
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RNG = np.random.default_rng(11)
EASY = 0xFFF0000000000000  # ~1 in 4096 nonces
HARD = 0xFFFFFFFFFFFFF000  # ~2^52 expected: never found within a test


def random_hash() -> str:
    return RNG.bytes(32).hex().upper()


def ref_value(h: bytes, nonce: int) -> int:
    return int.from_bytes(
        hashlib.blake2b(nonce.to_bytes(8, "little") + h, digest_size=8).digest(), "little"
    )


def search(lib, h: bytes, difficulty: int, base: int, count: int, threads: int):
    nonce_out, done = ctypes.c_uint64(0), ctypes.c_uint64(0)
    rc = lib.bw_search_range(h, difficulty, base, count, threads, None,
                             ctypes.byref(nonce_out), ctypes.byref(done))
    return rc, int(nonce_out.value), int(done.value)


# -- the two libraries against each other and hashlib ----------------------------


def test_native_work_value_of_both_libraries_equals_hashlib():
    rng = np.random.default_rng(2026)
    edges = [0, 1, 0xFFFFFFFF, 1 << 32, (1 << 63) - 1, 1 << 63, (1 << 64) - 1]
    nonces = edges + [int(x) for x in rng.integers(0, 1 << 64, size=256 - len(edges),
                                                    dtype=np.uint64)]
    for nonce in nonces:
        h = rng.bytes(32)
        want = ref_value(h, nonce)
        assert nb.native_work_value(h.hex(), nonce) == want
        assert jnb.native_work_value(h.hex(), nonce) == want


@pytest.mark.parametrize("base", [1 << 40, (1 << 64) - (1 << 13)])  # the second wraps 2^64
def test_search_range_with_one_planted_hit_gives_both_libraries_the_same_nonce(base):
    rng = np.random.default_rng(base & 0xFFFF)
    h = rng.bytes(32)
    count = 1 << 14
    values = [ref_value(h, (base + i) & nc.MAX_U64) for i in range(count)]
    best = max(values)
    assert values.count(best) == 1  # exactly one nonce of the range meets it
    want = (base + values.index(best)) & nc.MAX_U64
    got = search(nb.load_library(), h, best, base, count, 4)
    ref = search(jnb.load_library(), h, best, base, count, 4)
    assert got[:2] == ref[:2] == (1, want)


def test_port_build_writes_only_under_its_build_directory(tmp_path, monkeypatch):
    # The reference's override steers the reference's build_library, never the port's.
    monkeypatch.setenv("TPU_DPOW_NATIVE_DIR", str(tmp_path / "reference"))
    written = []
    real_run, real_rename, real_open = nb.subprocess.run, os.rename, open

    def run(cmd, *a, **kw):
        written.append(cmd[cmd.index("-o") + 1])
        return real_run(cmd, *a, **kw)

    def rename(src, dst):
        written.append(dst)
        return real_rename(src, dst)

    def opener(path, mode="r", *a, **kw):
        if set(mode) & set("wax+"):
            written.append(path)
        return real_open(path, mode, *a, **kw)

    monkeypatch.setattr(nb.subprocess, "run", run)
    monkeypatch.setattr(nb.os, "rename", rename)
    monkeypatch.setattr(nb, "open", opener, raising=False)
    path = nb.build_library(force=True)
    build_dir = os.path.join(REPO, "tpu_dpow_torch", "native", "_build")
    assert os.path.dirname(path) == build_dir
    assert os.path.exists(path + ".stamp")
    assert len(written) == 3 and all(os.path.dirname(w) == build_dir for w in written)
    assert not (tmp_path / "reference").exists()
    # The port's own override moves its output, stamp included.
    monkeypatch.setenv("TPU_DPOW_TORCH_NATIVE_DIR", str(tmp_path / "port"))
    moved = nb.build_library()
    assert moved == str(tmp_path / "port" / "libblake2b_worker.so")
    assert sorted(os.listdir(tmp_path / "port")) == [
        "libblake2b_worker.so", "libblake2b_worker.so.stamp"]


# -- twins of tests/test_native_backend.py ---------------------------------------


def test_native_work_value_bit_exact_vs_hashlib():
    h = bytes(range(32))
    for nonce in [0, 1, 0xDEADBEEF, 2**63 + 7, 2**64 - 1,
                  *map(int, RNG.integers(0, 2**63, 16))]:
        assert nb.native_work_value(h.hex(), nonce) == ref_value(h, nonce)


def test_search_range_exhausts_and_counts():
    rc, _nonce, done = search(nb.load_library(), bytes(32), (1 << 64) - 1, 0, 1 << 16, 2)
    assert rc == 0
    assert done == 1 << 16


def test_search_range_wraps_base():
    # Plant the solution just past the 2^64 wrap point.
    h = bytes(range(32))
    base = (1 << 64) - 8
    nonce = (base + 5) % (1 << 64)
    diff = ref_value(h, nonce)
    lib = nb.load_library()
    nonce_out = ctypes.c_uint64(0)
    rc = lib.bw_search_range(h, diff, base, 64, 1, None, ctypes.byref(nonce_out), None)
    assert rc == 1
    assert ref_value(h, int(nonce_out.value)) >= diff


def test_generate_produces_valid_work():
    async def run():
        b = nb.NativeWorkBackend(threads=2, chunk=1 << 18)
        await b.setup()
        h = random_hash()
        work = await b.generate(WorkRequest(h, EASY))
        nc.validate_work(h, work, EASY)
        assert b.total_solutions == 1
        await b.close()

    asyncio.run(run())


def test_generate_concurrent():
    async def run():
        b = nb.NativeWorkBackend(threads=1, chunk=1 << 16)
        await b.setup()
        reqs = [WorkRequest(random_hash(), EASY) for _ in range(4)]
        works = await asyncio.gather(*(b.generate(r) for r in reqs))
        for r, w in zip(reqs, works):
            nc.validate_work(r.block_hash, w, EASY)
        await b.close()

    asyncio.run(run())


def test_generate_dedups_same_hash():
    async def run():
        b = nb.NativeWorkBackend(threads=1, chunk=1 << 16)
        await b.setup()
        h = random_hash()
        w1, w2 = await asyncio.gather(
            b.generate(WorkRequest(h, EASY)), b.generate(WorkRequest(h, EASY))
        )
        assert w1 == w2
        assert b.total_solutions == 1
        await b.close()

    asyncio.run(run())


def test_cancel_in_flight():
    async def run():
        b = nb.NativeWorkBackend(threads=1, chunk=1 << 20)
        await b.setup()
        h = random_hash()
        task = asyncio.ensure_future(b.generate(WorkRequest(h, HARD)))
        await asyncio.sleep(0.05)
        await b.cancel(h)
        with pytest.raises(WorkCancelled):
            await task
        await b.close()

    asyncio.run(run())


def test_close_cancels_everything():
    async def run():
        b = nb.NativeWorkBackend(threads=1, chunk=1 << 20)
        await b.setup()
        tasks = [
            asyncio.ensure_future(b.generate(WorkRequest(random_hash(), HARD)))
            for _ in range(3)
        ]
        await asyncio.sleep(0.05)
        await b.close()
        for t in tasks:
            with pytest.raises(WorkCancelled):
                await t

    asyncio.run(run())


def test_waiter_timeout_stops_native_scan():
    async def run():
        b = nb.NativeWorkBackend(threads=1, chunk=1 << 20)
        await b.setup()
        h = random_hash()
        with pytest.raises(asyncio.TimeoutError):
            await asyncio.wait_for(b.generate(WorkRequest(h, HARD)), timeout=0.1)
        await asyncio.sleep(0.05)
        assert h not in b._jobs  # job released, scan flagged to stop
        await b.close()

    asyncio.run(run())


def test_registry_constructs_native():
    b = get_backend("native", threads=1)
    assert isinstance(b, nb.NativeWorkBackend)


def test_one_waiter_timeout_does_not_kill_dedup_waiters():
    """A shared job survives one waiter's cancellation (waiter refcount)."""

    async def run():
        b = nb.NativeWorkBackend(threads=1, chunk=1 << 14)
        await b.setup()
        h = random_hash()
        task_a = asyncio.ensure_future(b.generate(WorkRequest(h, EASY)))
        await asyncio.sleep(0)
        task_b = asyncio.ensure_future(b.generate(WorkRequest(h, EASY)))
        await asyncio.sleep(0)
        task_a.cancel()
        try:
            await task_a  # may have won the race and completed — fine
        except asyncio.CancelledError:
            pass
        work = await asyncio.wait_for(task_b, timeout=30)
        nc.validate_work(h, work, EASY)
        await b.close()

    asyncio.run(run())


def test_raise_and_cover_range_retarget_the_running_scan():
    """raise_difficulty and cover_range land between chunks of a running
    job (the fleet's re-cover path), as in the reference engine."""

    async def run():
        b = nb.NativeWorkBackend(threads=1, chunk=1 << 12)
        await b.setup()
        h = random_hash()
        hb = bytes.fromhex(h)
        start = 1 << 50
        best = max(ref_value(hb, start + i) for i in range(1 << 12))
        task = asyncio.ensure_future(b.generate(WorkRequest(h, HARD)))
        await asyncio.sleep(0.02)
        assert await b.cover_range(h, (start, 1 << 12))
        assert await b.raise_difficulty(h, HARD + 1)
        assert b._jobs[h].difficulty == HARD + 1
        assert not await b.raise_difficulty(random_hash(), HARD)
        await b.cancel(h)
        with pytest.raises(WorkCancelled):
            await task
        # a ranged scan starts at the range: its one nonce at `best` wins
        work = await b.generate(WorkRequest(h, best, nonce_range=(start, 1 << 12)))
        assert ref_value(hb, int(work, 16)) == best
        assert int(work, 16) - start in range(1 << 12)
        await b.close()

    asyncio.run(asyncio.wait_for(run(), 30))
