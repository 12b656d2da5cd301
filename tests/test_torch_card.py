"""The port's work engine on the card: the steering that only a real card's
launch threads and cooperative grids can show.

Run there with ``python -m pytest --noconftest -m cuda tests/test_torch_card.py``
(marker ``cuda``: every test but the first skips without a card). The module
imports neither ``jax`` nor ``tpu_dpow``. Each test runs under a stuck-wait
bound that dumps every thread's stack and exits the process, so a wedged
launch thread cannot hang the run.

* The mid-launch cover check counts the launches that re-dispatched a job
  (no card needed).
* The chunked engine at mainnet difficulty: singles, a 16+16 burst at two
  difficulties and a raise of a queued job; the work server behind it
  answers ``work_generate`` and ``work_validate`` over HTTP.
* A cancelled job, in both run modes, fails with ``WorkCancelled`` while a
  fresh request is served, and leaves the engine's launches.
* The persistent engine: singles and a burst run two launch threads on one
  cooperative stream; a raise and a cover_range land mid-launch.
* The fan engine over every visible card, in both run modes and both
  ``device_shard`` policies; a fan of one and a mesh of one return the plain
  engine's work for pinned requests.
* The device fault domains on the real clock: hang, quarantine, a failed
  probe, release, re-admission.
* The mesh engine: singles, a burst, a cancel, a raise and a cover_range.
* dpowsan's device-fault scenario on the run kernel.

Every work string is checked with hashlib.
"""

import asyncio
import faulthandler
import hashlib
import struct
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tpu_dpow_torch import obs
from tpu_dpow_torch.backend import DevicesExhausted, WorkCancelled
from tpu_dpow_torch.backend.torch_backend import TorchWorkBackend
from tpu_dpow_torch.models import WorkRequest
from tpu_dpow_torch.ops import cuda_kernel

torch.set_num_threads(1)

MAINNET = 0xFFFFFFF800000000  # send/change blocks
RECEIVE = 0xFFFFFE0000000000  # receive blocks
MAX_U64 = (1 << 64) - 1
#: A raise (from, to), and the target of a re-covered job: ~2^32 expected
#: nonces, so the command lands while the job runs.
RAISE = (0xFFFFFFFF00000000, 0xFFFFFFFF80000000)
#: Tries of each mid-launch raise and cover_range check. A try fails when
#: the job solves in its old range before the command lands: a launch
#: already in flight finishes it (chunked), or the engine's speculative
#: successor, whose launch thread may enqueue its kernel before the older
#: one's, runs first (persistent).
TRIES = 5
#: Seconds a test may run before every thread's stack is dumped and the
#: process exits.
STUCK_S = 300


@pytest.fixture(autouse=True)
def stuck_wait_bound():
    faulthandler.dump_traceback_later(STUCK_S, exit=True)
    yield
    faulthandler.cancel_dump_traceback_later()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the engine's kernels have no CPU mode")


def ref_value(nonce: int, block_hash: bytes) -> int:
    digest = hashlib.blake2b(struct.pack("<Q", nonce & MAX_U64) + block_hash,
                             digest_size=8).digest()
    return int.from_bytes(digest, "little")


def assert_work(h: str, work: str, difficulty: int) -> None:
    assert ref_value(int(work, 16), bytes.fromhex(h)) >= difficulty, (h, work, difficulty)


def hashes(seed: int):
    rng = np.random.default_rng(seed)
    return lambda: rng.bytes(32).hex().upper()


async def wait_for(pred, what: str, timeout: float = 30.0) -> None:
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    while not pred():
        assert loop.time() <= deadline, f"timed out waiting for {what}"
        await asyncio.sleep(0.001)


async def result(task, what: str, timeout: float = 60.0):
    await wait_for(task.done, what, timeout)
    return task.result()


async def solve(backend, h: str, difficulty: int, **kw) -> str:
    work = await result(asyncio.ensure_future(
        backend.generate(WorkRequest(h, difficulty, **kw))), f"a solve of {h[:8]}")
    assert_work(h, work, difficulty)
    return work


def carries(backend, h: str) -> bool:
    """Does an in-flight launch of ``backend`` carry job ``h``?"""
    return any(j.block_hash == h for rec in backend._inflight for j in rec.jobs)


async def running_control(backend, h: str) -> list:
    """[(rec, row)] of every in-flight persistent launch carrying job ``h``,
    once the oldest of them has polled at least once (the job is running on
    the card). A command is then written while that launch runs: a raise
    reaches every launch, a rebase the newest (a speculative successor
    queued behind the running one, which is killed) — waiting for the
    newest to poll instead would wait out the running launch, which mostly
    ends by solving the job."""
    found = []

    def ready():
        job = backend._jobs.get(h)
        found[:] = backend._live_controls(job) if job is not None else []
        return bool(found) and found[0][0].control.polls > 0

    await wait_for(ready, f"a running persistent launch of {h[:8]}")
    return list(found)


def delivered(recs: list, action: str) -> bool:
    """Did any of the launches ``recs`` deliver ``action`` to the job's row?"""
    return any(a == action for rec, row in recs
               for r, a, _l, _t in rec.control.delivered if r == row)


async def result_tracking(backend, task, h: str, recs: list, what: str) -> tuple:
    """``await task`` as :func:`result` does → (work, later): ``later``
    counts the launches carrying job ``h`` that were dispatched after
    ``recs`` were taken. A rebase written into a launch that ends before
    its next poll (the write landed in its last window block) is never
    delivered; the engine then re-dispatches the job from the new range,
    and one of those later launches finds the work."""
    known = {id(rec) for rec, _ in recs}
    later = set()

    def done() -> bool:
        for rec in backend._inflight:
            if id(rec) not in known and any(j.block_hash == h for j in rec.jobs):
                later.add(id(rec))
        return task.done()

    await wait_for(done, what, 60.0)
    return task.result(), len(later)


def series(name: str) -> dict:
    return dict(obs.snapshot().get(name, {}).get("series", {}))


def test_cover_check_counts_launches_dispatched_after_the_rebase():
    """An in-flight launch that carries the job and was not among the
    launches the rebase was written into counts as a re-dispatch; those
    known before and other jobs' do not."""
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
        got = await result_tracking(backend, task, "AA", [(known, 0)], "the job")
        await pending
        return got

    assert asyncio.run(drive()) == ("00000000000000ff", 1)


@pytest.mark.cuda
def test_chunked_engine_serves_singles_a_burst_and_a_raised_job(card):
    """8 mainnet singles, then max_batch send and max_batch receive requests
    at once, then a queued receive job raised to mainnet before its first
    result: every work valid at its target, and the search kernel ran."""
    new_hash = hashes(2027)

    async def drive():
        backend = TorchWorkBackend()
        await backend.setup()
        try:
            for _ in range(8):
                await solve(backend, new_hash(), MAINNET)
            await asyncio.gather(
                *[solve(backend, new_hash(), MAINNET) for _ in range(backend.max_batch)],
                *[solve(backend, new_hash(), RECEIVE) for _ in range(backend.max_batch)])
            h = new_hash()
            task = asyncio.ensure_future(backend.generate(WorkRequest(h, RECEIVE)))
            await asyncio.sleep(0)
            assert await backend.raise_difficulty(h, MAINNET)
            assert_work(h, await result(task, "the raised job"), MAINNET)
        finally:
            await backend.close()

    before = cuda_kernel.launches
    asyncio.run(drive())
    assert cuda_kernel.launches > before


@pytest.mark.cuda
def test_work_server_serves_generate_and_validate_on_the_card(card):
    """The engine behind the nano-work-server HTTP protocol on 127.0.0.1: 4
    concurrent work_generate requests at mainnet difficulty, each valid, and
    a work_validate of the first."""
    import aiohttp

    from tpu_dpow_torch.workserver import WorkServer

    new_hash = hashes(2028)

    async def drive():
        server = WorkServer(TorchWorkBackend(), port=0)
        await server.start()
        try:
            async with aiohttp.ClientSession() as http:
                async def post(payload: dict) -> dict:
                    async with http.post(f"http://127.0.0.1:{server.port}/", json=payload) as r:
                        return await r.json()

                sent = [new_hash() for _ in range(4)]
                replies = await asyncio.gather(*[
                    post({"action": "work_generate", "hash": h, "difficulty": f"{MAINNET:016x}"})
                    for h in sent])
                for h, reply in zip(sent, replies):
                    assert_work(h, reply["work"], MAINNET)
                check = await post({"action": "work_validate", "hash": sent[0],
                                    "work": replies[0]["work"],
                                    "difficulty": f"{MAINNET:016x}"})
                assert check.get("valid") == "1", check
        finally:
            await server.stop()

    asyncio.run(drive())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["chunked", "persistent"])
def test_cancel_fails_the_job_and_drains_its_launches(card, mode):
    """An easy solo request, then an unreachable job cancelled 0.25 s in: a
    fresh easy request is served meanwhile, no in-flight launch carries the
    cancelled job within 60 s, and its generate fails with WorkCancelled."""
    new_hash = hashes(2029)

    async def drive():
        backend = TorchWorkBackend(run_mode=mode)
        await backend.setup()
        try:
            await solve(backend, new_hash(), RECEIVE)
            hard = new_hash()
            task = asyncio.ensure_future(backend.generate(WorkRequest(hard, MAX_U64)))
            await asyncio.sleep(0.25)
            await backend.cancel(hard)
            await solve(backend, new_hash(), RECEIVE)
            await wait_for(lambda: not carries(backend, hard), "the cancelled job to drain", 60.0)
            with pytest.raises(WorkCancelled):
                await asyncio.wait_for(task, 5.0)
        finally:
            await backend.close()

    asyncio.run(drive())


@pytest.mark.cuda
def test_persistent_engine_serves_singles_and_a_burst_on_one_stream(card):
    """8 mainnet singles, then max_batch send and max_batch receive requests
    at once: every launch of a persistent engine shares one cooperative
    stream, so the burst's launch threads must never wait on it once their
    kernel is queued (the CPU cannot show that). The run kernel served it
    all, polling, and the search kernel never ran."""
    new_hash = hashes(2030)

    async def drive():
        backend = TorchWorkBackend(run_mode="persistent")
        await backend.setup()
        try:
            for _ in range(8):
                await solve(backend, new_hash(), MAINNET)
            await asyncio.gather(
                *[solve(backend, new_hash(), MAINNET) for _ in range(backend.max_batch)],
                *[solve(backend, new_hash(), RECEIVE) for _ in range(backend.max_batch)])
        finally:
            await backend.close()

    before = (cuda_kernel.launches, cuda_kernel.run_launches, cuda_kernel.run_poll_stats["polls"])
    asyncio.run(drive())
    assert cuda_kernel.launches == before[0]
    assert cuda_kernel.run_launches > before[1]
    assert cuda_kernel.run_poll_stats["polls"] > before[2]


@pytest.mark.cuda
def test_persistent_engine_delivers_a_raise_mid_launch(card):
    """A raise written while the job's launch runs on the card is delivered
    at its next poll, and the work meets the raised target. A job that
    solves before that poll proves nothing mid-launch and is tried anew."""
    new_hash = hashes(2031)

    async def drive():
        backend = TorchWorkBackend(run_mode="persistent")
        await backend.setup()
        try:
            for _ in range(TRIES):
                h = new_hash()
                task = asyncio.ensure_future(backend.generate(WorkRequest(h, RAISE[0])))
                recs = await running_control(backend, h)
                took = await backend.raise_difficulty(h, RAISE[1])
                assert_work(h, await result(task, "the raised job"), RAISE[took])
                if took and delivered(recs, "raise"):
                    rec, row = next((r, i) for r, i in recs
                                    if r.control.effective_difficulty(i) is not None)
                    assert rec.control.effective_difficulty(row) == RAISE[1]
                    return
            pytest.fail(f"no raise_difficulty landed mid-launch in {TRIES} tries")
        finally:
            await backend.close()

    asyncio.run(drive())


@pytest.mark.cuda
def test_persistent_engine_delivers_a_cover_range_mid_launch(card):
    """A cover_range written while the job's launch runs on the card
    re-aims the kernel at range B: the work lies in range B. A rebase that
    no launch polled before it ended is not mid-launch: the job was then
    re-dispatched from range B (a later launch carried it), and the attempt
    is tried anew."""
    new_hash = hashes(2032)
    start_a, start_b, length = 3 << 40, 0x5A5A << 44, 1 << 40

    async def drive():
        backend = TorchWorkBackend(run_mode="persistent")
        await backend.setup()
        try:
            for _ in range(TRIES):
                h = new_hash()
                task = asyncio.ensure_future(
                    backend.generate(WorkRequest(h, RAISE[0], nonce_range=(start_a, length))))
                recs = await running_control(backend, h)
                took = await backend.cover_range(h, (start_b, length))
                work, later = await result_tracking(backend, task, h, recs, "the re-covered job")
                assert_work(h, work, RAISE[0])
                if took and int(work, 16) >= start_b:
                    assert int(work, 16) < start_b + length, work
                    if delivered(recs, "rebase"):
                        return
                    assert later, "work from range B, but no rebase delivered and no later launch"
            pytest.fail(f"no cover_range landed mid-launch in {TRIES} tries")
        finally:
            await backend.close()

    asyncio.run(drive())


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["split", "interleave"])
@pytest.mark.parametrize("mode", ["chunked", "persistent"])
def test_fan_engine_serves_and_steers_on_every_card(card, mode, policy):
    """A fan engine over every visible card: 4 mainnet singles, an 8+8 burst
    at two difficulties, a raise (mid-launch in persistent mode, delivered
    at the next poll; before the first result in chunked mode) and a
    cover_range that re-partitions every member shard into range B. Every
    card launched."""
    new_hash = hashes(2033)
    start_a, start_b, length = 3 << 40, 0x5A5A << 44, 1 << 40

    async def steer(backend):
        for _ in range(TRIES):
            h = new_hash()
            task = asyncio.ensure_future(backend.generate(WorkRequest(h, RAISE[0])))
            if mode == "persistent":
                recs = await running_control(backend, h)
            else:
                await asyncio.sleep(0)
            took = await backend.raise_difficulty(h, RAISE[1])
            assert_work(h, await result(task, "the raised fan job"), RAISE[took])
            if took and (mode != "persistent" or delivered(recs, "raise")):
                break
        else:
            pytest.fail(f"no raise_difficulty landed on the {mode} fan in {TRIES} tries")
        for _ in range(TRIES):
            h = new_hash()
            task = asyncio.ensure_future(
                backend.generate(WorkRequest(h, RAISE[0], nonce_range=(start_a, length))))
            recs = []
            if mode == "persistent":
                recs = await running_control(backend, h)
            else:
                await wait_for(lambda: carries(backend, h), "a chunked fan launch")
            took = await backend.cover_range(h, (start_b, length))
            part_start = backend._jobs[h].part_start if took else None
            work, later = await result_tracking(backend, task, h, recs, "the re-covered fan job")
            assert_work(h, work, RAISE[0])
            if took and start_b <= int(work, 16) < start_b + 2 * length:
                assert part_start == start_b
                if mode != "persistent" or delivered(recs, "rebase"):
                    return
                assert later, "work from range B, but no rebase delivered and no later launch"
        pytest.fail(f"no cover_range landed on the {mode} fan in {TRIES} tries")

    async def drive():
        backend = TorchWorkBackend(devices=-1, run_mode=mode, device_shard=policy)
        await backend.setup()
        try:
            for _ in range(4):
                await solve(backend, new_hash(), MAINNET)
            await asyncio.gather(*[solve(backend, new_hash(), MAINNET) for _ in range(8)],
                                 *[solve(backend, new_hash(), RECEIVE) for _ in range(8)])
            await steer(backend)
            return len(backend.fan)
        finally:
            await backend.close()

    before = series("dpow_backend_device_launches_total")
    n = asyncio.run(drive())
    after = series("dpow_backend_device_launches_total")
    assert all(after.get(str(d), 0) > before.get(str(d), 0) for d in range(n)), after


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(devices=1), dict(mesh_devices=1)], ids=["fan1", "mesh1"])
def test_engine_of_one_member_returns_the_plain_engines_work(card, kw):
    """A fan of one and a mesh of one run the multi-card machinery on one
    card: for the same 8 pinned-start mainnet requests they scan the same
    nonces as the plain engine, so they must return the same work."""
    rng = np.random.default_rng(2034)
    reqs = [(rng.bytes(32).hex().upper(), int(rng.integers(0, 1 << 62))) for _ in range(8)]

    async def works(**engine_kw):
        backend = TorchWorkBackend(**engine_kw)
        await backend.setup()
        try:
            return [await solve(backend, h, MAINNET, nonce_range=(b, 0)) for h, b in reqs]
        finally:
            await backend.close()

    assert asyncio.run(works(**kw)) == asyncio.run(works())


@pytest.mark.cuda
def test_device_fault_domains_on_the_real_clock(card):
    """The last card's kernel hangs at its window-2 poll (FaultyDevice) →
    suspect → evacuation → quarantine; with one card the in-flight job
    fails with DevicesExhausted and a new generate fails fast, with more
    the job's range lands on the rest; a probe of the still-wedged card
    hangs with it and fails; release → the wedged grid drains → a probe
    re-admits the card → a fresh solve. Health ends at 0 on every card, and
    every card synchronizes (no grid left running)."""
    from tpu_dpow_torch.chaos import FaultyDevice
    from tpu_dpow_torch.resilience import HEALTHY, QUARANTINED

    new_hash = hashes(2035)

    def metric(name, label=""):
        return series(name).get(label, 0)

    async def drive():
        backend = TorchWorkBackend(devices=-1, run_mode="persistent", device_suspect_after=3.0,
                                   device_probe_interval=4.0, close_join_timeout=10.0)
        await backend.setup()
        try:
            n = len(backend.fan)
            last = n - 1
            await solve(backend, new_hash(), RECEIVE)
            evacuated = metric("dpow_backend_evacuations_total", "stalled_poll")
            with FaultyDevice() as fd:
                fd.hang_at_poll(last, 2)
                h = new_hash()
                task = asyncio.ensure_future(backend.generate(WorkRequest(h, MAX_U64 - 1)))
                await wait_for(lambda: any(e[0] == "poll" and e[1] == last for e in fd.events),
                               "the hang")
                wedged = next(r for r in backend._inflight
                              if r.control is not None and any(j.block_hash == h for j in r.jobs))
                await wait_for(lambda: backend._dfd.state(last) == QUARANTINED, "the quarantine")
                assert metric("dpow_backend_evacuations_total", "stalled_poll") == evacuated + 1
                if n == 1:
                    with pytest.raises(DevicesExhausted):
                        await result(task, "the exhausted job")
                    with pytest.raises(DevicesExhausted):
                        await backend.generate(WorkRequest(new_hash(), RECEIVE))
                else:
                    assert backend._fan_active == list(range(last))
                    assert backend._jobs[h].part_start != 0
                    await backend.cancel(h)
                    with pytest.raises(WorkCancelled):
                        await task
                    await solve(backend, new_hash(), MAINNET)
                # A probe of the still-wedged card hangs with it, and fails.
                leaked = metric("dpow_backend_launch_threads_leaked_total")
                await wait_for(lambda: metric("dpow_backend_launch_threads_leaked_total") > leaked,
                               "a failed probe of the wedged card")
                fd.release(last)
            await wait_for(wedged.thread_done.is_set, "the wedged grid to drain")
            await wait_for(lambda: backend._dfd.state(last) == HEALTHY, "the re-admission")
            await solve(backend, new_hash(), MAINNET)
            health = {d: metric("dpow_backend_device_health", str(d)) for d in range(n)}
            assert not any(health.values()), health
        finally:
            await backend.close()
        for d in backend.fan:
            torch.cuda.synchronize(d)

    asyncio.run(drive())


@pytest.mark.cuda
def test_mesh_engine_serves_cancels_raises_and_re_covers(card):
    """TorchWorkBackend(mesh_devices=<every card>): 4 mainnet singles, an
    8+8 burst at two difficulties, an unreachable job cancelled once a mesh
    launch carries it (it fails with WorkCancelled and leaves the engine),
    a raise of a queued job, and a cover_range of a running one whose work
    lies in range B (a chunked launch already in flight may finish range A
    first: the job is then tried anew). The search kernel ran."""
    from tpu_dpow_torch.parallel import fan_devices

    new_hash = hashes(2036)
    start_a, start_b, length = 3 << 40, 0x5A5A << 44, 1 << 40

    async def drive():
        backend = TorchWorkBackend(mesh_devices=len(fan_devices(-1, "cuda")))
        await backend.setup()
        try:
            for _ in range(4):
                await solve(backend, new_hash(), MAINNET)
            await asyncio.gather(*[solve(backend, new_hash(), MAINNET) for _ in range(8)],
                                 *[solve(backend, new_hash(), RECEIVE) for _ in range(8)])
            h = new_hash()
            task = asyncio.ensure_future(backend.generate(WorkRequest(h, MAX_U64)))
            await wait_for(lambda: carries(backend, h), "a mesh launch of the unreachable job")
            await backend.cancel(h)
            with pytest.raises(WorkCancelled):
                await result(task, "the cancelled mesh job")
            await wait_for(lambda: h not in backend._jobs or backend._jobs[h].future.done(),
                           "the cancelled job to leave the mesh engine")
            h = new_hash()
            task = asyncio.ensure_future(backend.generate(WorkRequest(h, RAISE[0])))
            await asyncio.sleep(0)
            assert await backend.raise_difficulty(h, RAISE[1])
            assert_work(h, await result(task, "the raised mesh job"), RAISE[1])
            for _ in range(TRIES):
                h = new_hash()
                task = asyncio.ensure_future(
                    backend.generate(WorkRequest(h, RAISE[0], nonce_range=(start_a, length))))
                await wait_for(lambda: carries(backend, h), "a mesh launch of the job")
                took = await backend.cover_range(h, (start_b, length))
                work = await result(task, "the re-covered mesh job")
                assert_work(h, work, RAISE[0])
                if took and start_b <= int(work, 16) < start_b + 2 * length:
                    return
            pytest.fail(f"no cover_range landed on the mesh engine in {TRIES} tries")
        finally:
            await backend.close()

    before = cuda_kernel.launches
    asyncio.run(drive())
    assert cuda_kernel.launches > before


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(2))
def test_devfault_scenario_on_the_card(card, seed):
    """dpowsan's device-fault scenario (a persistent engine whose run kernel
    wedges at a poll while release, cancel, raise and the watchdog race) is
    clean on the card, and leaves no grid running."""
    from tpu_dpow_torch.analysis import sanitizer

    before = cuda_kernel.run_launches
    outcome = sanitizer.run_seed("devfault", seed, "cuda")
    assert outcome.ok, outcome.error
    assert cuda_kernel.run_launches > before
    torch.cuda.synchronize()
