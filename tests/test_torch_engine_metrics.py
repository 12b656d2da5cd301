"""The engine's nine ``dpow_engine_*`` families on ``TorchWorkBackend``
against ``JaxWorkBackend`` (CPU: the plain PyTorch search and tpu_dpow's
Pallas kernel in interpret mode).

* Both engines, fed the same seeded burst of pinned requests at the same
  window geometry, register the same nine families with the same kinds,
  help texts, buckets and label names (``engine="torch"`` where tpu_dpow
  writes ``"jax"``), and count the same hashes and solutions.
* In every run mode the port has on the CPU (chunked, persistent, the fan
  of one, the mesh of one), ``dpow_engine_device_seconds`` and
  ``dpow_engine_batch_occupancy`` count exactly one observation per
  launch, and the timeline records each launch and each solve.
"""

import asyncio

import numpy as np
import pytest
import torch

from tpu_dpow import obs as jobs
from tpu_dpow.backend.jax_backend import JaxWorkBackend
from tpu_dpow.models import WorkRequest as JaxWorkRequest
from tpu_dpow_torch import obs as tobs
from tpu_dpow_torch.backend.torch_backend import TorchWorkBackend
from tpu_dpow_torch.models import WorkRequest
from tpu_dpow_torch.utils import nanocrypto as nc

torch.set_num_threads(1)

GEOMETRY = dict(sublanes=8, iters=4, nblocks=2, group=2)
EASY = 0xFFF0000000000000
FAMILIES = {
    "dpow_engine_hashes_total", "dpow_engine_solutions_total",
    "dpow_engine_batch_occupancy", "dpow_engine_executor_queue_seconds",
    "dpow_engine_device_seconds", "dpow_engine_queue_wait_seconds",
    "dpow_engine_jobs", "dpow_engine_rungs", "dpow_engine_hash_rate_hs",
}


def run(coro, timeout=120):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def burst(seed: int, n: int = 4) -> list:
    """Pinned requests: each base is drawn from the seed, so both engines
    scan the same nonces."""
    rng = np.random.default_rng(seed)
    return [(rng.bytes(32).hex().upper(), int(rng.integers(0, 1 << 62))) for _ in range(n)]


def describe(obs_mod) -> dict:
    out = {}
    for fam in obs_mod.get_registry().collect():
        if fam.name in FAMILIES:
            out[fam.name] = (fam.kind, fam.help, tuple(fam.labelnames),
                             getattr(fam, "buckets", None))
    return out


def series(obs_mod, name: str, engine: str):
    snap = obs_mod.snapshot()[name]["series"]
    return snap.get(engine, snap.get(""))


async def serve(backend, make_request, reqs) -> list:
    await backend.setup()
    try:
        works = await asyncio.gather(*(
            backend.generate(make_request(h, EASY, nonce_range=(base, 0))) for h, base in reqs
        ))
        while backend._inflight:  # let launches still out land before reading
            await asyncio.sleep(0.01)
        return list(works)
    finally:
        await backend.close()


@pytest.mark.parametrize("seed", [2040, 7])
def test_families_and_counts_match_the_jax_engine(seed):
    reqs = burst(seed)
    tobs.reset()
    jobs.reset()
    torch_b = TorchWorkBackend(device="cpu", pipeline=1, run_steps=4, **GEOMETRY)
    jax_b = JaxWorkBackend(kernel="pallas", interpret=True, warm_shapes=False, pipeline=1,
                           run_steps=4, **GEOMETRY)
    works_t = run(serve(torch_b, WorkRequest, reqs))
    works_j = run(serve(jax_b, JaxWorkRequest, reqs), timeout=300)
    assert works_t == works_j
    for (h, _), w in zip(reqs, works_t):
        nc.validate_work(h, w, EASY)
    got, want = describe(tobs), describe(jobs)
    assert set(got) == FAMILIES and got == want
    assert got["dpow_engine_batch_occupancy"][3] == (1, 2, 4, 8, 16, 32, 64, 128)
    snap = tobs.snapshot()
    for name in FAMILIES - {"dpow_engine_batch_occupancy", "dpow_engine_rungs"}:
        assert set(snap[name]["series"]) <= {"torch"}, name
    for name in ("dpow_engine_hashes_total", "dpow_engine_solutions_total"):
        assert series(tobs, name, "torch") == series(jobs, name, "jax"), name
    assert series(tobs, "dpow_engine_solutions_total", "torch") == len(reqs)
    assert series(tobs, "dpow_engine_hashes_total", "torch") == torch_b.total_hashes
    t_occ = tobs.snapshot()["dpow_engine_batch_occupancy"]["series"][""]
    j_occ = jobs.snapshot()["dpow_engine_batch_occupancy"]["series"][""]
    assert (t_occ["count"], t_occ["sum"]) == (j_occ["count"], j_occ["sum"])
    # Drained: the gauges read zero jobs and zero rungs, as in tpu_dpow.
    assert series(tobs, "dpow_engine_jobs", "torch") == 0
    assert tobs.snapshot()["dpow_engine_rungs"]["series"][""] == 0


@pytest.mark.parametrize("mode", [
    pytest.param(dict(), id="chunked"),
    pytest.param(dict(run_mode="persistent"), id="persistent"),
    pytest.param(dict(devices=1), id="fan_of_one"),
    pytest.param(dict(devices=1, run_mode="persistent"), id="persistent_fan_of_one"),
    pytest.param(dict(mesh_devices=1), id="mesh_of_one"),
])
def test_one_observation_per_launch_in_every_run_mode(mode):
    tobs.reset()
    b = TorchWorkBackend(device="cpu", sublanes=8, iters=8, **mode)
    b.record_timeline = True
    launches = []
    reqs = burst(11, n=5)

    async def main():
        await b.setup()  # the self-test launch is not an engine launch
        real = b._launch

        def counted(*args, **kw):
            launches.append(args[1])
            return real(*args, **kw)

        b._launch = counted
        try:
            works = await asyncio.gather(*(
                b.generate(WorkRequest(h, EASY, nonce_range=(base, 0))) for h, base in reqs))
            while b._inflight:
                await asyncio.sleep(0.01)
            return works
        finally:
            await b.close()

    works = run(main())
    for (h, _), w in zip(reqs, works):
        nc.validate_work(h, w, EASY)
    n = len(launches)
    assert n >= 1
    snap = tobs.snapshot()
    assert snap["dpow_engine_device_seconds"]["series"]["torch"]["count"] == n
    assert snap["dpow_engine_executor_queue_seconds"]["series"]["torch"]["count"] == n
    assert snap["dpow_engine_batch_occupancy"]["series"][""]["count"] == n
    assert snap["dpow_engine_solutions_total"]["series"]["torch"] == len(reqs)
    assert snap["dpow_engine_queue_wait_seconds"]["series"]["torch"]["count"] == len(reqs)
    assert snap["dpow_engine_hashes_total"]["series"]["torch"] == b.total_hashes > 0
    assert snap["dpow_engine_hash_rate_hs"]["series"]["torch"] > 0
    kinds = [k for k, _ in b.timeline]
    assert kinds.count("launch") == n and kinds.count("solve") == len(reqs)
    for kind, rec in b.timeline:
        if kind == "launch":
            assert rec["t_dispatch"] <= rec["t_thread"] <= rec["t_done"] <= rec["t_apply"]
            assert rec["steps"] in launches and rec["batch"] >= 1
        else:
            assert rec["queue_wait"] >= 0 and rec["total"] >= rec["queue_wait"]
            assert rec["launches"] >= 1
