"""The port's device fault domains against tpu_dpow's (after
tests/test_devfault.py).

``DeviceFaultDomains`` runs one script through both packages' copies and
must walk the same states and move the same metric series. The engine's
watchdog (``TorchWorkBackend``) is driven through the port's own
``FaultyDevice`` seam on a FakeClock: the 8-way persistent drill (member 3
wedged at its window-2 poll → suspect → evacuation onto the other 7 →
a solve from the evacuated range → probe re-admission), the plain
persistent engine's single domain (exhausted → fail fast → probe
re-admits), the bounded close against a wedged launch thread, and the
chunked backstop. ``_dead_remainder`` — the evacuation frontier — is held
against ``JaxWorkBackend._dead_remainder`` on identical control scripts.

Planted-difficulty technique: the floor is the best work value over every
nonce any member can scan before the interesting moment, so the solve can
only come from the region evacuated after it.
"""

import asyncio
import itertools

import numpy as np
import pytest
import torch

from tpu_dpow import obs as jobs_obs
from tpu_dpow.backend.jax_backend import JaxWorkBackend
from tpu_dpow.backend.jax_backend import _Job as JaxJob
from tpu_dpow.backend.jax_backend import _Launch as JaxLaunch
from tpu_dpow.ops import control as jctl
from tpu_dpow.resilience import devfault as jdevfault
from tpu_dpow.resilience.clock import FakeClock as JaxFakeClock
from tpu_dpow_torch import obs
from tpu_dpow_torch.backend import DevicesExhausted, WorkCancelled
from tpu_dpow_torch.backend.torch_backend import TorchWorkBackend, _Job, _Launch
from tpu_dpow_torch.chaos import FaultyDevice
from tpu_dpow_torch.models import WorkRequest
from tpu_dpow_torch.obs import LEDGER
from tpu_dpow_torch.ops import control as ctl
from tpu_dpow_torch.resilience import HEALTHY, QUARANTINED, SUSPECT
from tpu_dpow_torch.resilience import devfault
from tpu_dpow_torch.resilience.clock import FakeClock
from tpu_dpow_torch.utils import nanocrypto as nc

from conftest import requires_fan_devices

# The suite runs in parallel worker processes: one intra-op thread each
# keeps these tests from crowding out the others on the same cores.
torch.set_num_threads(1)

RNG = np.random.default_rng(13)
EASY = 0xFFF0000000000000
UNREACH = (1 << 64) - 2
_MASK64 = (1 << 64) - 1
val = nc.work_value_int


def plant_above(h: bytes, start: int, floor: int) -> int:
    return next(n for n in itertools.count(start) if val(h, n) > floor)


def random_hash() -> str:
    return RNG.bytes(32).hex().upper()


def _metric(name, *labels, snapshot=obs.snapshot):
    series = snapshot().get(name, {}).get("series", {})
    v = series.get(",".join(labels), 0)
    return v.get("count", 0) if isinstance(v, dict) else v


async def _spin_until(cond, timeout=30.0, msg="condition"):
    deadline = asyncio.get_running_loop().time() + timeout
    while not cond():
        assert asyncio.get_running_loop().time() < deadline, f"timed out waiting for {msg}"
        await asyncio.sleep(0.005)


# -- DeviceFaultDomains, one script through both copies ------------------------


def _state_machine_walk(mod, clock, snapshot, name) -> list:
    dfd = mod.DeviceFaultDomains(4, suspect_after=10.0, probe_interval=30.0, clock=clock,
                                 name=name)
    trans = "dpow_backend_quarantine_total"
    t0 = {k: _metric(trans, k, snapshot=snapshot) for k in
          ("healthy->suspect", "suspect->quarantined", "quarantined->healthy")}
    seen = []

    def note(tag, value):
        seen.append((tag, value))

    note("healthy", dfd.healthy_devices())
    note("suspect", dfd.mark_suspect(2))
    note("suspect again", dfd.mark_suspect(2))
    note("state", dfd.state(2))
    note("healthy", dfd.healthy_devices())
    dfd.quarantine(2)
    note("state", dfd.state(2))
    note("exhausted", dfd.exhausted())
    note("probe early", dfd.probe_due(2))
    clock._now += 31.0
    note("probe due", dfd.probe_due(2))
    note("second probe", dfd.probe_due(2))
    dfd.probe_result(2, False)
    note("after failed probe", (dfd.state(2), dfd.probe_due(2)))
    clock._now += 31.0
    note("probe due", dfd.probe_due(2))
    dfd.probe_result(2, True)
    note("re-admitted", (dfd.state(2), dfd.healthy_devices()))
    dfd.record_evacuation("stalled_poll")
    for d in (0, 1, 3, 2):
        dfd.mark_suspect(d)
        dfd.quarantine(d)
    note("exhausted", (dfd.exhausted(), dfd.healthy_devices()))
    note("health", [_metric("dpow_backend_device_health", str(d), snapshot=snapshot)
                    for d in range(4)])
    note("transitions", {k: _metric(trans, k, snapshot=snapshot) - v for k, v in t0.items()})
    note("deadline", [mod.launch_deadline(e, 5.0) for e in (0.0, 1.0, 3.0)])
    return seen


def test_fault_domain_state_machine_matches_the_reference():
    got = _state_machine_walk(devfault, FakeClock(), obs.snapshot, "t1")
    want = _state_machine_walk(jdevfault, JaxFakeClock(), jobs_obs.snapshot, "t1")
    assert got == want
    assert dict(got)["re-admitted"] == (HEALTHY, [0, 1, 2, 3])
    assert devfault.DEADLINE_SLACK == jdevfault.DEADLINE_SLACK
    assert (devfault.HEALTHY, devfault.SUSPECT, devfault.QUARANTINED) == (
        jdevfault.HEALTHY, jdevfault.SUSPECT, jdevfault.QUARANTINED)


# -- FaultyDevice seam ----------------------------------------------------------


def test_faulty_device_seam_maps_physical_index_and_releases():

    class Tick:
        t = 0.0

        def time(self):
            return self.t

    c = ctl.LaunchControl(1, clock=Tick(), n_dev=2, fan_map=[5, 7])
    slot = ctl.register(c)
    fd = FaultyDevice()
    try:
        fd.install()
        fd.slow_poll(7, 0.0)
        ctl.poll_slot(slot, 1, 3, np.array([False]))  # member 1 is physical 7
        assert ("poll", 7, 3) in fd.events
        fd.hang_at_poll(5, 0)
        fd.hang_launch(6)
        assert {5, 6} <= set(fd._rules)
    finally:
        fd.uninstall()
        ctl.release(slot)
    assert not fd._rules, "uninstall must clear and release every rule"
    assert ctl._poll_hook is None and ctl._launch_hook is None


# -- _dead_remainder against the reference ---------------------------------------


@pytest.mark.parametrize("case", ["rebase_then_wedge", "no_rebase", "done_row", "past_range"])
def test_dead_remainder_matches_the_reference(case):
    """The evacuation frontier of a wedged member, on identical scripts:
    a member that ADOPTED a rebase at k_a and then wedged scanned the new
    base only for its post-adoption windows; a done row proves only the
    windows before its poll block; a frontier past the range end is soft."""

    async def remainder(engine_cls, job_cls, launch_cls, ctl_mod, clock):
        b = engine_cls(run_mode="persistent", persistent_steps=16, control_poll_steps=1,
                       clock=clock)
        job = job_cls(block_hash="00" * 32, difficulty=UNREACH, params=None,
                      future=asyncio.get_running_loop().create_future(), base=0)
        job.part_start, job.part_len = 0, (1 << 30) if case != "past_range" else 1 << 14
        c = ctl_mod.LaunchControl(1, clock=clock, n_dev=1)
        if case == "rebase_then_wedge":
            c.rebase(0, 1 << 20, epoch=1)
            c.poll(0, 2, np.array([False]))  # adopts the rebase at k_a = 2
            c.poll(0, 5, np.array([False]))
        elif case == "done_row":
            c.poll(0, 3, np.array([False]))
            c.poll(0, 6, np.array([True]))
        else:
            c.poll(0, 4, np.array([False]))
        kw = dict(fut=asyncio.get_running_loop().create_future(), jobs=[job],
                  launched_difficulty=[UNREACH], bases=[1 << 12], span=16 * b.chunk,
                  miss_factors=[1.0], control=c, slot=0)
        # Each package's own launch record: the reference's carries its
        # shape, the port's its per-job epochs.
        rec = launch_cls(**kw, **({"shape": (1, 16)} if launch_cls is JaxLaunch
                                  else {"epochs": [0]}))
        out = b._dead_remainder(rec, 0, job, 0)
        await b.close()
        return out, b.chunk_per_shard

    got, cps = asyncio.run(remainder(
        lambda **kw: TorchWorkBackend(device="cpu", **kw), _Job, _Launch, ctl, FakeClock()))
    want, cps_j = asyncio.run(remainder(
        lambda **kw: JaxWorkBackend(kernel="xla", sublanes=8, iters=8, **kw),
        JaxJob, JaxLaunch, jctl, JaxFakeClock()))
    assert cps == cps_j and got == want
    if case == "rebase_then_wedge":
        assert got[0] == (1 << 20) + 3 * cps  # 5 - 2 windows dry on the new base


# -- the 8-way drill ------------------------------------------------------------


@requires_fan_devices
def test_hung_member_evacuation_quarantine_and_probe_readmission():
    """FakeClock, 8-member persistent fan: member 3 hangs at its k = 2 poll
    → suspect → its uncovered remainder evacuated exactly once onto the 7
    healthy members → a bit-valid solve from the evacuated range → the
    zombie wake-up cannot rewind the evacuated frontier → probe
    re-admission."""

    async def run():
        clock = FakeClock()
        b = TorchWorkBackend(
            device="cpu", sublanes=8, iters=2, devices=8, max_batch=1,
            run_mode="persistent", persistent_steps=4, control_poll_steps=1,
            pipeline=1, clock=clock, device_suspect_after=10.0, device_probe_interval=30.0,
        )
        await b.setup()
        span_dev = b.chunk_per_shard
        assert span_dev == 8 * 128 * 2
        hx = random_hash()
        h = bytes.fromhex(hx)
        S, stride = 1 << 40, 1 << 20
        L = 8 * stride
        launch_span = 4 * span_dev
        pre = []
        for d in range(8):
            width = launch_span if d != 3 else 2 * span_dev
            pre.extend(range(S + d * stride, S + d * stride + width))
        floor = max(val(h, n) for n in pre)
        f3 = S + 3 * stride + span_dev  # base + 1 provably dry window
        planted = plant_above(h, f3, floor)
        diff = val(h, planted)

        evac_before = _metric("dpow_backend_evacuations_total", "stalled_poll")
        with FaultyDevice() as fd:
            fd.hang_at_poll(3, 2)
            t = asyncio.ensure_future(b.generate(WorkRequest(hx, diff, nonce_range=(S, L))))
            await _spin_until(lambda: any(r.control is not None for r in b._inflight),
                              msg="persistent launch")
            rec = next(r for r in b._inflight if r.control is not None)
            await _spin_until(lambda: ("poll", 3, 2) in fd.events, msg="member 3 hang")
            await _spin_until(lambda: all(rec.control.device_accounted(s, 4, 1)
                                          for s in range(8) if s != 3),
                              msg="healthy members accounted")
            assert not rec.control.device_accounted(3, 4, 1)
            assert rec.control.confirmed_no_hit_windows(0, 3, 1) == 1

            await clock.advance(13.0)
            assert b._dfd.state(3) == QUARANTINED
            assert rec.abandoned and rec not in b._inflight
            assert b._fan_active == [0, 1, 2, 4, 5, 6, 7]
            assert _metric("dpow_backend_evacuations_total", "stalled_poll") - evac_before == 1
            assert _metric("dpow_backend_device_health", "3") == 2.0
            job = b._jobs[hx]
            epoch_evac = job.epoch
            assert job.part_start == f3
            assert ((min(job.dev_bases[d] for d in b._fan_active) - f3) & _MASK64) <= launch_span

            fd.release(3)
            await _spin_until(lambda: rec.thread_done.is_set(), msg="zombie drain")
            assert job.epoch == epoch_evac, "zombie moved the epoch"
            assert all(((job.dev_bases[d] - f3) & _MASK64) < L for d in b._fan_active)

            work = await asyncio.wait_for(t, 60)
            nonce = int(work, 16)
            nc.validate_work(hx, work, diff)
            assert f3 <= nonce < S + L + launch_span, f"winner {work} not evacuated"

            await clock.advance(13.0)
            assert _metric("dpow_backend_evacuations_total", "stalled_poll") - evac_before == 1

            assert b._dfd.state(3) == QUARANTINED
            deadline = asyncio.get_running_loop().time() + 60
            while b._dfd.state(3) != HEALTHY and not any(
                not p.done() for p in b._probe_tasks.values()
            ):
                assert asyncio.get_running_loop().time() < deadline
                await clock.advance(2.6)
            await _spin_until(lambda: b._dfd.state(3) == HEALTHY, timeout=60,
                              msg="probe re-admission")
            assert b._fan_active == list(range(8))
            assert _metric("dpow_backend_device_health", "3") == 0.0
        await b.close()

    asyncio.run(asyncio.wait_for(run(), 120))


# -- the plain persistent engine: one domain -------------------------------------


def test_plain_persistent_watchdog_exhausts_fails_fast_and_probe_readmits():
    """The plain persistent engine runs the watchdog with one domain: its
    device dies → the live waiter fails with DevicesExhausted at once, new
    generates refuse on arrival, and after the fault lifts a probe
    re-admits the device and the engine serves again."""

    async def run():
        clock = FakeClock()
        b = TorchWorkBackend(
            device="cpu", run_mode="persistent", persistent_steps=4, control_poll_steps=1,
            pipeline=1, clock=clock, device_suspect_after=5.0, device_probe_interval=20.0,
        )
        assert b._watchdog_enabled and b._dfd.n == 1
        await b.setup()
        with FaultyDevice() as fd:
            fd.hang_at_poll(0, 1)
            t = asyncio.ensure_future(b.generate(WorkRequest(random_hash(), UNREACH)))
            await _spin_until(lambda: any(("poll", 0, k) in fd.events for k in (1, 2)),
                              msg="device hang")
            await clock.advance(7.0)
            with pytest.raises(DevicesExhausted):
                await t
            with pytest.raises(DevicesExhausted):
                await b.generate(WorkRequest(random_hash(), EASY))
            assert b._dfd.exhausted()
            fd.release(0)
            await clock.advance(21.0)
            await _spin_until(lambda: b._dfd.state(0) == HEALTHY, msg="probe re-admission")
            h = random_hash()
            work = await asyncio.wait_for(b.generate(WorkRequest(h, EASY)), 30)
            nc.validate_work(h, work, EASY)
        await b.close()

    asyncio.run(asyncio.wait_for(run(), 60))


def test_watchdog_defaults_follow_the_reference():
    for kw in ({}, {"run_mode": "persistent"}, {"device_suspect_after": 3.0},
               {"devices": 2}, {"devices": 2, "run_mode": "persistent"}):
        port = TorchWorkBackend(device="cpu", **kw)
        ref = JaxWorkBackend(kernel="xla", sublanes=8, iters=8, **kw)
        assert port._watchdog_enabled == ref._watchdog_enabled, kw
        assert port._dfd.n == ref._dfd.n and port.device_suspect_after == ref.device_suspect_after
        assert port.launch_timeout is None and ref.launch_timeout is None  # the CPU rule
    from tpu_dpow_torch.backend import torch_backend as tb

    assert tb._LAUNCH_TIMEOUT["cuda"] == 300.0


# -- bounded close against a wedged launch thread --------------------------------


def test_close_returns_within_bound_and_counts_leaked_thread():
    async def run():
        clock = FakeClock()
        b = TorchWorkBackend(
            device="cpu", run_mode="persistent", persistent_steps=4, control_poll_steps=1,
            pipeline=1, clock=clock, device_suspect_after=1000.0, close_join_timeout=5.0,
        )
        await b.setup()
        before = _metric("dpow_backend_launch_threads_leaked_total")
        with FaultyDevice() as fd:
            fd.hang_at_poll(0, 1)
            t = asyncio.ensure_future(b.generate(WorkRequest(random_hash(), UNREACH)))
            await _spin_until(lambda: any(("poll", 0, k) in fd.events for k in (1, 2)),
                              msg="device hang")
            rec = next(r for r in b._inflight if r.control is not None)
            closer = asyncio.ensure_future(b.close())
            with pytest.raises(WorkCancelled):
                await t
            for _ in range(30):
                if closer.done():
                    break
                await clock.advance(1.0)
            await asyncio.wait_for(closer, 5)
            assert _metric("dpow_backend_launch_threads_leaked_total") - before == 1
            assert not rec.thread_done.is_set(), "the thread is wedged, yet close returned"
            fd.release(0)
            await _spin_until(lambda: rec.thread_done.is_set(), msg="zombie drain")

    asyncio.run(asyncio.wait_for(run(), 60))


# -- chunked whole-launch backstop -----------------------------------------------


def test_chunked_backstop_evacuates_hung_launch():
    """run_mode=chunked with device_suspect_after set: a launch that
    outlives its deadline is ejected and its rows re-covered
    (reason=launch_hang) without quarantine; after the fault lifts the
    re-dispatched launch serves."""

    async def run():
        clock = FakeClock()
        b = TorchWorkBackend(device="cpu", run_mode="chunked", pipeline=1, clock=clock,
                             device_suspect_after=5.0)
        await b.setup()
        before = _metric("dpow_backend_evacuations_total", "launch_hang")
        with FaultyDevice() as fd:
            fd.hang_at_poll(0, 0)  # blocks the launch boundary
            h = random_hash()
            t = asyncio.ensure_future(b.generate(WorkRequest(h, EASY)))
            await _spin_until(lambda: ("launch", 0, -1) in fd.events, msg="launch hang")
            await clock.advance(6.5)
            assert _metric("dpow_backend_evacuations_total", "launch_hang") - before == 0, (
                "backstop fired inside the first launch's grace")
            await clock.advance(5.5)
            assert _metric("dpow_backend_evacuations_total", "launch_hang") - before == 1
            assert b._dfd.state(0) == HEALTHY, "chunked backstop must not quarantine"
            fd.release(0)
            work = await asyncio.wait_for(t, 60)
            nc.validate_work(h, work, EASY)
        await b.close()

    asyncio.run(asyncio.wait_for(run(), 60))


@pytest.fixture(autouse=True)
def slot_ledger_clean():
    LEDGER.reset()
    yield
    # A wedged thread released at the end of a drill may still be draining.
    for _ in range(200):
        if not LEDGER.outstanding():
            break
        import time

        time.sleep(0.01)
    assert LEDGER.outstanding() == {}, LEDGER.outstanding_keys()


def test_suspect_state_is_transient():
    """mark_suspect() then quarantine(): a suspect member leaves the
    healthy set at once (later launches run at degraded width)."""
    dfd = devfault.DeviceFaultDomains(3, suspect_after=1.0, probe_interval=2.0,
                                      clock=FakeClock(), name="t2")
    dfd.mark_suspect(1)
    assert dfd.state(1) == SUSPECT and dfd.healthy_devices() == [0, 2]
