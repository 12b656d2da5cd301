"""The port's discrete-event twin of the replica ring
(``tpu_dpow_torch/loadgen/sim.py``) against ``tpu_dpow.loadgen.sim``.

tests/test_autoscale.py's flash-crowd shape (a compressed 3→8 req/s day
with a 10x crowd at the crest) runs through both packages with and without
the SLO controller in the loop, over several seeds: the SimOutcome (summary,
replica timeline, decision count, coalesced, store and precache hits, peak)
and the decision journal must be equal. The fixed fleet breaches the SLO
and the controlled one holds it; the port's journal replays in both
packages. Then the lever mapping, the precache model and the clock.
"""

import dataclasses
import io
import json
import math

import numpy as np
import pytest

import tpu_dpow.autoscale as ja
import tpu_dpow.loadgen as jl
import tpu_dpow_torch.autoscale as ta
import tpu_dpow_torch.loadgen as tl
from tpu_dpow import obs as jobs
from tpu_dpow.loadgen import sim as jsim
from tpu_dpow_torch import obs as tobs
from tpu_dpow_torch.loadgen import sim as tsim

PKG = {
    "port": dict(a=ta, l=tl, sim=tsim, obs=tobs),
    "jax": dict(a=ja, l=jl, sim=jsim, obs=jobs),
}
SPIKE_CFG = dict(slo_p95_ms=2000.0, slo_poll_interval=1.0, slo_breach_polls=2,
                 slo_clear_polls=8, slo_cooldown=5.0, slo_max_replicas=3,
                 slo_queue_high=24.0)
SEEDS = [5] + [int(s) for s in np.random.default_rng(2040).integers(0, 1 << 20, size=2)]


def spike_run(name: str, *, controlled: bool, seed: int, n: int = 6000,
              params: dict = None) -> tuple:
    """tests/test_autoscale.py's ``_spike_run`` through one package:
    (SimOutcome, journal text or None)."""
    m = PKG[name]
    m["obs"].reset()
    ctrl = journal = buf = None
    if controlled:
        cfg = m["a"].AutoscaleConfig(**SPIKE_CFG)
        ctrl = m["a"].SLOController(cfg, initial_replicas=1)
        buf = io.StringIO()
        journal = m["a"].DecisionJournal(buf, cfg, initial_state=ctrl.state_dict())
    rate = m["l"].SpikeOverlay(m["l"].DiurnalRate(3.0, 8.0, period=400.0), at=200.0,
                               duration=60.0, factor=10.0)
    sim = m["sim"].ClusterSim(
        m["sim"].SimParams(**(params or dict(window=8, queue_limit=192, service_median=0.22,
                                             service_sigma=0.3, spawn_delay=3.0,
                                             precache_util=0.2))),
        replicas=1, seed=seed, controller=ctrl, journal=journal, poll_interval=1.0)
    out = sim.run(m["l"].poisson_schedule(rate, n=n, seed=seed),
                  m["l"].ServicePopulation(150, seed=seed), slo_p95_ms=2000.0)
    return out, (buf.getvalue() if buf is not None else None)


def outcome(out) -> dict:
    return json.loads(json.dumps(dataclasses.asdict(out), default=str))


@pytest.mark.parametrize("controlled", [False, True])
@pytest.mark.parametrize("seed", SEEDS)
def test_spike_runs_give_equal_outcomes_and_journals(seed, controlled):
    port, port_journal = spike_run("port", controlled=controlled, seed=seed)
    ref, ref_journal = spike_run("jax", controlled=controlled, seed=seed)
    assert outcome(port) == outcome(ref)
    assert port_journal == ref_journal
    assert port.summary["n"] == 6000
    if controlled:
        assert port.decisions > 0
        lines = port_journal.splitlines()
        assert len(lines) > 100
        for replay in (ta.replay, ja.replay):
            report = replay(io.StringIO(port_journal))
            assert report.ok, report.render()
            assert report.entries == len(lines) - 1


@pytest.mark.parametrize("seed", SEEDS)
def test_fixed_fleet_breaches_and_the_controller_holds(seed):
    """The reference's acceptance smoke, through the port: the fixed N=1
    fleet loses the crowd (p95 +Inf), the controlled fleet scales to 3,
    serves it with a finite p95 and retires replicas only on a drained
    window."""
    baseline, _ = spike_run("port", controlled=False, seed=seed)
    scaled, journal = spike_run("port", controlled=True, seed=seed)
    assert math.isinf(baseline.summary["p95_ms"])
    assert math.isfinite(scaled.summary["p95_ms"])
    assert scaled.summary["slo"]["window_hold_ratio"] > baseline.summary["slo"]["window_hold_ratio"]
    assert scaled.peak_replicas == 3
    assert scaled.summary["outcomes"]["ok"] > 1.3 * baseline.summary["outcomes"]["ok"]
    assert scaled.coalesced > 0 and scaled.store_hits > 0
    entries = [json.loads(ln) for ln in journal.splitlines()[1:]]
    kinds = [a["kind"] for e in entries for a in e["actions"]]
    assert "scale_up" in kinds and "scale_down" in kinds
    for e in entries:
        if any(a["kind"] == "scale_down" for a in e["actions"]):
            assert e["signals"]["queue_depth"] == 0


@pytest.mark.parametrize("seed", SEEDS[:2])
def test_precache_model_gives_equal_outcomes(seed):
    """precache_hit > 0 draws from the sim's RNG on every arrival: the
    draws must come in the same order in both packages."""
    params = dict(window=4, queue_limit=64, service_median=0.3, service_sigma=0.5,
                  spawn_delay=2.0, precache_util=0.25, precache_hit=0.3, store_hit_s=0.01)
    port, pj = spike_run("port", controlled=True, seed=seed, n=3000, params=params)
    ref, rj = spike_run("jax", controlled=True, seed=seed, n=3000, params=params)
    assert outcome(port) == outcome(ref) and pj == rj
    assert port.precache_hits > 0
    assert any(json.loads(ln)["signals"]["precache_hit_ratio"] is not None
               for ln in pj.splitlines()[1:])


def test_apply_action_maps_levers_alike():
    states = []
    for name, m in PKG.items():
        sim = m["sim"].ClusterSim(m["sim"].SimParams(spawn_delay=2.0), replicas=2, seed=1)
        trace = []
        for action in ("scale_up", "shed_precache_on", m["a"].Action("set_horizon", 4.0),
                       "scale_down", "shed_precache_off", "scale_down", "scale_down"):
            sim.apply_action(action)
            sim.clock.now += 2.5
            trace.append((sim.live_count(), sim.precache_open, sim.horizon,
                          sim.signals().to_dict()))
        states.append(trace)
    assert states[0] == states[1]
    assert [t[0] for t in states[0]] == [3, 3, 3, 2, 2, 1, 1]


def test_sim_clock_refuses_to_sleep():
    import asyncio

    clock = tsim.SimClock()
    assert clock.time() == 0.0
    with pytest.raises(RuntimeError):
        asyncio.run(clock.sleep(1.0))


@pytest.mark.slow
def test_million_request_twin_runs_alike():
    """The 1M-arrival capture at bench shape through both packages."""
    outs = []
    for name, m in PKG.items():
        m["obs"].reset()
        cfg = m["a"].AutoscaleConfig(
            slo_p95_ms=1500.0, slo_poll_interval=5.0, slo_breach_polls=2,
            slo_clear_polls=4, slo_cooldown=15.0, slo_max_replicas=3)
        ctrl = m["a"].SLOController(cfg, initial_replicas=1)
        rate = m["l"].SpikeOverlay(m["l"].DiurnalRate(3.0, 8.0, period=400.0), at=200.0,
                                   duration=60.0, factor=10.0)
        sim = m["sim"].ClusterSim(
            m["sim"].SimParams(window=8, queue_limit=192, service_median=0.22,
                               service_sigma=0.3, spawn_delay=3.0, precache_util=0.2),
            replicas=1, seed=14, controller=ctrl, poll_interval=1.0)
        outs.append(sim.run(m["l"].poisson_schedule(rate, n=1_000_000, seed=14),
                            m["l"].ServicePopulation(150, seed=14), slo_p95_ms=2000.0))
    assert outs[0].summary["n"] == 1_000_000
    assert outcome(outs[0]) == outcome(outs[1])
