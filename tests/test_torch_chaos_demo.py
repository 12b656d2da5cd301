"""The port's chaos_demo against tpu_dpow's (after tests/test_chaos.py and
tests/test_devfault.py).

``scenario()`` (dropped publish, a failing primary engine behind the port's
``FailoverBackend``, a store outage) and ``fleet_scenario()`` (a worker
killed mid-range, its shard re-covered) must tell the same story, inject the
same faults and leave the same metric families as the reference's. The
device scenario runs the torch engine's persistent fan on eight logical CPU
members: a wedged member is evacuated and re-admitted. With one member it
fails, as the reference's does, and the entry point says why.
"""

import asyncio
import os
import subprocess
import sys

import jax
import pytest
import torch

from tpu_dpow.backend import DevicesExhausted as JaxDevicesExhausted
from tpu_dpow.scripts import chaos_demo as jdemo
from tpu_dpow_torch.scripts import chaos_demo as demo

# The suite runs in parallel worker processes: one intra-op thread each
# keeps these tests from crowding out the others on the same cores.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run(coro, timeout=60):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def test_scenario_matches_the_reference():
    got = run(demo.scenario())
    want = run(jdemo.scenario())
    assert got == want
    assert got["primary_store_reconciled"]
    assert {e["action"] for e in got["chaos_events"]} == {"drop", "error"}
    assert got["metrics"]["dpow_breaker_state"]["series"]["backend:flaky"] == 1.0
    assert got["metrics"]["dpow_client_backend_failover_total"]["series"] == {
        "flaky,error": 3.0}
    assert got["metrics"]["dpow_server_work_republished_total"]["series"][""] >= 1.0


def test_fleet_scenario_matches_the_reference():
    got = run(demo.fleet_scenario())
    want = run(jdemo.fleet_scenario())
    assert got == want
    assert got["result_landed"] and got["recovered_ranges"] >= 1


def test_device_scenario_on_eight_cpu_members_evacuates_and_readmits():
    result = run(demo.device_scenario(device="cpu", members=8), 120)
    assert result["readmitted"]
    assert result["evacuations"] == 1
    health = result["metrics"]["dpow_backend_device_health"]["series"]
    assert set(health) == {str(d) for d in range(8)} and not any(health.values())
    assert result["metrics"]["dpow_backend_quarantine_total"]["series"][
        "quarantined->healthy"] == 1.0


def test_device_scenario_with_one_member_fails_like_the_reference(monkeypatch):
    with pytest.raises(ValueError, match=r"gives 1; run it with --device cpu --members 8"):
        run(demo.device_scenario(device="cpu", members=1))
    real = jax.local_devices
    monkeypatch.setattr(jax, "local_devices", lambda *a, **k: real(*a, **k)[:1])
    with pytest.raises(JaxDevicesExhausted):
        run(jdemo.device_scenario(), 120)


def test_entry_point_with_one_member_exits_nonzero_and_says_why(capsys):
    assert demo.main(["--device", "cpu", "--members", "1"]) == 2
    err = capsys.readouterr().err
    assert "--device cpu gives 1" in err and "--device cpu --members 8" in err


def test_entry_point_without_a_card_refuses_instead_of_falling_back():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, "-m", "tpu_dpow_torch.scripts.chaos_demo"], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 2
    assert out.stdout == ""
    assert "--device cuda gives 0" in out.stderr and "--device cpu --members 8" in out.stderr


def test_entry_point_on_two_cpu_members_completes(capsys):
    assert demo.main(["--device", "cpu", "--members", "2"]) == 0
    out = capsys.readouterr().out
    for line in ("scenario completed", "fleet scenario completed", "device scenario completed"):
        assert line in out
    assert "FAILED" not in out and "2-way persistent fan launched; device 1 wedged" in out
