"""The port's control channel (ops/control.py) against tpu_dpow's.

The same scripted commands and device polls go to ``tpu_dpow``'s
``LaunchControl`` and to the port's copy; every poll snapshot and every
piece of delivery bookkeeping must come out identical. The port keeps its own
slot table and its own LeakLedger, which reads zero outstanding slots after
each test.
"""

import numpy as np
import pytest

from tpu_dpow.ops import control as jctl
from tpu_dpow.resilience.clock import FakeClock as JaxFakeClock
from tpu_dpow_torch.obs import LEDGER
from tpu_dpow_torch.ops import control as tctl
from tpu_dpow_torch.resilience.clock import FakeClock

UNREACH = (1 << 64) - 2


class TickClock:
    """Monotonic stamps: every read advances 0.125 s, so identical call
    sequences give identical latencies in both packages."""

    def __init__(self):
        self.t = 0.0

    def time(self) -> float:
        self.t += 0.125
        return self.t


@pytest.fixture(autouse=True)
def slot_ledger_clean():
    LEDGER.reset()
    yield
    assert LEDGER.outstanding() == {}, LEDGER.outstanding_keys()


def bookkeeping(c, rows: int, n_dev: int) -> dict:
    """Everything a LaunchControl exposes to the engine, as plain data."""
    keys = [(r, d) for r in range(rows) for d in range(n_dev)]
    return {
        "polls": c.polls,
        "last_k": c.last_k,
        "poll_k": dict(c.poll_k),
        "poll_t": dict(c.poll_t),
        "first_poll_t": c.first_poll_t,
        "done_at_k": dict(c.done_at_k),
        "delivered": list(c.delivered),
        "effective_base": [c.effective_base(r, d) for r, d in keys],
        "effective_difficulty": [c.effective_difficulty(r, d) for r, d in keys],
        "effective_epoch": [c.effective_epoch(r, -1, d) for r, d in keys],
        "applied_at_k": [c.applied_at_k(r, d) for r, d in keys],
        "windows_run": [c.windows_run(r, 64, d) for r, d in keys],
        "confirmed": [c.confirmed_no_hit_windows(r, d, 4) for r, d in keys],
        "accounted": [c.device_accounted(d, 64, 4) for d in range(n_dev)],
        "last_poll": [c.last_poll(d) for d in range(n_dev)],
    }


def play(script, rows: int, n_dev: int = 1):
    """Run ``script`` against both packages' LaunchControl; every write's
    return value and every poll snapshot must agree. Returns the port's."""
    pair = [
        jctl.LaunchControl(rows, clock=TickClock(), n_dev=n_dev),
        tctl.LaunchControl(rows, clock=TickClock(), n_dev=n_dev),
    ]
    for op, *args in script:
        if op == "poll":
            dev, k, done = args
            snaps = [c.poll(dev, k, np.array(done, dtype=bool)) for c in pair]
            assert snaps[0].dtype == snaps[1].dtype == np.uint32
            np.testing.assert_array_equal(snaps[0], snaps[1])
        elif op in ("raise", "rebase"):
            row, value, epoch = args
            fn = "raise_difficulty" if op == "raise" else "rebase"
            got = [getattr(c, fn)(row, value, epoch=epoch) for c in pair]
            assert got[0] == got[1], (op, args)
        else:  # cancel / kill / kill_all
            got = [getattr(c, op)(*args) for c in pair]
            assert got[0] == got[1], (op, args)
    assert bookkeeping(pair[0], rows, n_dev) == bookkeeping(pair[1], rows, n_dev)
    return pair[1]


LIVE2 = [False, False]

SCRIPTS = {
    "cancel": [
        ("poll", 0, 0, LIVE2), ("cancel", 1), ("poll", 0, 4, LIVE2),
        ("poll", 0, 8, [False, True]),
    ],
    "raise": [
        ("raise", 0, 0xFFFF000000000000, 3), ("poll", 0, 0, LIVE2),
        ("poll", 0, 1, LIVE2), ("raise", 0, UNREACH, 4), ("poll", 0, 2, [False, True]),
    ],
    "rebase": [
        ("poll", 0, 0, LIVE2), ("rebase", 1, 9 << 40, 7), ("poll", 0, 1, LIVE2),
        ("rebase", 1, (1 << 64) + 5, 8), ("poll", 0, 2, LIVE2),
    ],
    "kill": [
        ("raise", 0, UNREACH, 1), ("kill", 0), ("cancel", 0), ("rebase", 0, 123, 2),
        ("raise", 0, UNREACH, 2), ("cancel", 1), ("poll", 0, 0, LIVE2),
        ("poll", 0, 4, [True, True]),
    ],
    "kill_all": [("poll", 0, 0, LIVE2), ("kill_all",), ("poll", 0, 3, LIVE2)],
    "superseded_commands": [
        ("raise", 1, 0xFFFF000000000000, 1), ("rebase", 1, 77, 2), ("cancel", 1),
        ("poll", 0, 0, LIVE2), ("poll", 0, 1, LIVE2),
    ],
    "done_rows_never_apply": [
        ("raise", 0, UNREACH, 5), ("rebase", 1, 1 << 50, 5),
        ("poll", 0, 2, [True, True]), ("poll", 0, 3, [True, False]),
    ],
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_scripted_commands_give_identical_polls_and_bookkeeping(name):
    play(SCRIPTS[name], rows=2)


def test_fan_devices_are_tracked_per_device():
    """Two fan devices poll independently: per-(row, device) delivery, one
    rebase base per device, and a device that went done first never applies."""
    c = play([
        ("poll", 0, 0, LIVE2), ("rebase", 0, [10 << 32, 20 << 32], 3),
        ("poll", 1, 1, [True, False]), ("poll", 0, 1, LIVE2),
        ("raise", 1, UNREACH, 4), ("poll", 1, 2, [True, False]), ("poll", 0, 3, [False, True]),
    ], rows=2, n_dev=2)
    assert c.effective_base(0, 0) == 10 << 32
    assert c.effective_base(0, 1) is None  # device 1 had row 0 done at delivery
    with pytest.raises(ValueError):
        c.rebase(0, [1, 2, 3], epoch=9)


def test_seeded_random_scripts_agree():
    rng = np.random.default_rng(71)
    for _ in range(20):
        script, k = [], 0
        for _ in range(24):
            op = rng.integers(0, 6)
            row = int(rng.integers(0, 3))
            if op == 0:
                script.append(("cancel", row))
            elif op == 1:
                script.append(("raise", row, int(rng.integers(0, 1 << 63)) * 2, int(rng.integers(0, 4))))
            elif op == 2:
                script.append(("rebase", row, int(rng.integers(0, 1 << 62)), int(rng.integers(0, 4))))
            elif op == 3 and rng.random() < 0.3:
                script.append(("kill", row))
            else:
                k += int(rng.integers(0, 3))
                script.append(("poll", int(rng.integers(0, 2)), k, list(rng.random(3) < 0.3)))
        play(script, rows=3, n_dev=2)


def test_word_layout_matches():
    for name in ("IDX_FLAGS", "IDX_SEQ", "IDX_DIFF_LO", "IDX_DIFF_HI", "IDX_BASE_LO",
                 "IDX_BASE_HI", "CTRL_WORDS", "FLAG_CANCEL", "FLAG_RAISE", "FLAG_REBASE"):
        assert getattr(tctl, name) == getattr(jctl, name), name


def test_released_slot_polls_dead_zeros_and_tables_are_separate():
    c = tctl.LaunchControl(3, clock=TickClock())
    slot = tctl.register(c)
    assert LEDGER.outstanding() == {"slot": 1}
    assert slot not in jctl._slots  # the port's own table
    c.cancel(1)
    live = tctl.poll_slot(slot, 0, 0, np.zeros(3, dtype=bool))
    assert live[1, tctl.IDX_FLAGS] == int(tctl.FLAG_CANCEL)
    tctl.release(slot)
    tctl.release(slot)  # idempotent: the ledger is discharged once
    for mod in (jctl, tctl):
        out = mod.poll_slot(slot, 0, 0, np.zeros(3, dtype=bool))
        assert out.shape == (3, mod.CTRL_WORDS) and out.sum() == 0


def test_poll_to_effect_latency_rides_the_injected_fake_clock():
    """Issue→delivery latency on a FakeClock, in both packages."""
    out = []
    for mod, clock in ((jctl, JaxFakeClock()), (tctl, FakeClock())):
        c = mod.LaunchControl(1, clock=clock)
        c.cancel(0)
        clock._now += 2.5  # no sleepers: advance the fake time directly
        c.poll(0, 4, np.array([False]))
        out.append(c.delivered)
    assert out[0] == out[1] == [(0, "cancel", 2.5, 0)]
