"""The port's multi-window run loop (ops/runloop.py) against tpu_dpow's.

The same uint32[B, 12] rows, made from a seed with numpy, go through
``tpu_dpow.ops.runloop.search_run_batch(_controlled)`` — under the XLA
scanner and under the Pallas kernel in interpret mode — and through the
port's plain ``search_run_batch(_controlled)``. The winning nonces must be
bit-equal, and for controlled launches the two ``LaunchControl`` blocks
(each package's own, scripted from inside ``poll`` so delivery timing is
deterministic) must end with identical bookkeeping: polls, last_k,
done_at_k, delivered commands with their latencies, and effective base,
difficulty and epoch.

The persistent CUDA kernel is held against the plain version on the card by
the ``cuda``-marked test in tests/test_torch_package.py.
"""

import hashlib
import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_dpow.ops import control as jctl
from tpu_dpow.ops import runloop as jrl
from tpu_dpow_torch.obs import LEDGER
from tpu_dpow_torch.ops import control as tctl
from tpu_dpow_torch.ops import search
from tpu_dpow_torch.ops import runloop as trl

# The suite runs in parallel worker processes: one intra-op thread each
# keeps these tests from crowding out the others on the same cores.
torch.set_num_threads(1)

EASY = 0xFFF0000000000000
UNREACH = (1 << 64) - 2  # unreachable target that is still a valid raise
MAX_U64 = (1 << 64) - 1
GEO = dict(sublanes=8, iters=2)
W = 8 * 128 * 2  # the window of GEO


def val(h: bytes, nonce: int) -> int:
    return int.from_bytes(
        hashlib.blake2b((nonce & MAX_U64).to_bytes(8, "little") + h, digest_size=8).digest(),
        "little",
    )


def plant_above(h: bytes, start: int, floor: int) -> int:
    """First nonce >= start whose value exceeds ``floor``."""
    return next(n for n in itertools.count(start) if val(h, n) > floor)


class TickClock:
    def __init__(self):
        self.t = 0.0

    def time(self) -> float:
        self.t += 0.125
        return self.t


def scripted(base, script):
    """A LaunchControl of ``base``'s package that runs ``script(self, k,
    done)`` at the start of every poll, before the poll is served."""

    class Scripted(base):
        def poll(self, dev, k, done):
            script(self, int(k), np.asarray(done, dtype=bool))
            return super().poll(dev, k, done)

    return Scripted


def once(tag, k_min, fn):
    """A script step: ``fn(control)`` at the first poll with k >= k_min."""

    def step(c, k, done):
        fired = c.__dict__.setdefault("fired", set())
        if k >= k_min and tag not in fired:
            fired.add(tag)
            fn(c)

    return step


def chain(*steps):
    def script(c, k, done):
        for s in steps:
            s(c, k, done)

    return script


def bookkeeping(c, rows: int) -> dict:
    return {
        "polls": c.polls,
        "last_k": c.last_k,
        "done_at_k": dict(c.done_at_k),
        "delivered": list(c.delivered),
        "base": [c.effective_base(r) for r in range(rows)],
        "difficulty": [c.effective_difficulty(r) for r in range(rows)],
        "epoch": [c.effective_epoch(r, -1) for r in range(rows)],
        "applied_at_k": [c.applied_at_k(r) for r in range(rows)],
    }


def nonces(lo, hi) -> list:
    lo = np.asarray(lo).view(np.uint32) if np.asarray(lo).dtype != np.uint32 else np.asarray(lo)
    hi = np.asarray(hi).view(np.uint32) if np.asarray(hi).dtype != np.uint32 else np.asarray(hi)
    return [(int(h) << 32) | int(x) for x, h in zip(lo, hi)]


def jax_kw(kernel: str) -> dict:
    return {"kernel": kernel, "interpret": True} if kernel == "pallas" else {"kernel": kernel}


def run_both(rows, *, max_steps, poll_steps=None, script=None, active=None, kernel="xla"):
    """One launch through each package → (port nonces, port control or None).
    Asserts bit-equal nonces and identical bookkeeping."""
    rows = np.asarray(rows, dtype=np.uint32)
    b = rows.shape[0]
    act_j = None if active is None else jnp.asarray(np.asarray(active, dtype=bool))
    act_t = None if active is None else torch.from_numpy(np.asarray(active, dtype=bool))
    params = search.params_from_numpy(rows)
    if poll_steps is None:
        lo, hi = jrl.search_run_batch(
            jnp.asarray(rows), act_j, max_steps=max_steps, **GEO, **jax_kw(kernel)
        )
        want = nonces(lo, hi)
        got = nonces(*map(search.offsets_to_numpy, trl.search_run_batch(
            params, act_t, max_steps=max_steps, **GEO
        )))
        assert got == want
        return got, None
    script = script or (lambda c, k, done: None)
    cj = scripted(jctl.LaunchControl, script)(b, clock=TickClock())
    ct = scripted(tctl.LaunchControl, script)(b, clock=TickClock())
    slot = jctl.register(cj)
    try:
        lo, hi = jrl.search_run_batch_controlled(
            jnp.asarray(rows), act_j, jnp.uint32(slot), max_steps=max_steps,
            poll_steps=poll_steps, **GEO, **jax_kw(kernel),
        )
        # Force the result before the slot dies (jax dispatch is async).
        want = nonces(np.asarray(lo), np.asarray(hi))
    finally:
        jctl.release(slot)
    slot = tctl.register(ct)
    try:
        got = nonces(*map(search.offsets_to_numpy, trl.search_run_batch_controlled(
            params, act_t, slot, max_steps=max_steps, poll_steps=poll_steps, **GEO
        )))
    finally:
        tctl.release(slot)
    assert got == want
    assert bookkeeping(ct, b) == bookkeeping(cj, b)
    return got, ct


@pytest.fixture(autouse=True)
def slot_ledger_clean():
    LEDGER.reset()
    yield
    assert LEDGER.outstanding() == {}, LEDGER.outstanding_keys()


def mixed_rows(seed: int) -> np.ndarray:
    """Pads, a 2^32 and a 2^64 carry, easy rows, a harder row and a dry row."""
    rng = np.random.default_rng(seed)
    spec = [
        (bytes(32), 0, 0),  # pad, as the engine packs it
        (rng.bytes(32), EASY, (5 << 32) - 300),  # crosses 2^32
        (rng.bytes(32), EASY, MAX_U64 - 300),  # crosses 2^64
        (rng.bytes(32), EASY, int(rng.integers(0, 1 << 62))),
        (rng.bytes(32), 0xFFFC000000000000, int(rng.integers(0, 1 << 62))),
        (rng.bytes(32), MAX_U64, int(rng.integers(0, 1 << 62))),  # dry
    ]
    return np.stack([search.pack_params(h, d, base) for h, d, base in spec])


# -- the loop without control ---------------------------------------------------


@pytest.mark.parametrize("kernel", ["xla", "pallas"])
def test_run_batch_matches_with_pads_carries_and_a_dry_row(kernel):
    got, _ = run_both(mixed_rows(5), max_steps=6, kernel=kernel)
    assert got[0] == 0  # the pad hits at its base
    assert got[5] == MAX_U64  # dry
    assert got[1] >= 5 << 32 and got[2] < 1 << 20  # both carries crossed


@pytest.mark.parametrize("seed", [11, 12])
def test_run_batch_active_mask_pins_inactive_rows_unsolved(seed):
    active = [True, True, False, True, False, True]
    got, _ = run_both(mixed_rows(seed), max_steps=6, active=active)
    assert got[2] == got[4] == MAX_U64


def test_run_batch_rejects_a_window_of_2_31():
    with pytest.raises(ValueError):
        trl.search_run_batch(search.params_from_numpy(mixed_rows(1)), None,
                             max_steps=1, sublanes=1024, iters=1 << 14)


# -- the controlled loop (test_persistent.py's runloop-level scenarios) ---------


@pytest.mark.parametrize("poll_steps", [3, 4])
def test_controlled_loop_without_commands_matches_plain_run(poll_steps):
    """Dead control (no commands) changes nothing; max_steps 10 is not a
    multiple of either poll interval."""
    rows = mixed_rows(7)
    plain, _ = run_both(rows, max_steps=10)
    got, c = run_both(rows, max_steps=10, poll_steps=poll_steps)
    assert got == plain
    assert c.polls >= 1 and not c.delivered


def test_controlled_loop_with_active_mask():
    active = [False, True, True, True, True, True]
    got, c = run_both(mixed_rows(8), max_steps=10, poll_steps=4, active=active)
    assert got[0] == MAX_U64 and c.done_at_k[(0, 0)] == 0


@pytest.mark.parametrize("kernel", ["xla", "pallas"])
def test_mid_launch_cancel_exits_within_one_poll_interval(kernel):
    h = bytes(range(32))
    rows = np.stack([search.pack_params(h, UNREACH, 0)])
    got, c = run_both(rows, max_steps=4096, poll_steps=4, kernel=kernel,
                      script=once("c", 8, lambda c: c.cancel(0)))
    assert got == [MAX_U64]
    assert c.delivered and c.delivered[0][1] == "cancel"
    assert c.last_k <= 12 and c.done_at_k[(0, 0)] <= 12
    assert c.windows_run(0, 4096) <= 12


def test_mid_launch_rebase_moves_the_frontier():
    h = bytes(range(1, 33))
    m = max(val(h, j) for j in range(8 * W))  # the pre-rebase span's best
    target = 9 << 40
    planted = plant_above(h, target, m)
    rows = np.stack([search.pack_params(h, val(h, planted), 0)])
    got, c = run_both(rows, max_steps=1 << 14, poll_steps=1,
                      script=once("r", 1, lambda c: c.rebase(0, target, epoch=7)))
    assert got[0] >= target and val(h, got[0]) >= val(h, planted)
    assert c.effective_base(0) == target and c.effective_epoch(0, default=0) == 7


def test_mid_launch_raise_retargets_in_place():
    h = bytes(range(2, 34))
    m = max(val(h, j) for j in range(W))  # the first window's best value
    planted = plant_above(h, W, m)
    rows = np.stack([search.pack_params(h, EASY, 0)])
    got, c = run_both(rows, max_steps=4096, poll_steps=1,
                      script=once("r", 0, lambda c: c.raise_difficulty(0, val(h, planted), epoch=1)))
    assert got[0] >= W and val(h, got[0]) >= val(h, planted)
    assert c.effective_difficulty(0) == val(h, planted)


def test_killed_row_stops_and_its_sibling_runs_on():
    rng = np.random.default_rng(9)
    rows = np.stack([
        search.pack_params(rng.bytes(32), UNREACH, 3 << 32),
        search.pack_params(rng.bytes(32), 0xFFFE000000000000, 77),
    ])
    got, c = run_both(rows, max_steps=40, poll_steps=2, script=chain(
        once("k", 2, lambda c: c.kill(0)),
        once("late", 4, lambda c: c.rebase(0, 5, epoch=3)),  # refused: dead
    ))
    assert got[0] == MAX_U64 and c.done_at_k[(0, 0)] == 2
    assert c.effective_base(0) is None


def test_commands_on_a_mixed_batch_with_carries():
    """Cancel, raise and rebase at different polls on one batch with pads and
    carry rows; max_steps 11 is not a multiple of the poll interval."""
    rows = mixed_rows(21)
    rows[5] = search.pack_params(bytes(range(5, 37)), UNREACH, (7 << 32) - 900)
    got, c = run_both(rows, max_steps=11, poll_steps=3, script=chain(
        once("raise", 0, lambda c: c.raise_difficulty(4, 0xFFFE000000000000, epoch=2)),
        once("rebase", 1, lambda c: c.rebase(5, MAX_U64 - 5000, epoch=4)),
        once("cancel", 6, lambda c: c.cancel(5)),
    ))
    assert c.polls >= 2


@pytest.mark.parametrize("seed", range(4))
def test_seeded_command_scripts(seed):
    rng = np.random.default_rng(100 + seed)
    rows = mixed_rows(200 + seed)
    events = []
    for i in range(4):
        row, k_min = int(rng.integers(1, 6)), int(rng.integers(0, 8))
        kind = int(rng.integers(0, 3))
        if kind == 0:
            events.append(once(i, k_min, lambda c, r=row: c.cancel(r)))
        elif kind == 1:
            d = int(rng.integers(1 << 62, 1 << 63)) * 2 | 0xFFF0000000000000
            events.append(once(i, k_min, lambda c, r=row, d=d: c.raise_difficulty(r, d, epoch=1)))
        else:
            base = int(rng.integers(0, 1 << 63))
            events.append(once(i, k_min, lambda c, r=row, b=base: c.rebase(r, b, epoch=2)))
    run_both(rows, max_steps=9, poll_steps=int(rng.integers(1, 4)), script=chain(*events))


def test_poll_raising_is_the_callers_error():
    """A control poll that raises stops the plain loop with that error."""

    class Broken(tctl.LaunchControl):
        def poll(self, dev, k, done):
            raise RuntimeError("control block gone")

    slot = tctl.register(Broken(1, clock=TickClock()))
    try:
        with pytest.raises(RuntimeError, match="gone"):
            trl.search_run_batch_controlled(
                search.params_from_numpy(mixed_rows(3)[:1]), None, slot,
                max_steps=4, poll_steps=1, **GEO,
            )
    finally:
        tctl.release(slot)


# -- strided windows (the device fan's run loop) --------------------------------


def strided_both(rows, *, stride, max_steps, poll_steps=None, script=None):
    """The port's loop with ``stride`` against tpu_dpow's run_loop_core with
    ``window=stride`` around a one-window scan — without control under jit,
    with control as a one-device fan_search_run_controlled. Asserts
    bit-equal nonces and identical bookkeeping → (port nonces, control)."""
    import jax

    from tpu_dpow.ops import search as jsearch
    from tpu_dpow.parallel import fan_search as jfan

    rows = np.asarray(rows, dtype=np.uint32)
    params = search.params_from_numpy(rows)
    if poll_steps is None:
        ref = jax.jit(lambda p: jrl.run_loop_core(
            p, None, launch=lambda q: jsearch.search_chunk_batch(q, chunk_size=W),
            window=stride, max_steps=max_steps))
        want = nonces(*ref(jnp.asarray(rows)))
        got = nonces(*map(search.offsets_to_numpy, trl.search_run_batch(
            params, None, max_steps=max_steps, stride=stride, **GEO)))
        assert got == want
        return got, None
    cj = scripted(jctl.LaunchControl, script)(rows.shape[0], clock=TickClock())
    ct = scripted(tctl.LaunchControl, script)(rows.shape[0], clock=TickClock())
    slot = jctl.register(cj)
    try:
        lo, hi = jfan.fan_search_run_controlled(
            rows[None], slot, devices=jax.devices()[:1], chunk_per_shard=W,
            max_steps=max_steps, poll_steps=poll_steps, stride=stride)
        want = nonces(np.asarray(lo)[0], np.asarray(hi)[0])
    finally:
        jctl.release(slot)
    slot = tctl.register(ct)
    try:
        got = nonces(*map(search.offsets_to_numpy, trl.search_run_batch_controlled(
            params, None, slot, max_steps=max_steps, poll_steps=poll_steps, stride=stride,
            **GEO)))
    finally:
        tctl.release(slot)
    assert got == want
    assert bookkeeping(ct, rows.shape[0]) == bookkeeping(cj, rows.shape[0])
    return got, ct


@pytest.mark.parametrize("stride_windows", [1, 4, 7])
def test_strided_windows_match_the_reference_loop(stride_windows):
    """Window k scans [base + k*stride, + window): the rows' first hits are
    the reference's, carries included; stride == window is the contiguous
    scan."""
    rows = mixed_rows(40 + stride_windows)
    got, _ = strided_both(rows, stride=stride_windows * W, max_steps=9)
    assert got[0] == 0 and got[5] == MAX_U64


def test_strided_hit_in_a_later_window_is_the_lowest_k():
    """A hash whose best value over the first three strided windows lies in
    the third: that nonce is the row's first hit, though nonces between the
    windows (never scanned) may be better."""
    stride = 3 * W
    rng = np.random.default_rng(77)
    while True:
        h = rng.bytes(32)
        scanned = [k * stride + j for k in range(3) for j in range(W)]
        best = max(scanned, key=lambda j: val(h, j))
        if best >= 2 * stride:
            break
    got, _ = strided_both(np.stack([search.pack_params(h, val(h, best), 0)]), stride=stride,
                          max_steps=6)
    assert got == [best]


@pytest.mark.parametrize("poll_steps", [1, 2])
def test_strided_controlled_loop_with_raise_and_cancel(poll_steps):
    """The chip's strided check on the CPU: a raise at k = 0 and a cancel at
    k = 2, at stride = 4 windows."""
    rows = mixed_rows(50)
    rows[5] = search.pack_params(bytes(range(7, 39)), UNREACH, (9 << 32) - 50)
    got, c = strided_both(rows, stride=4 * W, max_steps=8, poll_steps=poll_steps, script=chain(
        once("raise", 0, lambda c: c.raise_difficulty(4, 0xFFFF800000000000, epoch=3)),
        once("cancel", 2, lambda c: c.cancel(5)),
    ))
    assert got[5] == MAX_U64 and c.done_at_k[(5, 0)] <= 2 + poll_steps
    assert c.effective_difficulty(4) == 0xFFFF800000000000


def test_stride_below_the_window_is_refused():
    with pytest.raises(ValueError, match="stride"):
        trl.search_run_batch(search.params_from_numpy(mixed_rows(1)), None, max_steps=1,
                             stride=W - 1, **GEO)
