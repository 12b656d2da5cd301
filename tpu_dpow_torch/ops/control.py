"""Host↔device control channel for persistent launches.

The port's own copy of ``tpu_dpow/ops/control.py``: the same word layout
(``IDX_*``, ``FLAG_*``, ``CTRL_WORDS``), the same bookkeeping, and a slot
table of its own, separate from ``tpu_dpow``'s.

A chunked launch cannot be interrupted, so the engine bounds every launch
at ``run_steps`` windows and applies cancels at relaunch boundaries, which
couples cancel latency to launch length. This module breaks that coupling:
a *running* launch polls host-updatable control state every ``poll_steps``
windows and reacts mid-launch —

  * **cancel** exits the row (the row returns the UNSOLVED marker);
  * **raise** swaps the row's difficulty target in place;
  * **rebase** re-aims the row's scan frontier at a new base (the fleet
    cover_range re-cover, without relaunching).

The device side is ops/runloop.py's ``run_loop_core`` (the plain version)
and the persistent CUDA kernel ``ops/csrc/blake2b_run.cu``, whose leader
thread posts each poll into mapped pinned memory for the launch thread to
answer through :func:`poll_slot` (ops/cuda_kernel.py). This module owns the
host side:

``LaunchControl``
    One launch's control block: a uint32 command array the host writes
    under a lock and the launch thread snapshots at each poll. Commands are
    sequence-numbered so the device applies each rebase exactly once, and
    every write carries an *epoch token*: the engine only writes to
    launches whose epoch snapshot matches the job's current epoch, and
    :meth:`kill` turns a stale launch's control word dead so even a racing
    write is refused.

``register`` / ``release`` / slot ids
    A launch reaches its control block through a slot id in a
    module-level table: one slot registration per launch. A released slot
    polls as all-zeros — dead control, the launch just runs out its span
    (the engine therefore releases a slot only after its launch returned).

Determinism contract: each poll carries the device's live ``done`` mask, so
the host knows exactly which rows observed a command (a row that is already
done at delivery never applies it). Poll stamps ride the injectable
``resilience.Clock`` — FakeClock tests measure poll-to-effect latency
without real sleeps.
"""

from __future__ import annotations

import itertools
import threading
from typing import Dict, List, Optional

import numpy as np

from ..obs.ledger import LEDGER

#: control word layout, one row per batch lane (uint32[n_dev, B, CTRL_WORDS])
IDX_FLAGS = 0  #: bitmask of pending commands
IDX_SEQ = 1  #: command generation; device applies raise/rebase once per seq
IDX_DIFF_LO, IDX_DIFF_HI = 2, 3  #: raised difficulty target
IDX_BASE_LO, IDX_BASE_HI = 4, 5  #: rebased scan base (per device in fan mode)
CTRL_WORDS = 6

FLAG_CANCEL = np.uint32(1)
FLAG_RAISE = np.uint32(2)
FLAG_REBASE = np.uint32(4)

_MASK64 = (1 << 64) - 1

_slots: Dict[int, "LaunchControl"] = {}
_slot_ids = itertools.count(1)
_slots_lock = threading.Lock()

#: Chaos seams (kept from the reference for the fault-domain slice):
#: optional hooks invoked on the DEVICE side of the channel —
#: ``poll_hook(slot, device, k)`` before a control poll is served, ``launch_hook(devices)`` at the top of every
#: engine launch (in the launch executor thread). A hook may BLOCK, which
#: is exactly the fault being injected: a device that stops polling or a
#: launch thread that wedges. Both run outside every lock in this module,
#: so a hanging hook can never deadlock the host-side writers.
_poll_hook = None
_launch_hook = None


def set_poll_hook(hook) -> None:
    """Install (or clear, with None) the control-poll chaos hook."""
    global _poll_hook
    _poll_hook = hook


def set_launch_hook(hook) -> None:
    """Install (or clear, with None) the launch-boundary chaos hook."""
    global _launch_hook
    _launch_hook = hook


def launch_hook(devices) -> None:
    """Called by the engine at the top of every device launch (executor
    thread) with the PHYSICAL fan indices the launch runs on; a no-op
    unless chaos installed a hook."""
    hook = _launch_hook
    if hook is not None:
        hook(tuple(devices))


class LaunchControl:
    """Host-side control block for ONE in-flight persistent launch.

    ``rows`` is the launch's batch width; ``n_dev`` its fan width (1 on the
    plain and mesh paths — the mesh's control is replicated, like its
    params). Writers (the engine's asyncio thread) and the reader (the
    launch's thread, through :func:`poll_slot`) synchronize on one lock;
    the poll snapshot is a copy, so the device never sees a torn row.
    """

    def __init__(self, rows: int, *, clock, n_dev: int = 1, fan_map=None):
        self.rows = rows
        self.n_dev = max(1, n_dev)
        #: launch slice index -> PHYSICAL fan device index. A degraded-width
        #: launch (quarantined devices excluded) runs on a subset of the
        #: fan, so the fan index the device polls with is not the
        #: device's identity; chaos hooks and the watchdog's health
        #: bookkeeping both key on the physical index.
        self.fan_map = list(fan_map) if fan_map is not None else None
        self._clock = clock
        self._lock = threading.Lock()
        self._arr = np.zeros((self.n_dev, rows, CTRL_WORDS), dtype=np.uint32)
        self._dead = np.zeros(rows, dtype=bool)  # epoch-fenced rows
        #: row -> epoch token of the newest accepted command (apply-side key)
        self._epoch_token: Dict[int, int] = {}
        #: row -> issue stamp of the newest not-yet-first-delivered command
        self._issued_at: Dict[int, float] = {}
        #: row -> action name of the newest not-yet-first-delivered command
        self._issued_action: Dict[int, str] = {}
        #: first deliveries: [(row, action, latency_s, epoch_token)] — the
        #: metrics feed (one entry per command, stamped at the FIRST device
        #: that observes it live)
        self.delivered: List[tuple] = []
        #: row -> currently staged rebase base per device / raised target
        #: (the values a device promotes when it consumes the seq)
        self._staged_bases: Dict[int, List[int]] = {}
        self._staged_diff: Dict[int, int] = {}
        #: PER-DEVICE applied state, keyed (row, dev). Delivery is tracked
        #: per device because each fan device polls (and goes done)
        #: independently: a device that exited before observing a command
        #: never applied it, and reading its results against the new
        #: base/target/epoch would corrupt scanned counts, misjudge an
        #: old-target hit as a device bug, and let a stale weak hit
        #: rewind a re-covered frontier.
        self._seen_seq: Dict[tuple, int] = {}
        self._applied_base: Dict[tuple, int] = {}
        self._applied_diff: Dict[tuple, int] = {}
        self._applied_token: Dict[tuple, int] = {}
        #: (row, dev) -> window index at which that device applied the
        #: newest seq-gated command — the boundary between old-partition
        #: and new-partition windows for scan attribution
        self._applied_k: Dict[tuple, int] = {}
        self.polls = 0  # device-side control reads served (all devices)
        self.last_k = 0  # highest window index any device polled at
        #: per-device liveness bookkeeping (launch slice index): last poll
        #: stamp on the injectable clock and last polled window — the
        #: progress signal the engine watchdog (resilience/devfault.py)
        #: derives device health from
        self.poll_t: Dict[int, float] = {}
        self.poll_k: Dict[int, int] = {}
        #: clock stamp of the launch's very first poll on ANY device —
        #: None while the build and launch still sit in front of the
        #: kernel (the watchdog grants that phase a grace deadline: a
        #: cold compile must not read as a dead device)
        self.first_poll_t: Optional[float] = None
        #: (row, dev) -> window index at which that device reported the
        #: row done (or will deterministically stop it: delivered cancel)
        self.done_at_k: Dict[tuple, int] = {}
        #: dev -> (even, regranted): windows that device's run kernel ran
        #: with its grid dealt over every row of the launch, and over fewer
        #: (the done rows' blocks re-granted to the live ones), as its out
        #: words report them (:func:`record_grid`; the plain loop reports
        #: none)
        self.grid_windows: Dict[int, tuple] = {}

    # -- host writers ----------------------------------------------------

    def cancel(self, row: int) -> bool:
        """Ask the device to exit ``row`` at its next poll."""
        with self._lock:
            if self._dead[row]:
                return False
            self._arr[:, row, IDX_FLAGS] |= FLAG_CANCEL
            self._stamp(row, "cancel")
            return True

    def raise_difficulty(self, row: int, difficulty: int, *, epoch: int) -> bool:
        """Swap ``row``'s target in place (host guarantees raise-only)."""
        with self._lock:
            if self._dead[row]:
                return False
            self._arr[:, row, IDX_DIFF_LO] = difficulty & 0xFFFFFFFF
            self._arr[:, row, IDX_DIFF_HI] = (difficulty >> 32) & 0xFFFFFFFF
            self._arr[:, row, IDX_FLAGS] |= FLAG_RAISE
            self._arr[:, row, IDX_SEQ] += 1
            self._epoch_token[row] = epoch
            self._staged_diff[row] = difficulty
            self._stamp(row, "raise")
            return True

    def rebase(self, row: int, bases, *, epoch: int) -> bool:
        """Re-aim ``row``'s frontier: one base per fan device (a scalar or
        length-1 list re-aims every device the same way). ``epoch`` is the
        job's NEW partition epoch; the apply path treats the row as
        re-aimed only if the device actually observed this command."""
        if isinstance(bases, int):
            bases = [bases]
        if len(bases) == 1 and self.n_dev > 1:
            bases = list(bases) * self.n_dev
        if len(bases) != self.n_dev:
            raise ValueError(f"{len(bases)} rebase bases for {self.n_dev} devices")
        with self._lock:
            if self._dead[row]:
                return False
            for d, base in enumerate(bases):
                base &= _MASK64
                self._arr[d, row, IDX_BASE_LO] = base & 0xFFFFFFFF
                self._arr[d, row, IDX_BASE_HI] = base >> 32
            self._arr[:, row, IDX_FLAGS] |= FLAG_REBASE
            self._arr[:, row, IDX_SEQ] += 1
            self._epoch_token[row] = epoch
            self._staged_bases[row] = [b & _MASK64 for b in bases]
            self._stamp(row, "rebase")
            return True

    def kill(self, row: int) -> None:
        """Epoch fence: this launch's control word for ``row`` is dead —
        the job was re-aimed past it and no further command may reach the
        stale row. The row is STOPPED, not just frozen: grinding the
        abandoned region is pure waste, so the word collapses to a bare
        CANCEL (staged raises/rebases cleared — they belong to the new
        epoch's launch) and every later write is refused."""
        with self._lock:
            if self._dead[row]:
                return
            self._dead[row] = True
            self._arr[:, row, :] = 0
            self._arr[:, row, IDX_FLAGS] = FLAG_CANCEL
            self._staged_bases.pop(row, None)
            self._staged_diff.pop(row, None)
            self._stamp(row, "cancel")

    def _stamp(self, row: int, action: str) -> None:
        # One undelivered command per row at a time: a newer write
        # supersedes (the device applies the freshest snapshot anyway).
        self._issued_at[row] = self._clock.time()
        self._issued_action[row] = action

    # -- device reader (poll_slot, launch thread) ------------------------

    def poll(self, dev: int, k: int, done: np.ndarray) -> np.ndarray:
        """One device's control read at window ``k``; ``done`` is ITS live
        per-row done mask. Returns that device's uint32[B, CTRL_WORDS]
        slice. Bookkeeping runs under the lock and mirrors the device loop
        exactly, PER DEVICE: a device that polls a row live with a fresh
        seq will apply the staged raise/rebase in this window block (so
        its applied state promotes here), a device that polls the cancel
        flag live stops the row at this k, and a device that never polls
        a command never has it counted as applied — its results must be
        read against the dispatch snapshot. The ``delivered`` list (the
        metrics feed) stamps each command once, at its first live
        delivery on any device."""
        done = np.asarray(done, dtype=bool)
        dev = min(int(dev), self.n_dev - 1)
        with self._lock:
            self.polls += 1
            self.last_k = max(self.last_k, int(k))
            self.poll_t[dev] = self._clock.time()
            self.poll_k[dev] = max(self.poll_k.get(dev, 0), int(k))
            if self.first_poll_t is None:
                self.first_poll_t = self.poll_t[dev]
            for row in range(min(self.rows, done.shape[0])):
                if done[row]:
                    self.done_at_k.setdefault((row, dev), int(k))
                    continue
                if self._dead[row]:
                    # A killed row carries a bare CANCEL: the device exits
                    # it at this poll. Record the stop and the delivery
                    # stamp, but promote nothing — dead is dead.
                    self.done_at_k.setdefault((row, dev), int(k))
                    t0 = self._issued_at.pop(row, None)
                    if t0 is not None:
                        self.delivered.append(
                            (
                                row,
                                self._issued_action.pop(row, "?"),
                                max(0.0, self._clock.time() - t0),
                                self._epoch_token.get(row, 0),
                            )
                        )
                    continue
                flags = int(self._arr[dev, row, IDX_FLAGS])
                cancelled = bool(flags & int(FLAG_CANCEL))
                if cancelled:
                    # The device exits this row before the next window
                    # block; seq-gated commands are NOT applied by a
                    # cancelled row (the loop's `fresh` mask excludes it).
                    self.done_at_k.setdefault((row, dev), int(k))
                else:
                    seq = int(self._arr[dev, row, IDX_SEQ])
                    if seq != self._seen_seq.get((row, dev), 0):
                        self._seen_seq[(row, dev)] = seq
                        self._applied_k[(row, dev)] = int(k)
                        token = self._epoch_token.get(row, 0)
                        if flags & int(FLAG_RAISE) and row in self._staged_diff:
                            self._applied_diff[(row, dev)] = (
                                self._staged_diff[row]
                            )
                            self._applied_token[(row, dev)] = token
                        if flags & int(FLAG_REBASE) and row in self._staged_bases:
                            bases = self._staged_bases[row]
                            self._applied_base[(row, dev)] = bases[
                                min(dev, len(bases) - 1)
                            ]
                            self._applied_token[(row, dev)] = token
                # First-delivery stamp (metrics): any live observation of
                # the pending command counts, cancel included.
                t0 = self._issued_at.pop(row, None)
                if t0 is not None:
                    action = self._issued_action.pop(row, "?")
                    self.delivered.append(
                        (
                            row,
                            action,
                            max(0.0, self._clock.time() - t0),
                            self._epoch_token.get(row, 0),
                        )
                    )
            return self._arr[dev].copy()

    # -- apply-side lookups ----------------------------------------------

    def effective_base(self, row: int, dev: int = 0) -> Optional[int]:
        """The base device ``dev`` is actually scanning ``row`` from, if
        THAT device applied a rebase; None = its dispatch base stands."""
        with self._lock:
            return self._applied_base.get((row, min(dev, self.n_dev - 1)))

    def effective_difficulty(self, row: int, dev: int = 0) -> Optional[int]:
        """The target device ``dev`` is actually holding ``row`` to, if
        THAT device applied a raise (it applies before scanning on, so any
        hit it returns afterwards meets it); None = dispatch target."""
        with self._lock:
            return self._applied_diff.get((row, min(dev, self.n_dev - 1)))

    def effective_epoch(self, row: int, default: int, dev: int = 0) -> int:
        """The epoch device ``dev``'s results for ``row`` belong to: the
        newest command token THAT device applied, else the dispatch-time
        snapshot — a device that exited before observing a re-aim settles
        under the old epoch's fences."""
        with self._lock:
            return self._applied_token.get(
                (row, min(dev, self.n_dev - 1)), default
            )

    def applied_at_k(self, row: int, dev: int = 0) -> int:
        """The window index at which device ``dev`` applied the newest
        seq-gated command for the row (0 = never applied one) — the scan
        attribution boundary: windows before it belong to the dispatch
        partition, windows after it to the re-aimed one."""
        with self._lock:
            return self._applied_k.get((row, min(dev, self.n_dev - 1)), 0)

    def last_poll(self, dev: int) -> tuple:
        """(clock stamp, window index) of device ``dev``'s newest control
        poll, or (None, -1) when it has not polled yet."""
        with self._lock:
            return self.poll_t.get(dev), self.poll_k.get(dev, -1)

    def device_accounted(self, dev: int, max_steps: int, poll_steps: int) -> bool:
        """True when device ``dev``'s silence needs no explanation: every
        one of its rows is known done (cancelled or reported done at a
        poll), or it already cleared its FINAL poll block — at most
        ``poll_steps`` windows remain after that checkpoint, after which
        the device exits its loop and legitimately never polls again.
        A device that is neither is expected to keep polling; the engine
        watchdog treats its silence as missed progress."""
        with self._lock:
            if all(
                (row, dev) in self.done_at_k for row in range(self.rows)
            ):
                return True
            last_k = self.poll_k.get(dev)
            return last_k is not None and last_k + poll_steps >= max_steps

    def confirmed_no_hit_windows(self, row: int, dev: int, poll_steps: int) -> int:
        """Windows device ``dev`` PROVABLY scanned dry for ``row`` — the
        safe re-cover frontier when a launch's results are being discarded
        (watchdog evacuation): a poll at window k with the row still live
        proves windows [0, k) held no hit. If the row went done at a poll
        (a hit somewhere in the preceding poll block, or a cancel), only
        the windows before that block are provably dry."""
        with self._lock:
            key = (row, min(dev, self.n_dev - 1))
            done_k = self.done_at_k.get(key)
            if done_k is not None:
                return max(0, done_k - max(1, poll_steps))
            return self.poll_k.get(min(dev, self.n_dev - 1), 0)

    def kill_all(self) -> None:
        """Fence every row (see :meth:`kill`) — the whole launch is stale
        (evacuated or abandoned) and must neither be steered nor grind on."""
        for row in range(self.rows):
            self.kill(row)

    def record_grid(self, dev: int, even: int, regranted: int) -> None:
        with self._lock:
            self.grid_windows[int(dev)] = (int(even), int(regranted))

    def windows_run(self, row: int, max_steps: int, dev: int = 0) -> int:
        """Upper bound on windows device ``dev`` actually scanned for the
        row — its ``done_at_k`` when it reported the row done mid-launch
        (or a cancel will deterministically stop it), else ``max_steps``."""
        with self._lock:
            return min(
                self.done_at_k.get(
                    (row, min(dev, self.n_dev - 1)), max_steps
                ),
                max_steps,
            )


def register(control: LaunchControl) -> int:
    """Park a control block in the slot table → the traced slot id."""
    with _slots_lock:
        slot = next(_slot_ids)
        _slots[slot] = control
    LEDGER.acquire("slot", slot)
    return slot


def release(slot: int) -> None:
    """Drop a slot: late polls from a straggler device read all-zeros.
    Idempotent — only the pop that actually removes the slot discharges
    the ledger, so the engine's belt-and-suspenders double releases
    stay count-neutral."""
    with _slots_lock:
        dropped = _slots.pop(slot, None) is not None
    if dropped:
        LEDGER.discharge("slot", slot)


def record_grid(slot, dev, even, regranted) -> None:
    """Hand a finished kernel's grid windows to its slot's control block
    (a released slot drops them, as it answers polls with zeros)."""
    with _slots_lock:
        ctrl = _slots.get(int(slot))
    if ctrl is not None:
        ctrl.record_grid(dev, even, regranted)


def poll_slot(slot, dev, k, done) -> np.ndarray:
    """The poll target: route a device poll to its slot's control
    block; unknown/released slots poll as zeros (dead control)."""
    done = np.asarray(done)
    with _slots_lock:
        ctrl = _slots.get(int(slot))
    if ctrl is None:
        return np.zeros((done.shape[0], CTRL_WORDS), dtype=np.uint32)
    hook = _poll_hook
    if hook is not None:
        # Chaos seam, OUTSIDE both locks (it may block — that is the
        # injected fault). The hook sees the device's PHYSICAL fan index.
        phys = int(dev)
        if ctrl.fan_map is not None and phys < len(ctrl.fan_map):
            phys = ctrl.fan_map[phys]
        hook(int(slot), phys, int(k))
    return ctrl.poll(int(dev), int(k), done)
