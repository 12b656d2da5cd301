"""FaultyDevice: per-device fault injection for the engine fan.

The port's own copy of ``tpu_dpow/chaos/device.py``. A device's failure
modes — a kernel that stops polling, a wedged launch thread, a lost card —
all present the same way: one device stops making progress while its
siblings keep going. This seam reproduces that at the two boundaries where
a device touches the host (ops/control.py):

  * the CONTROL-POLL boundary: every persistent launch polls its control
    slot per fan member, each member from its own thread (on the card, the
    thread that serves the member kernel's mailbox); ``hang_at_poll(dev,
    window)`` blocks device ``dev``'s poll at its first poll at or past
    ``window``. On the card the member's kernel then spins on its
    unanswered poll and the fanned launch never returns, while the other
    members' polls keep flowing;
  * the LAUNCH-THREAD boundary: ``hang_launch(dev)`` blocks any launch
    whose device set includes ``dev`` before it dispatches — this is what
    keeps a quarantined device's re-admission PROBE failing until the
    fault is lifted.

``dead_after(dev, windows)`` is hang-at-poll with no scheduled release: a
device that dies K windows in. ``slow_poll(dev, delay)`` stalls each poll
by a real-time ``delay`` (bounded; it models a straggler, not a corpse).

Hooks run on DEVICE threads (launch and member threads), outside every
host lock, so a hanging hook can never deadlock the host writers — and
they block on ``threading.Event``, which :meth:`release` or
:meth:`uninstall` sets. ``uninstall`` ALWAYS releases every hang: a
still-blocked thread would otherwise hang interpreter shutdown. Injections
are recorded in ``events`` and counted in
``dpow_chaos_injected_total{op,action}``.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

from .. import obs
from ..ops import control as ctl

HANG = "hang"
SLOW = "slow"


class _DeviceRule:
    def __init__(self, action: str, at_window: int = 0, delay: float = 0.0):
        self.action = action
        self.at_window = at_window
        self.delay = delay
        self.event = threading.Event()  # set = fault lifted
        # True once a poll actually blocked: the device is WEDGED. Only
        # then do NEW launches touching it hang at the launch boundary
        # (a re-admission probe on a wedged card hangs with it) — before
        # that, launches must proceed so the device can reach the poll
        # the rule targets. at_window == 0 means dead-from-the-start:
        # launches hang immediately.
        self.engaged = False


class FaultyDevice:
    """Install with ``with FaultyDevice(...) as fd:`` (or install() /
    uninstall()); target PHYSICAL fan device indices."""

    def __init__(self, *, max_hang: float = 120.0):
        # Safety net: no injected hang outlives ``max_hang`` real seconds,
        # so a test that forgets release() strands a thread for a bounded
        # time instead of forever.
        self.max_hang = max_hang
        self._rules: Dict[int, _DeviceRule] = {}
        self._lock = threading.Lock()
        self.events: List[tuple] = []  # (boundary, device, detail)
        self._m_injected = obs.get_registry().counter(
            "dpow_chaos_injected_total",
            "Chaos faults injected, by op and action", ("op", "action"))

    # -- scripting --------------------------------------------------------

    def hang_at_poll(self, dev: int, window: int = 0) -> None:
        """Block device ``dev``'s control poll at the first poll with
        window index >= ``window`` (and its launches, so probes hang too)
        until release()/uninstall()."""
        with self._lock:
            self._rules[dev] = _DeviceRule(HANG, at_window=window)

    def dead_after(self, dev: int, windows: int) -> None:
        """The device dies ``windows`` windows in: hang with no release
        scheduled (uninstall still lifts it — dead for the scenario)."""
        self.hang_at_poll(dev, windows)

    def hang_launch(self, dev: int) -> None:
        """Block every launch touching device ``dev`` at the launch
        boundary, from the start, until release()/uninstall()."""
        self.hang_at_poll(dev, 0)

    def slow_poll(self, dev: int, delay: float) -> None:
        """Stall each of ``dev``'s polls by ``delay`` real seconds — a
        straggler, not a corpse (bounded, never needs release)."""
        with self._lock:
            self._rules[dev] = _DeviceRule(SLOW, delay=delay)

    def release(self, dev: int) -> None:
        """Lift device ``dev``'s fault — the zombie wake-up: a blocked
        poll/launch thread resumes against whatever fences the engine has
        since raised."""
        with self._lock:
            rule = self._rules.pop(dev, None)
        if rule is not None:
            rule.event.set()

    # -- hook plumbing ----------------------------------------------------

    def install(self) -> "FaultyDevice":
        ctl.set_poll_hook(self._on_poll)
        ctl.set_launch_hook(self._on_launch)
        return self

    def uninstall(self) -> None:
        ctl.set_poll_hook(None)
        ctl.set_launch_hook(None)
        with self._lock:
            rules, self._rules = list(self._rules.values()), {}
        for rule in rules:  # never strand a blocked device thread
            rule.event.set()

    def __enter__(self) -> "FaultyDevice":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()

    # -- device-thread side (may block: that IS the fault) ----------------

    def _rule_for(self, dev: int) -> Optional[_DeviceRule]:
        with self._lock:
            return self._rules.get(dev)

    def _on_poll(self, slot: int, dev: int, k: int) -> None:
        rule = self._rule_for(dev)
        if rule is None:
            return
        if rule.action == HANG and k >= rule.at_window:
            self.events.append(("poll", dev, k))
            self._m_injected.inc(1, "device_poll", HANG)
            rule.engaged = True
            rule.event.wait(self.max_hang)
        elif rule.action == SLOW:
            self.events.append(("poll", dev, k))
            self._m_injected.inc(1, "device_poll", SLOW)
            rule.event.wait(rule.delay)  # bounded stall, or early release

    def _on_launch(self, devices: tuple) -> None:
        for dev in devices:
            rule = self._rule_for(dev)
            if rule is not None and rule.action == HANG and (
                rule.engaged or rule.at_window == 0
            ):
                self.events.append(("launch", dev, -1))
                self._m_injected.inc(1, "device_launch", HANG)
                rule.event.wait(self.max_hang)
