"""Device fault domains: per-device health for the engine.

The port's own copy of ``tpu_dpow/resilience/devfault.py``. The unit of
failure is the DEVICE (a fan member), not the whole backend:

  healthy ──missed progress deadline──▶ suspect ──evacuated──▶ quarantined
     ▲                                                            │
     └──────────────── successful single-probe launch ◀───────────┘

* ``DeviceFaultDomains`` is the state machine, one domain per physical
  device index, riding a per-device :class:`CircuitBreaker` for the
  open/half-open/probe timing (``probe_interval`` is the breaker's reset
  timeout, and exactly ONE probe launch is admitted per window). Health is
  exported as ``dpow_backend_device_health`` (0 healthy / 1 suspect / 2
  quarantined), transitions as ``dpow_backend_quarantine_total{transition}``
  and evacuations as ``dpow_backend_evacuations_total{reason}``.

* The OBSERVATION side lives in the engine (backend/torch_backend.py
  ``_watchdog_pass``): progress is read from the control channel's
  per-(row, device) poll/done bookkeeping (ops/control.py), deadlines from
  :func:`launch_deadline`, and every timer rides the injectable
  ``resilience.Clock``.

* Escalation order: a suspect device's uncovered range is evacuated onto
  the remaining healthy devices and the engine keeps serving at degraded
  fan width; only at ZERO healthy devices does the engine raise
  :class:`~tpu_dpow_torch.backend.DevicesExhausted`. It never carries on
  on another device type.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from .. import obs
from ..utils.logging import get_logger
from .breaker import CircuitBreaker
from .clock import Clock, SystemClock

logger = get_logger("tpu_dpow_torch.resilience")

HEALTHY = "healthy"
SUSPECT = "suspect"
QUARANTINED = "quarantined"

HEALTH_CODES = {HEALTHY: 0.0, SUSPECT: 1.0, QUARANTINED: 2.0}

#: slack multiplier on the expected poll cadence before a silent device is
#: declared suspect — generous, because the cost of a false positive is a
#: wasted evacuation + probe cycle, while a true positive is bounded by the
#: waiters' deadlines either way.
DEADLINE_SLACK = 4.0


def launch_deadline(
    expected_seconds: float, floor: float, slack: float = DEADLINE_SLACK
) -> float:
    """Progress deadline for one launch: the expected time between
    progress observations scaled by ``slack``, floored at
    ``device_suspect_after`` (``floor``) so a cold engine with no window
    timing history yet is never trigger-happy."""
    return max(floor, expected_seconds * slack)


class DeviceFaultDomains:
    """Health state machine over ``n`` physical device indices.

    Pure policy + bookkeeping: the owner (the engine watchdog) feeds it
    missed-deadline observations and probe outcomes; it answers which
    devices are in the fan and when a quarantined device has earned its
    single re-admission probe. Not thread-safe by design — every caller
    runs on the engine's event loop.
    """

    def __init__(
        self,
        n: int,
        *,
        suspect_after: float,
        probe_interval: float,
        clock: Optional[Clock] = None,
        name: str = "torch",
    ):
        self.n = max(1, n)
        self.suspect_after = suspect_after
        self.probe_interval = probe_interval
        self.clock = clock or SystemClock()
        self._state: Dict[int, str] = {d: HEALTHY for d in range(self.n)}
        # Per-device breaker: OPEN == quarantined, half-open == the single
        # re-admission probe is in flight. failure_threshold=1: the
        # watchdog only reports CONFIRMED missed deadlines.
        self._breakers: Dict[int, CircuitBreaker] = {
            d: CircuitBreaker(
                f"device:{name}:{d}",
                failure_threshold=1,
                reset_timeout=probe_interval,
                clock=self.clock,
            )
            for d in range(self.n)
        }
        reg = obs.get_registry()
        self._m_health = reg.gauge(
            "dpow_backend_device_health",
            "Per-device fault-domain state (0 healthy, 1 suspect, "
            "2 quarantined)", ("device",))
        self._m_quarantine = reg.counter(
            "dpow_backend_quarantine_total",
            "Device health state transitions, by edge", ("transition",))
        self._m_evacuations = reg.counter(
            "dpow_backend_evacuations_total",
            "Suspect-device range evacuations onto healthy devices, by "
            "cause", ("reason",))
        for d in range(self.n):
            self._m_health.set(0.0, str(d))

    # -- reads -----------------------------------------------------------

    def state(self, d: int) -> str:
        return self._state[d]

    def healthy_devices(self) -> List[int]:
        """Physical indices currently in the fan (ascending)."""
        return [d for d in range(self.n) if self._state[d] == HEALTHY]

    def exhausted(self) -> bool:
        return not any(s == HEALTHY for s in self._state.values())

    # -- transitions -----------------------------------------------------

    def _set(self, d: int, state: str) -> None:
        prev = self._state[d]
        if prev == state:
            return
        self._state[d] = state
        self._m_health.set(HEALTH_CODES[state], str(d))
        self._m_quarantine.inc(1, f"{prev}->{state}")
        logger.warning("device %d: %s -> %s", d, prev, state)

    def mark_suspect(self, d: int) -> bool:
        """A healthy device missed its progress deadline. Returns True on
        the healthy→suspect edge (the caller then evacuates exactly once);
        False when the device is already suspect/quarantined."""
        if self._state[d] != HEALTHY:
            return False
        self._set(d, SUSPECT)
        return True

    def quarantine(self, d: int) -> None:
        """Evacuation done: the device leaves the fan until a probe
        re-admits it. Trips the device's breaker so probe timing (one
        probe per ``probe_interval``, single slot) is the breaker's."""
        self._breakers[d].trip()
        self._set(d, QUARANTINED)

    def record_evacuation(self, reason: str) -> None:
        self._m_evacuations.inc(1, reason)

    # -- re-admission probes ---------------------------------------------

    def probe_due(self, d: int) -> bool:
        """True when quarantined device ``d`` has earned its single
        re-admission probe (breaker half-open admits exactly one)."""
        return self._state[d] == QUARANTINED and self._breakers[d].allow()

    def probe_result(self, d: int, ok: bool) -> None:
        """Fold a probe launch outcome: success re-admits the device to
        the fan (→ healthy); failure re-opens the full probe interval."""
        if ok:
            self._breakers[d].record_success()
            self._set(d, HEALTHY)
        else:
            self._breakers[d].record_failure()
