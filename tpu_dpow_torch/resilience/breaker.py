"""Circuit breaker: stop hammering a dependency that keeps failing.

The port's own copy of ``tpu_dpow/resilience/breaker.py``. Classic
three-state machine (closed → open → half-open → closed); the device fault
domains (resilience/devfault.py) run one per device. The states are exported as a gauge so an
operator can see a tripped engine on /metrics rather than inferring it
from an error-rate dip:

  dpow_breaker_state{name}              0 closed / 1 open / 2 half-open
  dpow_breaker_transitions_total{name,to}
  dpow_breaker_failures_total{name}
"""

from __future__ import annotations

from typing import Optional

from .. import obs
from ..utils.logging import get_logger
from .clock import Clock, SystemClock

logger = get_logger("tpu_dpow_torch.resilience")

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

STATE_CODES = {CLOSED: 0.0, OPEN: 1.0, HALF_OPEN: 2.0}


class CircuitBreaker:
    """Trip after ``failure_threshold`` CONSECUTIVE failures; after
    ``reset_timeout`` let exactly one probe through (half-open): its success
    closes the breaker, its failure re-opens the full timeout."""

    def __init__(
        self,
        name: str,
        *,
        failure_threshold: int = 3,
        reset_timeout: float = 30.0,
        clock: Optional[Clock] = None,
    ):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self.name = name
        self.failure_threshold = failure_threshold
        self.reset_timeout = reset_timeout
        self.clock = clock or SystemClock()
        self.state = CLOSED
        self.failures = 0  # consecutive failures since the last success
        self._opened_at = 0.0
        self._probe_inflight = False
        reg = obs.get_registry()
        self._m_state = reg.gauge(
            "dpow_breaker_state",
            "Circuit breaker state (0 closed, 1 open, 2 half-open)", ("name",))
        self._m_transitions = reg.counter(
            "dpow_breaker_transitions_total",
            "Breaker state transitions, by destination state", ("name", "to"))
        self._m_failures = reg.counter(
            "dpow_breaker_failures_total",
            "Failures recorded against the protected dependency", ("name",))
        self._m_state.set(STATE_CODES[self.state], self.name)

    def _transition(self, state: str) -> None:
        if state == self.state:
            return
        logger.warning("breaker %s: %s -> %s", self.name, self.state, state)
        self.state = state
        self._m_state.set(STATE_CODES[state], self.name)
        self._m_transitions.inc(1, self.name, state)

    def allow(self) -> bool:
        """May a call go through right now? Half-open admits one probe."""
        if self.state == CLOSED:
            return True
        if self.state == OPEN:
            if self.clock.time() - self._opened_at >= self.reset_timeout:
                self._transition(HALF_OPEN)
                self._probe_inflight = True
                return True
            return False
        if not self._probe_inflight:
            self._probe_inflight = True
            return True
        return False

    def release_probe(self) -> None:
        """The call that held the half-open probe slot ended NEUTRALLY
        (e.g. a work cancel — not the dependency's fault, not proof of
        health): free the slot so the next call can probe. Without this a
        cancelled probe would wedge the breaker half-open forever."""
        self._probe_inflight = False

    def record_success(self) -> None:
        self.failures = 0
        self._probe_inflight = False
        self._transition(CLOSED)

    def trip(self) -> None:
        """Force the breaker OPEN now, regardless of the failure count —
        the dependency itself declared it cannot serve (e.g. an engine's
        zero-healthy-devices signal, backend.DevicesExhausted). The normal
        reset_timeout → half-open → probe path re-admits it."""
        self._m_failures.inc(1, self.name)
        self.failures = self.failure_threshold
        self._probe_inflight = False
        self._opened_at = self.clock.time()
        self._transition(OPEN)

    def record_failure(self) -> None:
        self._m_failures.inc(1, self.name)
        self._probe_inflight = False
        if self.state == HALF_OPEN:
            # The probe failed: back to fully open, restart the timer.
            self._opened_at = self.clock.time()
            self._transition(OPEN)
            return
        self.failures += 1
        if self.state == CLOSED and self.failures >= self.failure_threshold:
            self._opened_at = self.clock.time()
            self._transition(OPEN)
