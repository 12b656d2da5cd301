"""Resilience seams of the port.

Counterpart of ``tpu_dpow/resilience/``:

  supervisor — :class:`DispatchSupervisor`: per-dispatch deadlines,
               grace-window re-publish, hedged duplicate dispatch
               (server-side; wired in server/app.py);
  breaker    — :class:`CircuitBreaker`: closed/open/half-open with a
               probe, on an injectable clock;
  devfault   — :class:`DeviceFaultDomains`: per-device healthy/suspect/
               quarantined state for the engine fan, driven by the
               engine's watchdog;
  failover   — :class:`FailoverBackend`: torch → native → error engine
               chain behind per-engine breakers (client-side);
  clock      — :class:`SystemClock` / :class:`FakeClock`: the injectable
               time seam every timer of the port runs on (the persistent
               run mode stamps control polls on it, the hub's heartbeat
               beats on it), so tests pin latencies without real sleeps.

The store-side half lives next to the stores it wraps:
:class:`~tpu_dpow_torch.store.degraded.DegradedStore` (re-exported here)
falls back from a dead primary to in-memory, journals writes, and
reconciles on recovery.
"""

from ..store.degraded import DegradedStore  # noqa: F401
from .breaker import CLOSED, HALF_OPEN, OPEN, CircuitBreaker  # noqa: F401
from .clock import Clock, FakeClock, SystemClock  # noqa: F401
from .devfault import (  # noqa: F401
    DEADLINE_SLACK,
    HEALTHY,
    QUARANTINED,
    SUSPECT,
    DeviceFaultDomains,
    launch_deadline,
)
from .failover import FailoverBackend  # noqa: F401
from .supervisor import DispatchSupervisor  # noqa: F401
