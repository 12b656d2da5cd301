"""Resilience seams of the port.

Counterpart of ``tpu_dpow/resilience/``: the injectable clock
(``clock.py``; the persistent run mode stamps control polls and command
deliveries on it, so FakeClock tests pin latencies without real sleeps),
the circuit breaker (``breaker.py``) and the device fault domains
(``devfault.py``: healthy → suspect → quarantined → probe, driven by the
engine's watchdog). The failover chain and the dispatch supervisor come
with the client/server slice.
"""

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
