"""Resilience seams of the port: the injectable clock.

Counterpart of ``tpu_dpow/resilience/``. So far the port needs only the
clock (``resilience/clock.py``): the persistent run mode stamps control
polls and command deliveries on it, so FakeClock tests pin issue-to-delivery
latency without real sleeps. The breaker, failover chain, supervisor and
device fault domains come with later slices.
"""

from .clock import Clock, FakeClock, SystemClock  # noqa: F401
