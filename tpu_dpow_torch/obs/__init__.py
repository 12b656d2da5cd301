"""Observability of the port: metrics registry and resource ledger.

Counterpart of ``tpu_dpow/obs/`` (its own copy, sharing no state with it):

  registry  — process-local Counter / Gauge / Histogram with label sets and
              fixed log2 latency buckets, safe from launch threads;
  ledger    — the LeakLedger: acquire/discharge accounting of revocable
              resources (the persistent run mode's control slots).

The span tracer and the Prometheus renderer come with a later slice.

Entry points:
  obs.get_registry()  — the process-wide Registry
  obs.snapshot()      — machine-readable dump of every metric
  obs.reset()         — clear all series (test isolation)
"""

from .registry import (  # noqa: F401
    LOG2_BUCKETS,
    MAX_SERIES,
    Counter,
    Gauge,
    Histogram,
    MetricError,
    Registry,
    get_registry,
)
from .ledger import LEDGER, LeakLedger, get_ledger  # noqa: F401


def snapshot() -> dict:
    """Machine-readable dump of the default registry."""
    return get_registry().snapshot()


def reset() -> None:
    """Clear every metric series (test isolation)."""
    get_registry().reset()
