"""Observability of the port: metrics registry, resource ledger, tracing,
/metrics.

Counterpart of ``tpu_dpow/obs/`` (its own copy, sharing no state with it):

  registry  — process-local Counter / Gauge / Histogram with label sets and
              fixed log2 latency buckets, safe from launch threads;
  ledger    — the LeakLedger: acquire/discharge accounting of revocable
              resources (the persistent run mode's control slots);
  trace     — span API stamping one WorkRequest through the pipeline
              (dispatch → pack → device → result on the worker), the trace
              id riding the work/result payloads; the ring of host spans
              (engine launches, start-up phases, collections) and their
              Chrome-trace export on the Unix clock;
  gcwatch   — the collector's pauses (``dpow_process_gc_seconds``);
  prom      — Prometheus text-format v0.0.4 renderer + parser and the
              aiohttp GET /metrics and GET /spans routes (the worker's
              metrics port, the hub's upcheck port).

The exposition text is byte-identical to ``tpu_dpow``'s for the same
registry operations.

Entry points:
  obs.get_registry()  — the process-wide Registry
  obs.get_tracer()    — the process-wide Tracer
  obs.snapshot()      — machine-readable dump of every metric
  obs.render()        — the Prometheus text page as a string
  obs.reset()         — clear all series + traces (test isolation)
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
from .trace import (  # noqa: F401
    STAGES,
    STARTUP_PHASES,
    Tracer,
    get_tracer,
    is_trace_id,
    new_trace_id,
    process_start,
)
from . import gcwatch  # noqa: F401
from .prom import add_metrics_route, histogram_quantile, parse_text, render  # noqa: F401


def snapshot() -> dict:
    """Machine-readable dump of the default registry."""
    return get_registry().snapshot()


def reset() -> None:
    """Clear every metric series and all traces (test isolation)."""
    get_registry().reset()
    get_tracer().reset()
