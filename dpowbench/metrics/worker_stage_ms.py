"""worker_stage_ms: mean of the worker's ``pack`` and ``result`` stages over
the window (ms), from ``dpow_request_stage_seconds`` _sum/_count deltas on
the worker's /metrics."""

from dpowbench.readers import stage_ms


def read(src):
    return stage_ms(src["worker"], ("pack", "result"))
