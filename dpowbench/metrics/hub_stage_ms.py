"""hub_stage_ms: mean of the hub's ``queue`` and ``publish`` stages over the
window (ms), from ``dpow_request_stage_seconds`` _sum/_count deltas on the
hub's /metrics."""

from dpowbench.readers import stage_ms


def read(src):
    return stage_ms(src["hub"], ("queue", "publish"))
