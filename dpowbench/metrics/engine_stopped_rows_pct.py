"""engine_stopped_rows_pct: rows of chunked launches the engine stopped
mid-launch because their job was answered, over the live rows it packed
(%), in the window: ``dpow_engine_rows_stopped_total`` (both causes, engine
``torch``) over ``dpow_engine_batch_occupancy_sum`` deltas on the worker's
/metrics. None where the worker does not stop rows."""

from dpowbench import prom

STOPPED = "dpow_engine_rows_stopped_total"


def read(src):
    before, after = src["worker"]
    if STOPPED not in after:
        return None
    rows = prom.delta(before, after, "dpow_engine_batch_occupancy_sum")
    if rows <= 0:
        return None
    return 100.0 * prom.delta(before, after, STOPPED, {"engine": "torch"}) / rows
