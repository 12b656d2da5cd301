"""engine_occupancy_pct: live jobs packed per launch over the engine's
``max_batch`` (%), the mean of ``dpow_engine_batch_occupancy`` in the
window."""

from dpowbench import prom


def read(src):
    before, after = src["worker"]
    mean = prom.mean_delta(before, after, "dpow_engine_batch_occupancy")
    if mean is None:
        return None
    return 100.0 * mean / src["max_batch"]
