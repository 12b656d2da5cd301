"""persistent_live_rows_pct: the share of persistent launches' row-windows in
which the row was still live (%), in the window: the ``live`` delta of
``dpow_backend_persistent_row_windows_total`` over the ``live`` + ``done``
deltas on the worker's /metrics. A row is live until the control poll at
which the card reported it done, and done from then until its launch
returned with its slowest row; the rows share the grid evenly, so this is
the share of the run kernel's grid that scanned for a live row. Counted at
apply, per launch. None where the worker does not count row-windows or
applied no persistent launch in the window."""

from dpowbench import prom

ROW_WINDOWS = "dpow_backend_persistent_row_windows_total"


def read(src):
    before, after = src["worker"]
    if ROW_WINDOWS not in after:
        return None
    live = prom.delta(before, after, ROW_WINDOWS, {"state": "live"})
    total = live + prom.delta(before, after, ROW_WINDOWS, {"state": "done"})
    if total <= 0:
        return None
    return 100.0 * live / total
