"""persistent_regrant_pct: the share of the run kernel's windows whose span
dealt the grid over fewer rows than the launch holds (%), in the window:
the ``regranted`` delta of ``dpow_backend_persistent_grid_windows_total``
over the ``even`` + ``regranted`` deltas on the worker's /metrics. In such
a window the blocks of the launch's done rows scan for the rows still live.
Counted at apply, per persistent launch, from the kernel's out words. None
where the worker does not count grid windows or applied no persistent
launch in the window."""

from dpowbench import prom

GRID_WINDOWS = "dpow_backend_persistent_grid_windows_total"


def read(src):
    before, after = src["worker"]
    if GRID_WINDOWS not in after:
        return None
    regranted = prom.delta(before, after, GRID_WINDOWS, {"grid": "regranted"})
    total = regranted + prom.delta(before, after, GRID_WINDOWS, {"grid": "even"})
    if total <= 0:
        return None
    return 100.0 * regranted / total
