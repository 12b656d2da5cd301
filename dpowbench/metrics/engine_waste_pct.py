"""engine_waste_pct: nonces the engine scanned for jobs already answered
when their launch was applied (solved by an earlier launch, or cancelled),
over every nonce it scanned (%), in the window:
``dpow_engine_wasted_hashes_total`` (both causes) over
``dpow_engine_hashes_total`` deltas on the worker's /metrics, engine
``torch``. None where the worker does not count waste."""

from dpowbench import prom

WASTED = "dpow_engine_wasted_hashes_total"


def read(src):
    before, after = src["worker"]
    if WASTED not in after:
        return None
    torch_engine = {"engine": "torch"}
    hashes = prom.delta(before, after, "dpow_engine_hashes_total", torch_engine)
    if hashes <= 0:
        return None
    return 100.0 * prom.delta(before, after, WASTED, torch_engine) / hashes
