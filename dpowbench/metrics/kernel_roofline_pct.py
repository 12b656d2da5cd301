"""kernel_roofline_pct: the search kernel's share of its roofline (%): the
least time the card's integer pipes need for the nonces the engine scanned
in the window, by the frozen lower bound of work per hash (``roofline.py``)
at the card's maximum SM clock, over the seconds in which the search kernel
ran in the device trace (the union of its launches: two pipelined launches
that overlap share the card)."""

from dpowbench import prom, roofline


def read(src):
    trace, clocks = src["trace"], src["clocks"]
    if trace is None or clocks is None:
        return None
    seconds = trace["kernel_busy_s"].get("b2_search_kernel", 0.0)
    before, after = src["worker"]
    hashes = prom.delta(before, after, "dpow_engine_hashes_total", {"engine": "torch"})
    return roofline.share_pct(hashes, seconds, src["kind"], clocks["max_sm_clock_mhz"])
