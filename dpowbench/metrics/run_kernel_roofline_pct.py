"""run_kernel_roofline_pct: the persistent run kernel's share of its
roofline (%): the least time the card's integer pipes need for the nonces
the engine scanned in the window, by the frozen lower bound of work per hash
(``roofline.py``, which holds for any kernel computing the hash) at the
card's maximum SM clock, over the seconds in which ``b2_run_kernel`` ran in
the device trace.

Edges: the nonces are counted per launch when it is applied, the kernel's
seconds clipped to the window's marks. A launch that straddles the opening
mark counts all its nonces against the part of its time inside the window,
and one that straddles the closing mark counts its time inside the window
(where it ended before the profiler stopped) without its nonces; each edge
moves the reading by at most one launch of at most ``persistent_steps``
windows. None without a trace, or where no run kernel ran in it."""

from dpowbench import prom, roofline


def read(src):
    trace, clocks = src["trace"], src["clocks"]
    if trace is None or clocks is None:
        return None
    seconds = trace["kernel_busy_s"].get("b2_run_kernel", 0.0)
    before, after = src["worker"]
    hashes = prom.delta(before, after, "dpow_engine_hashes_total", {"engine": "torch"})
    return roofline.share_pct(hashes, seconds, src["kind"], clocks["max_sm_clock_mhz"])
