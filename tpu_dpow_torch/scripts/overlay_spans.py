"""Lay a process's host spans (``GET /spans``) over its ``torch.profiler`` trace.

``python -m tpu_dpow_torch.scripts.overlay_spans --spans worker_spans.json
--trace worker_trace.json [--spans hub_spans.json] [--kernel NAME]
[--slack_ms 1] [--top 3] [--out merged.json]``

The spans page is on the Unix clock (obs/trace.py). A profiler trace's
events are shifted by its top-level ``baseTimeNanoseconds`` onto the same
clock. The window is the span between the first and the last
``spin_kernel`` mark where the trace has them, else the whole trace. The
script prints one JSON object:

  ``kernels``  how many of the window's intervals of ``--kernel`` lie inside
               the [thread start, done] span of a launch, within
               ``--slack_ms``, and the constant shifts of the device clock
               that keep every covered interval inside its launch (the
               clocks agree where the range holds 0); then the same on the
               host side: how many of those kernels' launch calls (the
               trace's ``cuda_runtime`` events, matched by correlation id)
               lie inside a launch span, and how many kernels start on the
               device before their own call, where the profiler's device
               clock runs ahead of its host clock;
  ``gaps``     the window's ``--top`` longest idle gaps of the card, each
               with the host spans under it: every launch with the part of
               it the gap falls in (queued for a launch thread, on its
               thread, done and not yet applied), start-up phases,
               collections, and the request stages marked inside it.

With ``--out`` it also writes the profiler's events and every spans page as
one Chrome trace.
"""

from __future__ import annotations

import argparse
import bisect
import json
import re
import sys
from typing import Dict, List, Optional, Tuple

MARK = "spin_kernel"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def short_name(name: str) -> str:
    """A kernel's name without namespaces, templates and arguments."""
    n = name.replace("(anonymous namespace)::", "")
    if n.startswith("void "):
        n = n[5:]
    while True:
        m = re.sub(r"<[^<>]*>", "", n)
        if m == n:
            break
        n = m
    return n.split("(", 1)[0].rsplit("::", 1)[-1] or name


def shift_us(trace: dict) -> float:
    """µs to add to a profiler trace's ``ts`` to put it on the Unix clock."""
    return float(trace.get("baseTimeNanoseconds", 0)) / 1e3


def device_ops(trace: dict) -> Tuple[List[tuple], Optional[Tuple[float, float]]]:
    """[(start, end, name)] of the trace's kernels, copies and memsets on
    the Unix clock (µs), marks left out, and the window between the marks
    (None without two)."""
    off = shift_us(trace)
    ops, marks = [], []
    for e in trace.get("traceEvents", []):
        if e.get("cat") not in DEVICE_CATS or "ts" not in e:
            continue
        a = e["ts"] + off
        b = a + e.get("dur", 0.0)
        if MARK in e.get("name", ""):
            marks.append((a, b))
            continue
        name = short_name(e.get("name", "")) if e["cat"] == "kernel" else e.get("name", "")
        ops.append((a, b, name))
    ops.sort()
    window = None
    if len(marks) >= 2:
        marks.sort()
        window = (marks[0][1], marks[-1][0])
    return ops, window


def launches(page: dict) -> List[dict]:
    """The page's launch spans, [t_thread, t_done] in µs, sorted by start."""
    out = []
    for e in page.get("traceEvents", []):
        if e.get("name") == "launch" and e.get("ph") == "X":
            out.append({"t0": e["ts"], "t1": e["ts"] + e.get("dur", 0.0),
                        "args": e.get("args", {})})
    out.sort(key=lambda x: x["t0"])
    return out


def coverage(ops: List[tuple], window: Tuple[float, float], spans: List[dict],
             kernel: str, slack_us: float) -> dict:
    """Intervals of ``kernel`` in ``window`` inside a launch span (within
    ``slack_us``), and the device-clock shifts every covered one allows."""
    starts = [s["t0"] for s in spans]
    longest = max((s["t1"] - s["t0"] for s in spans), default=0.0)
    lo, hi = window
    n = covered = 0
    shift_lo, shift_hi = -float("inf"), float("inf")
    leads, tails = [], []
    for a, b, name in ops:
        if name != kernel or b <= lo or a >= hi:
            continue
        n += 1
        best, margin = None, -float("inf")
        i = bisect.bisect_right(starts, a + slack_us) - 1
        while i >= 0 and starts[i] >= a - longest - slack_us:
            s = spans[i]
            m = min(a - s["t0"], s["t1"] - b)
            if m > margin:
                best, margin = s, m
            i -= 1
        if best is None or margin < -slack_us:
            continue
        covered += 1
        shift_lo = max(shift_lo, best["t0"] - a)
        shift_hi = min(shift_hi, best["t1"] - b)
        leads.append(a - best["t0"])
        tails.append(best["t1"] - b)
    leads.sort()
    tails.sort()
    return {
        "kernel": kernel, "intervals": n, "covered": covered,
        "share": covered / n if n else None, "slack_us": slack_us,
        "shift_us": [shift_lo, shift_hi] if covered else None,
        "lead_us_median": leads[len(leads) // 2] if leads else None,
        "tail_us_median": tails[len(tails) // 2] if tails else None,
    }


def _inside(starts: List[float], spans: List[dict], longest: float, x: float) -> bool:
    """Whether instant ``x`` (µs) lies inside a span sorted by start."""
    i = bisect.bisect_right(starts, x) - 1
    while i >= 0 and starts[i] >= x - longest:
        if spans[i]["t1"] >= x:
            return True
        i -= 1
    return False


def launch_calls(trace: dict, window: Tuple[float, float], spans: List[dict],
                 kernel: str) -> dict:
    """The window's ``kernel`` launches on the profiler's own host clock:
    their calls inside a launch span, and kernels that start before their
    own call (the profiler's device clock ahead of its host clock)."""
    off = shift_us(trace)
    events = trace.get("traceEvents", [])
    calls = {e["args"]["correlation"]: e["ts"] + off for e in events
             if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}
    starts = [s["t0"] for s in spans]
    longest = max((s["t1"] - s["t0"] for s in spans), default=0.0)
    lo, hi = window
    n = inside = early = 0
    ahead = 0.0
    for e in events:
        if e.get("cat") != "kernel" or short_name(e.get("name", "")) != kernel:
            continue
        a = e["ts"] + off
        call = calls.get(e.get("args", {}).get("correlation"))
        if call is None or a + e.get("dur", 0.0) <= lo or a >= hi:
            continue
        n += 1
        inside += _inside(starts, spans, longest, call)
        if a < call:
            early += 1
            ahead = max(ahead, call - a)
    return {"calls": n, "calls_inside": inside, "before_call": early,
            "before_call_ms_max": ahead / 1e3}


def idle_gaps(ops: List[tuple], window: Tuple[float, float], top: int) -> List[tuple]:
    """The ``top`` longest stretches of ``window`` with no device op, as
    (start, end, op before, op after), longest first."""
    lo, hi = window
    gaps, end, prev = [], lo, "window start"
    for a, b, name in ops:
        if b <= lo or a >= hi:
            continue
        if a > end:
            gaps.append((end, a, prev, name))
        if b > end:
            end, prev = b, name
    if hi > end:
        gaps.append((end, hi, prev, "window end"))
    gaps.sort(key=lambda g: g[0] - g[1])
    return gaps[:top]


def _launch_parts(args: dict, a: float, b: float) -> List[str]:
    """The parts of a launch (its span's ``args``) that [a, b] (µs)
    overlaps."""
    parts = []
    for label, k0, k1 in (("queued for a launch thread", "t_dispatch_us", "t_thread_us"),
                          ("on its launch thread", "t_thread_us", "t_done_us"),
                          ("done, not yet applied", "t_done_us", "t_apply_us")):
        t0, t1 = args.get(k0), args.get(k1)
        if t0 is not None and t1 is not None and t0 < b and t1 > a:
            parts.append(label)
    return parts


def host_under(a: float, b: float, pages: List[dict]) -> List[dict]:
    """Every host span of ``pages`` that overlaps [a, b] (µs)."""
    out = []
    for page in pages:
        process = page.get("otherData", {}).get("process", "")
        stages: Dict[str, int] = {}
        for e in page.get("traceEvents", []):
            ph = e.get("ph")
            if ph == "i" and a <= e["ts"] <= b:
                stages[e["name"]] = stages.get(e["name"], 0) + 1
            if ph != "X":
                continue
            args = e.get("args", {})
            t0 = args.get("t_dispatch_us", e["ts"])
            t1 = args.get("t_apply_us", e["ts"] + e.get("dur", 0.0))
            if t0 >= b or t1 <= a:
                continue
            item = {"process": process, "name": e["name"], "cat": e.get("cat"),
                    "ts_us": e["ts"], "dur_ms": e.get("dur", 0.0) / 1e3}
            if e["name"] == "launch":
                item["parts"] = _launch_parts(args, a, b)
                item["batch"], item["steps"] = args.get("batch"), args.get("steps")
            elif "generation" in args:
                item["generation"] = args["generation"]
            out.append(item)
        if stages:
            out.append({"process": process, "request_marks": stages})
    return out


def merged(trace: dict, pages: List[dict]) -> dict:
    """The profiler's events on the Unix clock and every spans page, as one
    Chrome trace."""
    off = shift_us(trace)
    events = []
    for e in trace.get("traceEvents", []):
        if "ts" in e:
            e = dict(e, ts=e["ts"] + off)
        events.append(e)
    for page in pages:
        events.extend(page.get("traceEvents", []))
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def overlay(trace: dict, pages: List[dict], kernel: str = "b2_search_kernel",
            slack_ms: float = 1.0, top: int = 3) -> dict:
    ops, window = device_ops(trace)
    if window is None:
        if not ops:
            return {"error": "the trace holds no device operation"}
        window = (ops[0][0], max(b for _a, b, _n in ops))
    spans = [s for page in pages for s in launches(page)]
    gaps = []
    for a, b, before, after in idle_gaps(ops, window, top):
        gaps.append({"start_us": a, "ms": (b - a) / 1e3, "between": [before, after],
                     "host": host_under(a, b, pages)})
    kernels = coverage(ops, window, spans, kernel, slack_ms * 1e3)
    kernels.update(launch_calls(trace, window, spans, kernel))
    return {"window_us": list(window), "window_s": (window[1] - window[0]) / 1e6,
            "base_time_ns": trace.get("baseTimeNanoseconds"), "launches": len(spans),
            "kernels": kernels, "gaps": gaps}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m tpu_dpow_torch.scripts.overlay_spans")
    p.add_argument("--spans", action="append", required=True,
                   help="a GET /spans page saved to a file (repeatable)")
    p.add_argument("--trace", required=True, help="torch.profiler's Chrome trace")
    p.add_argument("--kernel", default="b2_search_kernel")
    p.add_argument("--slack_ms", type=float, default=1.0)
    p.add_argument("--top", type=int, default=3)
    p.add_argument("--out", default="", help="write the merged Chrome trace here")
    args = p.parse_args(argv)
    with open(args.trace) as f:
        trace = json.load(f)
    pages = []
    for path in args.spans:
        with open(path) as f:
            pages.append(json.load(f))
    print(json.dumps(overlay(trace, pages, args.kernel, args.slack_ms, args.top)))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(merged(trace, pages), f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
