"""Reduction of the worker's device trace (``torch.profiler``'s Chrome trace)
to what the readers and the result's ``breakdown`` take.

The window is the span between the two ``spin_kernel`` marks the launcher
puts on a stream of its own at the window's ends. Every other kernel, copy
and memset is a device operation; each is clipped to the window.
"""

from __future__ import annotations

import json
import re
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MARK = "spin_kernel"


def short_name(name: str, cat: str) -> str:
    """``(anonymous namespace)::b2_search_kernel(unsigned int const*, ...)``
    -> ``b2_search_kernel``; copies and memsets keep their names."""
    if cat != "kernel":
        return name
    n = name.replace("(anonymous namespace)::", "")
    if n.startswith("void "):
        n = n[5:]
    while True:
        m = re.sub(r"<[^<>]*>", "", n)
        if m == n:
            break
        n = m
    n = n.split("(", 1)[0]
    return n.rsplit("::", 1)[-1] or name


def union_seconds(intervals: List[Tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals, in seconds (µs in)."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total * 1e-6


def reduce(path: str, top: int = 10) -> Optional[dict]:
    """Window length, busy seconds, device time by operation, each kernel's
    own busy seconds and the longest idle gaps; None when the trace holds no
    pair of marks."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    marks = sorted(e["ts"] + e.get("dur", 0.0) for e in events
                   if e.get("cat") == "kernel" and MARK in e.get("name", ""))
    if len(marks) < 2:
        return None
    marks_start = sorted(e["ts"] for e in events
                         if e.get("cat") == "kernel" and MARK in e.get("name", ""))
    lo, hi = marks[0], marks_start[-1]
    launches = {}
    for e in events:
        if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = e["ts"]
    ops = []
    for e in events:
        cat = e.get("cat")
        if cat not in DEVICE_CATS or MARK in e.get("name", ""):
            continue
        a, b = max(e["ts"], lo), min(e["ts"] + e.get("dur", 0.0), hi)
        if b <= a:
            continue
        ops.append((a, b, short_name(e.get("name", ""), cat),
                    launches.get(e.get("args", {}).get("correlation"))))
    ops.sort()
    by_op: Dict[str, float] = {}
    by_kernel: Dict[str, List[Tuple[float, float]]] = {}
    for a, b, name, _issued in ops:
        by_op[name] = by_op.get(name, 0.0) + (b - a) * 1e-6
        by_kernel.setdefault(name, []).append((a, b))
    gaps = []
    end, prev = lo, "window start"
    for a, b, name, issued in ops:
        if a > end:
            host = ("issued inside the gap" if issued is not None and issued > end
                    else "issued before the gap")
            gaps.append((f"{prev} -> {name} ({host})", (a - end) * 1e-6))
        if b > end:
            end, prev = b, name
    if hi > end:
        gaps.append((f"{prev} -> window end", (hi - end) * 1e-6))
    gaps.sort(key=lambda g: -g[1])
    return {
        "window_s": (hi - lo) * 1e-6,
        "busy_s": union_seconds([(a, b) for a, b, _n, _i in ops]),
        "ops": sorted(([n, s] for n, s in by_op.items()), key=lambda x: -x[1]),
        "kernel_busy_s": {n: union_seconds(iv) for n, iv in by_kernel.items()},
        "gaps": [[n, s] for n, s in gaps[:top]],
    }
