"""Collector pauses: ``dpow_process_gc_seconds{generation}``.

A ``gc.callbacks`` hook times every collection of the process (``start`` to
``stop`` on ``perf_counter``) into the histogram, and puts each full
(generation 2) collection, and any collection of a millisecond or more, on
the tracer's span ring, so a host stall seen in a device trace can be laid
beside the collections around it.

A collection can start in any thread, at any allocation, also inside a
section that holds the histogram's lock: the hook never waits on that
lock. It queues the pause, folds the queue into the histogram when the lock
is free at that moment, and leaves it for the next collection otherwise.
"""

from __future__ import annotations

import gc
import time
from collections import deque
from typing import Optional

from .registry import Registry, get_registry
from .trace import Tracer, get_tracer

# Pauses this long or longer go on the span ring whatever their generation.
SPAN_SECONDS = 1e-3

_installed: "Optional[GcWatch]" = None


class GcWatch:
    def __init__(self, registry: Optional[Registry] = None, tracer: Optional[Tracer] = None):
        self.histogram = (registry or get_registry()).histogram(
            "dpow_process_gc_seconds",
            "Pause of each garbage collection of this process, by generation",
            ("generation",),
        )
        self.tracer = tracer or get_tracer()
        self._t0 = 0.0
        self._pending: deque = deque()

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t0 = time.perf_counter()
            return
        t1 = time.perf_counter()
        generation = info["generation"]
        self._pending.append((t1 - self._t0, str(generation)))
        if generation == 2 or t1 - self._t0 >= SPAN_SECONDS:
            self.tracer.record("gc", self._t0, t1, cat="gc", thread="gc",
                               args={"generation": generation,
                                     "collected": info.get("collected", 0)})
        self.histogram.observe_pending(self._pending)


def install(registry: Optional[Registry] = None, tracer: Optional[Tracer] = None) -> GcWatch:
    """Hook this process's collections (once; later calls return the same
    hook)."""
    global _installed
    if _installed is None:
        _installed = GcWatch(registry, tracer)
        gc.callbacks.append(_installed)
    return _installed
