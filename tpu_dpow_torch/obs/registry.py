"""Process-local metrics registry: Counter / Gauge / Histogram with labels.

The port's own copy of ``tpu_dpow/obs/registry.py``, with the same family
names, kinds, labels and buckets, so a dashboard reads either engine.
Dependency-free primitives every layer writes into, consumed
machine-readably via obs.snapshot().

Design constraints:
  * callable from ANY thread — the engine's launch threads update counters
    off the event loop, so every mutation takes the family's lock (a plain
    threading.Lock; the critical sections are a few dict ops, never
    awaits);
  * bounded label cardinality — a typo'd or attacker-controlled label value
    (e.g. a block hash) must not grow a family without bound: past
    MAX_SERIES per family, new label sets are folded into an "...overflow"
    series instead of being created (the total stays correct, the
    cardinality stays bounded, and the overflow series itself is the alarm);
  * fixed log2 latency buckets — one bucket ladder shared by every
    histogram (2^-13 s ~ 0.12 ms ... 2^5 s = 32 s), so any two stage
    histograms are comparable bucket-for-bucket and the renderer never
    emits mismatched `le` grids.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable, Optional, Tuple

# One family keeps at most this many distinct label sets (the overflow
# series included). Generous for the static label sets this codebase emits
# (work types, stages, outcomes) and small enough that an unbounded-value
# mistake cannot eat memory.
MAX_SERIES = 64
OVERFLOW_LABEL = "...overflow"

# Fixed log2 ladder in seconds: 2^-13 (~0.12 ms) through 2^5 (32 s) — the
# span from a sub-ms precache hit to the server's max request timeout.
LOG2_BUCKETS: Tuple[float, ...] = tuple(2.0**e for e in range(-13, 6))


class MetricError(Exception):
    pass


def _check_labels(labelnames: Tuple[str, ...], labels: Tuple[str, ...]) -> None:
    if len(labels) != len(labelnames):
        raise MetricError(
            f"expected {len(labelnames)} label value(s) {labelnames}, "
            f"got {len(labels)}"
        )


class _Family:
    """Shared base: a named family of series, one per label-value tuple."""

    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: Iterable[str] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._series: Dict[Tuple[str, ...], object] = {}

    def _key(self, labels: Tuple[str, ...]) -> Tuple[str, ...]:
        """The series key for these label values, folding new series into
        the overflow key once the family is at capacity."""
        _check_labels(self.labelnames, labels)
        if labels in self._series or len(self._series) < MAX_SERIES - 1:
            return labels
        overflow = (OVERFLOW_LABEL,) * len(self.labelnames)
        return overflow if labels != overflow else labels

    def clear(self) -> None:
        with self._lock:
            self._series.clear()


class Counter(_Family):
    """Monotonically increasing count (f64)."""

    kind = "counter"

    def inc(self, amount: float = 1.0, *labels: str) -> None:
        if amount < 0:
            raise MetricError(f"counter {self.name} cannot decrease")
        with self._lock:
            key = self._key(tuple(labels))
            self._series[key] = self._series.get(key, 0.0) + amount

    def value(self, *labels: str) -> float:
        with self._lock:
            return float(self._series.get(tuple(labels), 0.0))

    def collect(self) -> Dict[Tuple[str, ...], float]:
        with self._lock:
            return dict(self._series)


class Gauge(_Family):
    """A value that can go anywhere (queue depth, sessions, H/s)."""

    kind = "gauge"

    def set(self, value: float, *labels: str) -> None:
        with self._lock:
            self._series[self._key(tuple(labels))] = float(value)

    def inc(self, amount: float = 1.0, *labels: str) -> None:
        with self._lock:
            key = self._key(tuple(labels))
            self._series[key] = self._series.get(key, 0.0) + amount

    def dec(self, amount: float = 1.0, *labels: str) -> None:
        self.inc(-amount, *labels)

    def value(self, *labels: str) -> float:
        with self._lock:
            return float(self._series.get(tuple(labels), 0.0))

    def collect(self) -> Dict[Tuple[str, ...], float]:
        with self._lock:
            return dict(self._series)


class _HistogramSeries:
    __slots__ = ("counts", "total", "count")

    def __init__(self, nbuckets: int):
        self.counts = [0] * nbuckets  # per-bucket (non-cumulative) counts
        self.total = 0.0
        self.count = 0


class Histogram(_Family):
    """Fixed-bucket latency histogram (log2 ladder + +Inf)."""

    kind = "histogram"

    def __init__(
        self,
        name: str,
        help: str,
        labelnames: Iterable[str] = (),
        buckets: Optional[Iterable[float]] = None,
    ):
        super().__init__(name, help, labelnames)
        self.buckets = tuple(buckets) if buckets is not None else LOG2_BUCKETS
        if list(self.buckets) != sorted(self.buckets):
            raise MetricError(f"histogram {name} buckets must ascend")

    def observe(self, value: float, *labels: str) -> None:
        with self._lock:
            self._observe_locked(value, tuple(labels))

    def observe_pending(self, pending) -> None:
        """Observe every ``(value, label...)`` tuple queued in the deque
        ``pending`` if the lock is free now; else leave them queued. For
        callers that must never wait on the lock (obs/gcwatch.py)."""
        if not self._lock.acquire(blocking=False):
            return
        try:
            while pending:
                value, *labels = pending.popleft()
                self._observe_locked(value, tuple(labels))
        finally:
            self._lock.release()

    def _observe_locked(self, value: float, labels: Tuple[str, ...]) -> None:
        key = self._key(labels)
        series = self._series.get(key)
        if series is None:
            series = self._series[key] = _HistogramSeries(len(self.buckets) + 1)
        i = len(self.buckets)  # +Inf slot
        for j, edge in enumerate(self.buckets):
            if value <= edge:
                i = j
                break
        series.counts[i] += 1
        series.total += value
        series.count += 1

    def collect(self) -> Dict[Tuple[str, ...], dict]:
        """Per-series {"buckets": [(le, cumulative), ...], "sum", "count"}."""
        out = {}
        with self._lock:
            for key, s in self._series.items():
                cum, rows = 0, []
                for edge, c in zip(self.buckets, s.counts):
                    cum += c
                    rows.append((edge, cum))
                rows.append((float("inf"), cum + s.counts[-1]))
                out[key] = {"buckets": rows, "sum": s.total, "count": s.count}
        return out

    def count_of(self, *labels: str) -> int:
        with self._lock:
            s = self._series.get(tuple(labels))
            return s.count if s is not None else 0


class Registry:
    """Named collection of metric families; get-or-create semantics.

    Re-requesting an existing name returns the SAME family (so e.g. two
    DpowServer instances in one process share one counter) — but only if
    kind and label names agree; a mismatch is a programming error surfaced
    immediately rather than silently split metrics.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._families: Dict[str, _Family] = {}

    def _get_or_create(self, cls, name, help, labelnames, **kw) -> _Family:
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if not isinstance(fam, cls) or fam.labelnames != tuple(labelnames):
                    raise MetricError(
                        f"metric {name} re-registered as {cls.kind} "
                        f"{tuple(labelnames)} but exists as {fam.kind} "
                        f"{fam.labelnames}"
                    )
                if "buckets" in kw:
                    want = (
                        tuple(kw["buckets"])
                        if kw["buckets"] is not None
                        else LOG2_BUCKETS
                    )
                    if fam.buckets != want:
                        raise MetricError(
                            f"histogram {name} re-registered with buckets "
                            f"{want} but exists with {fam.buckets}"
                        )
                return fam
            fam = cls(name, help, labelnames, **kw)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "", labelnames=()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "", labelnames=()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(
        self, name: str, help: str = "", labelnames=(), buckets=None
    ) -> Histogram:
        return self._get_or_create(
            Histogram, name, help, labelnames, buckets=buckets
        )

    def collect(self):
        """Stable-ordered iteration over families (render determinism)."""
        with self._lock:
            families = sorted(self._families.items())
        for _, fam in families:
            yield fam

    def snapshot(self) -> dict:
        """Machine-readable dump: the source of truth bench.py and the
        harness scripts read instead of parsing logs.

        {name: {"kind", "labels": [names], "series": {"a,b": value-or-
        {"sum","count","buckets":[[le, cum], ...]}}}} — label values joined
        with commas (none of this codebase's label values contain one).
        """
        out = {}
        for fam in self.collect():
            series = {}
            for key, val in fam.collect().items():
                k = ",".join(key)
                if isinstance(val, dict):
                    series[k] = {
                        "sum": val["sum"],
                        "count": val["count"],
                        "buckets": [[le, c] for le, c in val["buckets"]],
                    }
                else:
                    series[k] = val
            out[fam.name] = {
                "kind": fam.kind,
                "labels": list(fam.labelnames),
                "series": series,
            }
        return out

    def reset(self) -> None:
        """Drop every series (families persist). Test isolation hook."""
        for fam in self.collect():
            fam.clear()


# The process-wide default registry. Every component (server, client,
# broker, engines) writes here unless handed an explicit registry, so an
# in-process stack exposes one coherent /metrics page.
REGISTRY = Registry()


def get_registry() -> Registry:
    return REGISTRY
