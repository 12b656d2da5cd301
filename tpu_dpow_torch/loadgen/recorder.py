"""Coordinated-omission-safe capture: latency from INTENDED arrival time.

The classic load-test lie: the generator stalls (or politely back-pressures)
while the system chokes, so the worst moments contribute the FEWEST samples
and the percentiles come out rosy. Two rules fix it, both enforced here:

  1. every request's latency is measured from its *intended* arrival time
     (the schedule's timestamp mapped onto the run's clock), never from
     the moment the driver actually got the bytes out — a driver that
     falls behind turns into recorded latency, not missing samples;
  2. the issue LAG (actual send minus intended arrival) is captured as
     its own distribution, so a capture where the GENERATOR was the
     bottleneck is detectable and gradable (``max_lag`` in the summary —
     an open-loop claim with seconds of lag is really a closed loop in
     disguise).

Timestamps ride the injectable ``resilience.Clock`` (FakeClock tests and
the discrete-event sim pass explicit times), and the fixed quarter-log2
bucket ladder keeps percentile error ≤ ~9% at 1M-request scale with O(1)
memory per window.
"""

from __future__ import annotations

import math
from bisect import bisect_left
from typing import Dict, List, Optional, Tuple

from .. import obs
from ..resilience.clock import Clock, SystemClock

#: quarter-log2 ladder, 2^-11 s (~0.5 ms) .. 2^6.25 s (~76 s): finer than
#: the shared obs LOG2 ladder because open-loop percentiles are the
#: HEADLINE here, not a supporting signal. A value falls in bucket i when
#: value <= FINE_BUCKETS[i]; the relative quantile error is bounded by the
#: step ratio 2^0.25 ≈ 1.19.
FINE_BUCKETS: Tuple[float, ...] = tuple(2.0 ** (e / 4.0) for e in range(-44, 26))

#: every terminal request outcome the recorder accepts (exhaustive and
#: disjoint — the summary's outcome counts sum to the offered load)
OUTCOMES = (
    "ok",            # served with work
    "busy",          # 429 / busy frame (admission shed or refusal)
    "timeout",       # the service's own patience ran out
    "cancelled",     # the simulated client abandoned it (intended)
    "error",         # transport error / unexpected reply
    "shed_client",   # driver safety valve: never issued (see driver)
)

#: outcomes that count as FAILED for percentile purposes: they land in
#: the +Inf bucket regardless of how fast the refusal came back. A 429
#: answered in 2 ms is not a 2 ms success — without this, an overloaded
#: system shedding 40% of its load would post a BETTER p95 than a
#: healthy one, and the SLO verdict would reward collapse. ``cancelled``
#: is excluded (the client's own choice) and ``shed_client`` is the
#: generator's failure, not the system's — but it still poisons the
#: percentile: a capture that under-issued must not grade well.
FAIL_OUTCOMES = frozenset({"busy", "timeout", "error", "shed_client"})


def _percentile_from_counts(counts: List[int], q: float) -> Optional[float]:
    """Quantile estimate from per-bucket (non-cumulative) counts: the
    winning bucket's UPPER edge — pessimistic by ≤ one ladder step, which
    is the right bias for grading an SLO."""
    total = sum(counts)
    if total == 0:
        return None
    rank = q * total
    cum = 0
    for i, c in enumerate(counts):
        cum += c
        if cum >= rank:
            return FINE_BUCKETS[i] if i < len(FINE_BUCKETS) else math.inf
    return math.inf


class _Window:
    __slots__ = ("counts", "n", "total", "max", "outcomes")

    def __init__(self):
        self.counts = [0] * (len(FINE_BUCKETS) + 1)
        self.n = 0
        self.total = 0.0
        self.max = 0.0
        self.outcomes: Dict[str, int] = {}


class OpenLoopRecorder:
    """Per-run capture: overall + windowed latency distributions, outcome
    accounting, and issue-lag tracking. One instance per capture."""

    def __init__(
        self,
        clock: Optional[Clock] = None,
        *,
        window: float = 5.0,
        registry=None,
    ):
        self.clock = clock or SystemClock()
        self.window = float(window)
        self.start_t: Optional[float] = None
        self.max_lag = 0.0
        self._windows: Dict[int, _Window] = {}
        self._overall = _Window()
        reg = registry or obs.get_registry()
        self._m_requests = reg.counter(
            "dpow_loadgen_requests_total",
            "Open-loop requests by terminal outcome", ("outcome",))
        self._m_latency = reg.histogram(
            "dpow_loadgen_latency_seconds",
            "Latency from INTENDED arrival to completion "
            "(coordinated-omission-safe)", buckets=FINE_BUCKETS)
        self._m_lag = reg.histogram(
            "dpow_loadgen_issue_lag_seconds",
            "Actual issue time minus intended arrival (generator health; "
            "seconds of lag = the capture degraded to closed-loop)",
            buckets=FINE_BUCKETS)
        self._m_inflight = reg.gauge(
            "dpow_loadgen_inflight", "Issued requests not yet concluded")

    # -- run bookkeeping -----------------------------------------------

    def begin(self, start_t: Optional[float] = None) -> float:
        """Pin the schedule's t=0 onto the clock. Returns it."""
        self.start_t = self.clock.time() if start_t is None else start_t
        return self.start_t

    def _intended(self, intended_t: float) -> float:
        if self.start_t is None:
            self.begin()
        return self.start_t + intended_t

    # -- per-request events --------------------------------------------

    def issued(self, intended_t: float, actual_t: Optional[float] = None) -> float:
        """Record the issue lag for one request; returns the absolute
        intended time every latency for it must be measured from."""
        due = self._intended(intended_t)
        now = self.clock.time() if actual_t is None else actual_t
        lag = max(now - due, 0.0)
        self.max_lag = max(self.max_lag, lag)
        self._m_lag.observe(lag)
        self._m_inflight.inc()
        return due

    def done(
        self,
        intended_t: float,
        outcome: str,
        end_t: Optional[float] = None,
        *,
        issued: bool = True,
    ) -> float:
        """Conclude one request. Latency = end - INTENDED arrival."""
        if outcome not in OUTCOMES:
            raise ValueError(f"unknown outcome {outcome!r} (one of {OUTCOMES})")
        due = self._intended(intended_t)
        now = self.clock.time() if end_t is None else end_t
        latency = max(now - due, 0.0)
        self._m_requests.inc(1, outcome)
        self._m_latency.observe(latency)
        if issued:
            self._m_inflight.dec()
        if outcome in FAIL_OUTCOMES:
            i = len(FINE_BUCKETS)  # +Inf: a fast refusal is not a success
        else:
            i = bisect_left(FINE_BUCKETS, latency)
        for w in (self._overall, self._windows.setdefault(
                int(intended_t // self.window), _Window())):
            w.counts[i] += 1
            w.n += 1
            w.total += latency
            w.max = max(w.max, latency)
            w.outcomes[outcome] = w.outcomes.get(outcome, 0) + 1
        return latency

    # -- readout --------------------------------------------------------

    def percentile(self, q: float) -> Optional[float]:
        return _percentile_from_counts(self._overall.counts, q)

    def timeline(self) -> List[dict]:
        """Per-window rows, schedule order — the capture's time series."""
        rows = []
        for idx in sorted(self._windows):
            w = self._windows[idx]
            rows.append({
                "t": idx * self.window,
                "n": w.n,
                "mean_ms": round(1e3 * w.total / w.n, 2) if w.n else None,
                "p50_ms": _ms(_percentile_from_counts(w.counts, 0.50)),
                "p95_ms": _ms(_percentile_from_counts(w.counts, 0.95)),
                "p99_ms": _ms(_percentile_from_counts(w.counts, 0.99)),
                "max_ms": round(w.max * 1e3, 2),
                "outcomes": dict(sorted(w.outcomes.items())),
            })
        return rows

    def summary(self, *, slo_p95_ms: Optional[float] = None) -> dict:
        o = self._overall
        out = {
            "n": o.n,
            "outcomes": dict(sorted(o.outcomes.items())),
            "mean_ms": round(1e3 * o.total / o.n, 2) if o.n else None,
            "p50_ms": _ms(self.percentile(0.50)),
            "p95_ms": _ms(self.percentile(0.95)),
            "p99_ms": _ms(self.percentile(0.99)),
            "max_ms": round(o.max * 1e3, 2),
            "max_issue_lag_ms": round(self.max_lag * 1e3, 2),
            "measured_from": "intended_arrival",
        }
        if slo_p95_ms is not None:
            windows = self.timeline()
            holding = [
                w for w in windows
                if w["n"] and w["p95_ms"] is not None and w["p95_ms"] <= slo_p95_ms
            ]
            nonempty = [w for w in windows if w["n"]]
            out["slo"] = {
                "p95_ms": slo_p95_ms,
                "overall_met": (
                    out["p95_ms"] is not None and out["p95_ms"] <= slo_p95_ms
                ),
                "windows_total": len(nonempty),
                "windows_holding": len(holding),
                "window_hold_ratio": (
                    round(len(holding) / len(nonempty), 4) if nonempty else None
                ),
            }
        return out


def _ms(v: Optional[float]) -> Optional[float]:
    if v is None:
        return None
    return math.inf if v == math.inf else round(v * 1e3, 2)
