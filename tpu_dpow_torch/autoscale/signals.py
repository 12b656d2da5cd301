"""Signal acquisition: one Signals row per poll, from snapshot or scrape.

The controller judges ONLY what the stack already exports — the
``dpow_server_request_seconds`` latency histogram, the ``dpow_sched_*``
queue/window family, ``dpow_coalesce_total``, ``dpow_fleet_hashrate_hs``,
``dpow_replica_live`` — read either in-process (``obs.snapshot()``) or by
scraping each replica's ``/metrics`` page, the same Prometheus text
surface operators scrape. Counters and histograms are CUMULATIVE, so the
poller keeps the previous scrape per source and works on deltas: the p95
it reports is the p95 of requests completed SINCE THE LAST POLL (merged
across replicas), not a lifetime average that would lag every incident.

A replica that cannot be scraped (dying, mid-restart) is skipped and
counted in ``sources_ok``/``sources_total`` — its previous cumulative
state is kept so one missed scrape doesn't fabricate a burst of deltas
when it returns.

Two deliberate differences from ``tpu_dpow.autoscale.signals``:

  * the reference reads the family ``dpow_fleet_hashrate``, which no hub
    registers (the fleet registry exports ``dpow_fleet_hashrate_hs``), so
    its journaled ``fleet_hashrate`` is 0.0 whatever the fleet announces.
    The port reads :data:`FLEET_HASHRATE_METRIC` and folds it with max
    over sources: every replica's registry hears the same worker
    announces, so a sum would count the fleet once per replica. The
    controller never reads the field, so every decision, and the replay
    of either package's journal, is unchanged;
  * :meth:`MetricsPoller.prime` takes every source's cumulative state as
    the baseline without producing a row. Without it the first poll
    against replicas that are already running reports everything they
    served since they started, and the window keeps it for its length.
"""

from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from ..obs import prom
from ..resilience.clock import Clock, SystemClock

#: the latency histogram the SLO is judged on
LATENCY_METRIC = "dpow_server_request_seconds"

#: the fleet registry's announced-hashrate gauge (fleet/registry.py)
FLEET_HASHRATE_METRIC = "dpow_fleet_hashrate_hs"

#: work_type label value for requests that died before being served
#: (client abort, busy refusal, timeout). Excluded from the p95 signal:
#: a client that abandoned at 8 s is not evidence of 8 s service, and a
#: 429 answered in 2 ms is not evidence of 2 ms service — refusal volume
#: shows up through queue depth and the sched counters instead.
UNSERVED_LABEL = "unresolved"


@dataclass
class Signals:
    """One poll's view of the system. Everything the controller reads."""

    t: float
    p95_s: Optional[float]          # windowed p95 (None = nothing completed)
    completed: int                  # requests completed in the window
    queue_depth: float              # sched: admitted work waiting for a slot
    inflight: float                 # sched: dispatches holding window slots
    capacity: float                 # sched: configured window (summed)
    occupancy: Optional[float]      # inflight/capacity (None = unbounded)
    coalesce_delta: float           # same-hash attaches in the window
    fleet_hashrate: float           # announced worker fleet H/s (max across sources)
    replicas_live: float            # ring liveness (max across sources)
    sources_ok: int
    sources_total: int
    # Fraction of requests completed IN THE WINDOW that were served from
    # precached work (dpow_precache_requests_total deltas merged across
    # sources; None = no classified request completed this window).
    # Counter-delta, not the server's sliding-window gauge: the gauge's
    # window and the poll cadence would otherwise double-smooth. Trailing
    # + defaulted so pre-precache journals still from_dict cleanly.
    precache_hit_ratio: Optional[float] = None

    def to_dict(self) -> dict:
        d = dict(self.__dict__)
        # JSON has no inf/nan; the journal must round-trip
        for k, v in d.items():
            if isinstance(v, float) and not math.isfinite(v):
                d[k] = None
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Signals":
        return cls(**{k: d.get(k) for k in cls.__dataclass_fields__})


# -- cumulative state per source --------------------------------------------


@dataclass
class _SourceState:
    buckets: Dict[float, float] = field(default_factory=dict)  # le -> cum
    counters: Dict[str, float] = field(default_factory=dict)


def _sum_series(parsed: dict, name: str) -> float:
    return float(sum(v for _, v in parsed.get(name, [])))


def _latency_buckets(parsed: dict) -> Dict[float, float]:
    """Cumulative (le -> count) summed over SERVED label sets, from a
    parsed /metrics page."""
    out: Dict[float, float] = {}
    for labels, value in parsed.get(f"{LATENCY_METRIC}_bucket", []):
        if labels.get("work_type") == UNSERVED_LABEL:
            continue
        le_raw = labels.get("le", "")
        try:
            le = math.inf if le_raw == "+Inf" else float(le_raw)
        except ValueError:
            continue
        out[le] = out.get(le, 0.0) + value
    return out


def _outcome_sum(parsed: dict, name: str, outcome: str) -> float:
    return float(sum(
        v for labels, v in parsed.get(name, [])
        if labels.get("outcome") == outcome
    ))


def parse_metrics_page(text: str) -> dict:
    """A scraped page reduced to what the controller needs."""
    parsed = prom.parse_text(text)
    return {
        "latency_buckets": _latency_buckets(parsed),
        "queue_depth": _sum_series(parsed, "dpow_sched_queue_depth"),
        "inflight": _sum_series(parsed, "dpow_sched_inflight"),
        "capacity": _sum_series(parsed, "dpow_sched_window_capacity"),
        "coalesce": _sum_series(parsed, "dpow_coalesce_total"),
        "fleet_hashrate": _sum_series(parsed, FLEET_HASHRATE_METRIC),
        "precache_hits": _outcome_sum(
            parsed, "dpow_precache_requests_total", "hit"),
        "precache_misses": _outcome_sum(
            parsed, "dpow_precache_requests_total", "miss"),
        "replica_live": max(
            (v for _, v in parsed.get("dpow_replica_live", [])), default=0.0
        ),
    }


def snapshot_page(snapshot: dict) -> dict:
    """The same reduction from an in-process ``obs.snapshot()``."""
    def total(name: str) -> float:
        fam = snapshot.get(name, {})
        vals = fam.get("series", {}).values()
        return float(sum(v for v in vals if isinstance(v, (int, float))))

    buckets: Dict[float, float] = {}
    fam = snapshot.get(LATENCY_METRIC, {})
    labels = fam.get("labels", [])
    wt_idx = labels.index("work_type") if "work_type" in labels else None
    for key, series in fam.get("series", {}).items():
        if not isinstance(series, dict):
            continue
        if wt_idx is not None and key.split(",")[wt_idx] == UNSERVED_LABEL:
            continue
        for le, cum in series.get("buckets", []):
            le = math.inf if le == float("inf") else float(le)
            buckets[le] = buckets.get(le, 0.0) + float(cum)
    live_fam = snapshot.get("dpow_replica_live", {}).get("series", {})
    live = max(
        (v for v in live_fam.values() if isinstance(v, (int, float))),
        default=0.0,
    )
    pre_fam = snapshot.get("dpow_precache_requests_total", {})
    pre_labels = pre_fam.get("labels", [])
    o_idx = pre_labels.index("outcome") if "outcome" in pre_labels else None
    hits = misses = 0.0
    if o_idx is not None:
        for key, v in pre_fam.get("series", {}).items():
            if not isinstance(v, (int, float)):
                continue
            outcome = key.split(",")[o_idx]
            if outcome == "hit":
                hits += v
            elif outcome == "miss":
                misses += v
    return {
        "latency_buckets": buckets,
        "queue_depth": total("dpow_sched_queue_depth"),
        "inflight": total("dpow_sched_inflight"),
        "capacity": total("dpow_sched_window_capacity"),
        "coalesce": total("dpow_coalesce_total"),
        "fleet_hashrate": total(FLEET_HASHRATE_METRIC),
        "precache_hits": hits,
        "precache_misses": misses,
        "replica_live": float(live),
    }


def _page_to_signals(
    t: float,
    pages: List[dict],
    states: List[_SourceState],
    ok: int,
    total_sources: int,
    history: Optional[deque] = None,
    window: float = 0.0,
) -> Signals:
    """Fold per-source pages + previous cumulative states into one row.
    Mutates the states to the new cumulative values. With a ``history``
    deque the p95 is computed over every per-poll bucket delta of the
    last ``window`` seconds, not just this poll's — the smoothing the
    hysteresis streaks reason over."""
    merged_delta: Dict[float, float] = {}
    coalesce_delta = hit_delta = miss_delta = 0.0
    queue_depth = inflight = capacity = fleet = live = 0.0
    for page, state in zip(pages, states):
        if page is None:
            continue
        cur = page["latency_buckets"]
        for le, cum in cur.items():
            prev = state.buckets.get(le, 0.0)
            # counter reset (process restart) ⇒ the whole page is fresh
            d = cum - prev if cum >= prev else cum
            merged_delta[le] = merged_delta.get(le, 0.0) + d
        state.buckets = dict(cur)
        prev_coal = state.counters.get("coalesce", 0.0)
        cur_coal = page["coalesce"]
        coalesce_delta += cur_coal - prev_coal if cur_coal >= prev_coal else cur_coal
        state.counters["coalesce"] = cur_coal
        # precache yield: same reset-tolerant counter-delta fold (pages
        # from pre-precache journals simply lack the keys)
        for field_name, bucket in (
            ("precache_hits", "hits"), ("precache_misses", "misses"),
        ):
            cur_v = page.get(field_name, 0.0)
            prev_v = state.counters.get(field_name, 0.0)
            d = cur_v - prev_v if cur_v >= prev_v else cur_v
            state.counters[field_name] = cur_v
            if bucket == "hits":
                hit_delta += d
            else:
                miss_delta += d
        queue_depth += page["queue_depth"]
        inflight += page["inflight"]
        capacity += page["capacity"]
        fleet = max(fleet, page["fleet_hashrate"])
        live = max(live, page["replica_live"])
    if history is not None:
        history.append((t, merged_delta))
        while history and history[0][0] < t - window:
            history.popleft()
        windowed: Dict[float, float] = {}
        for _, delta in history:
            for le, d in delta.items():
                windowed[le] = windowed.get(le, 0.0) + d
        rows = sorted(windowed.items())
    else:
        rows = sorted(merged_delta.items())
    completed = rows[-1][1] if rows else 0.0
    p95 = prom.histogram_quantile(rows, 0.95) if completed > 0 else None
    return Signals(
        t=t,
        p95_s=p95,
        completed=int(completed),
        queue_depth=queue_depth,
        inflight=inflight,
        capacity=capacity,
        occupancy=(inflight / capacity) if capacity > 0 else None,
        coalesce_delta=coalesce_delta,
        fleet_hashrate=fleet,
        replicas_live=live,
        sources_ok=ok,
        sources_total=total_sources,
        precache_hit_ratio=(
            hit_delta / (hit_delta + miss_delta)
            if (hit_delta + miss_delta) > 0 else None
        ),
    )


def signals_from_snapshot(
    snapshot: dict, t: float, state: Optional[_SourceState] = None
) -> Tuple[Signals, _SourceState]:
    """One-source convenience for in-process callers (tests, benches):
    per-poll deltas, no extra windowing."""
    st = state or _SourceState()
    sig = _page_to_signals(t, [snapshot_page(snapshot)], [st], 1, 1)
    return sig, st


class MetricsPoller:
    """Scrape N replica /metrics pages and fold them into Signals rows.

    ``sources`` are base URLs (``http://127.0.0.1:<upcheck_port>``) or
    zero-arg callables returning an ``obs.snapshot()`` dict (in-process).
    Per-source cumulative state keys on the source's position, so keep
    the list stable (replace entries, don't reorder).
    """

    def __init__(
        self,
        sources: Sequence,
        *,
        clock: Optional[Clock] = None,
        timeout: float = 2.0,
        window: float = 15.0,
        session=None,
    ):
        self.sources = list(sources)
        self.clock = clock or SystemClock()
        self.timeout = timeout
        self.window = window
        self._session = session
        self._states = [_SourceState() for _ in self.sources]
        self._history: deque = deque()

    def set_sources(self, sources: Sequence) -> None:
        """Grow/shrink the source list (the actuator scaled the fleet);
        existing positions keep their cumulative state."""
        new_states = []
        for i, _ in enumerate(sources):
            if i < len(self.sources) and self.sources[i] == sources[i]:
                new_states.append(self._states[i])
            else:
                new_states.append(_SourceState())
        self.sources = list(sources)
        self._states = new_states

    def _ensure_session(self):
        # sync on purpose: no await between the None-check and the
        # assignment (dpowlint DPOW801)
        if self._session is None:
            import aiohttp

            self._session = aiohttp.ClientSession()
        return self._session

    async def _fetch(self, source) -> Optional[dict]:
        if callable(source):
            try:
                return snapshot_page(source())
            except Exception:
                return None
        import aiohttp

        self._ensure_session()
        try:
            async with self._session.get(
                source + "/metrics",
                timeout=aiohttp.ClientTimeout(total=self.timeout),
            ) as resp:
                if resp.status != 200:
                    return None
                return parse_metrics_page(await resp.text())
        except Exception:
            return None

    async def prime(self) -> int:
        """Scrape every source once and keep its cumulative state as the
        baseline, producing no row and adding nothing to the window: the
        next :meth:`poll` reports only what completed after this call.
        Returns the number of sources that answered; one that did not
        starts from zero when it first answers, as a restarted one does."""
        pages = [await self._fetch(source) for source in self.sources]
        _page_to_signals(self.clock.time(), pages, self._states, 0, len(self.sources))
        return sum(1 for p in pages if p is not None)

    async def poll(self) -> Signals:
        pages = []
        for source in self.sources:
            pages.append(await self._fetch(source))
        ok = sum(1 for p in pages if p is not None)
        return _page_to_signals(
            self.clock.time(), pages, self._states, ok, len(self.sources),
            history=self._history, window=self.window,
        )

    async def close(self) -> None:
        # detach-then-await (docs/resilience.md concurrency idioms)
        session, self._session = self._session, None
        if session is not None:
            await session.close()
