"""Arrival schedules: when requests arrive, independent of how they fare.

An open-loop load test is defined by its arrival process. Everything here
yields :class:`Arrival` records with monotonically non-decreasing ``t``
(seconds from schedule start); the driver maps them onto the injectable
``resilience.Clock`` and never lets an outcome influence the next arrival.

Three sources:

  * :func:`poisson_schedule` — a (possibly non-homogeneous) Poisson
    process over any :class:`RateFunction`, generated by Lewis-Shedler
    thinning: candidates at the ceiling rate, accepted with probability
    rate(t)/ceiling. Homogeneous Poisson is the ``ConstantRate`` special
    case; the diurnal sinusoid and spike overlays compose as rate
    functions, so "a day of traffic with a 10x flash crowd at 18:00" is
    one schedule, not three stitched captures.
  * :func:`trace_schedule` — replay of a recorded JSONL trace (one object
    per line, ``{"t": seconds, ...}``). The parser REJECTS non-monotonic
    timestamps with a line-numbered :class:`TraceError`: a trace that
    goes backwards would otherwise become a negative inter-arrival sleep
    deep inside the driver, which some clock implementations treat as
    "fire immediately" — silently compressing the replayed burst.
  * any plain iterable of floats (tests).

Everything is deterministic per seed and generator-lazy: a million-arrival
schedule is O(1) memory.
"""

from __future__ import annotations

import json
import math
import random
from dataclasses import dataclass
from typing import IO, Iterable, Iterator, List, Optional, Union


@dataclass(frozen=True)
class Arrival:
    """One intended request arrival. ``t`` is seconds from schedule start;
    the optional fields pin population choices (trace replay); ``None``
    leaves the decision to the :class:`~.population.ServicePopulation`."""

    t: float
    service: Optional[str] = None
    hash: Optional[str] = None
    timeout: Optional[float] = None


# ---------------------------------------------------------------------------
# rate functions
# ---------------------------------------------------------------------------


class RateFunction:
    """Instantaneous arrival rate (requests/second) at schedule time t."""

    def rate(self, t: float) -> float:
        raise NotImplementedError

    def ceiling(self) -> float:
        """An upper bound on rate() over the schedule (thinning envelope)."""
        raise NotImplementedError


class ConstantRate(RateFunction):
    def __init__(self, rate: float):
        if rate <= 0:
            raise ValueError("rate must be positive")
        self._rate = float(rate)

    def rate(self, t: float) -> float:
        return self._rate

    def ceiling(self) -> float:
        return self._rate


class DiurnalRate(RateFunction):
    """Sinusoidal day: trough ``base`` at t=phase, crest ``peak`` half a
    period later. period defaults to 24 h; captures compress it
    (``--loadgen_period``) so a "day" fits a bench run."""

    def __init__(
        self,
        base: float,
        peak: float,
        *,
        period: float = 86400.0,
        phase: float = 0.0,
    ):
        if base <= 0 or peak < base:
            raise ValueError("need 0 < base <= peak")
        if period <= 0:
            raise ValueError("period must be positive")
        self.base = float(base)
        self.peak = float(peak)
        self.period = float(period)
        self.phase = float(phase)

    def rate(self, t: float) -> float:
        swing = 0.5 - 0.5 * math.cos(2 * math.pi * (t - self.phase) / self.period)
        return self.base + (self.peak - self.base) * swing

    def ceiling(self) -> float:
        return self.peak


class SpikeOverlay(RateFunction):
    """Multiplies an inner rate by ``factor`` inside [at, at+duration):
    the flash-crowd model (everyone's wallet refreshes the same frontier
    when a market moves). Stack overlays for multiple spikes."""

    def __init__(self, inner: RateFunction, *, at: float, duration: float, factor: float):
        if duration <= 0 or factor <= 0:
            raise ValueError("need positive duration and factor")
        self.inner = inner
        self.at = float(at)
        self.duration = float(duration)
        self.factor = float(factor)

    def rate(self, t: float) -> float:
        r = self.inner.rate(t)
        if self.at <= t < self.at + self.duration:
            r *= self.factor
        return r

    def ceiling(self) -> float:
        return self.inner.ceiling() * max(self.factor, 1.0)


# ---------------------------------------------------------------------------
# Poisson process over a rate function (Lewis-Shedler thinning)
# ---------------------------------------------------------------------------


def poisson_schedule(
    rate_fn: Union[RateFunction, float],
    *,
    n: Optional[int] = None,
    duration: Optional[float] = None,
    seed: int = 0,
) -> Iterator[Arrival]:
    """Arrivals of a Poisson process with intensity ``rate_fn.rate(t)``.

    Stops after ``n`` arrivals, after ``duration`` seconds of schedule
    time, or at whichever comes first when both are given (one must be).
    Deterministic per seed, lazy, O(1) memory.
    """
    if isinstance(rate_fn, (int, float)):
        rate_fn = ConstantRate(float(rate_fn))
    if n is None and duration is None:
        raise ValueError("bound the schedule with n= and/or duration=")
    ceiling = rate_fn.ceiling()
    if ceiling <= 0:
        raise ValueError("rate ceiling must be positive")
    rng = random.Random(seed)
    t = 0.0
    emitted = 0
    while True:
        if n is not None and emitted >= n:
            return
        # candidate at the envelope rate, thinned to the true intensity
        t += rng.expovariate(ceiling)
        if duration is not None and t >= duration:
            return
        if rng.random() * ceiling <= rate_fn.rate(t):
            emitted += 1
            yield Arrival(t)


# ---------------------------------------------------------------------------
# JSONL trace replay
# ---------------------------------------------------------------------------


class TraceError(ValueError):
    """A replay trace that cannot be trusted: every message names the
    offending line so the operator fixes the trace, not the symptom."""


def parse_trace(source: Union[str, IO[str], Iterable[str]]) -> List[Arrival]:
    """Parse a JSONL arrival trace into a validated Arrival list.

    One JSON object per line: ``{"t": <seconds>}`` plus optional
    ``service`` / ``hash`` / ``timeout`` overrides. Blank lines and
    ``#`` comment lines are skipped. Timestamps must be finite,
    non-negative and NON-DECREASING — a trace that runs backwards would
    otherwise turn into a negative inter-arrival sleep in the driver
    (fires immediately, silently compressing the replayed burst), so it
    is refused here with the line number.
    """
    if isinstance(source, str):
        lines: Iterable[str] = source.splitlines()
    else:
        lines = source
    out: List[Arrival] = []
    prev_t = -math.inf
    prev_line = 0
    for lineno, raw in enumerate(lines, 1):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        try:
            obj = json.loads(line)
        except json.JSONDecodeError as e:
            raise TraceError(f"line {lineno}: not valid JSON ({e.msg})") from e
        if not isinstance(obj, dict) or "t" not in obj:
            raise TraceError(f'line {lineno}: expected an object with a "t" field')
        try:
            t = float(obj["t"])
        except (TypeError, ValueError):
            raise TraceError(f"line {lineno}: t={obj['t']!r} is not a number") from None
        if not math.isfinite(t) or t < 0:
            raise TraceError(f"line {lineno}: t={t!r} must be finite and >= 0")
        if t < prev_t:
            raise TraceError(
                f"line {lineno}: t={t} goes backwards (line {prev_line} had "
                f"t={prev_t}) — a non-monotonic trace would become a negative "
                "inter-arrival sleep; sort or re-record the trace"
            )
        timeout = obj.get("timeout")
        if timeout is not None:
            try:
                timeout = float(timeout)
            except (TypeError, ValueError):
                raise TraceError(
                    f"line {lineno}: timeout={obj['timeout']!r} is not a number"
                ) from None
            if not math.isfinite(timeout) or timeout <= 0:
                raise TraceError(f"line {lineno}: timeout={timeout!r} must be > 0")
        out.append(
            Arrival(
                t,
                service=obj.get("service"),
                hash=obj.get("hash"),
                timeout=timeout,
            )
        )
        prev_t, prev_line = t, lineno
    return out


def trace_schedule(
    source: Union[str, IO[str], Iterable[str]],
    *,
    time_scale: float = 1.0,
    repeat: int = 1,
) -> Iterator[Arrival]:
    """Replay a parsed trace, optionally time-compressed (time_scale 0.1
    plays it 10x faster) and/or tiled ``repeat`` times back to back."""
    if time_scale <= 0:
        raise ValueError("time_scale must be positive")
    if repeat < 1:
        raise ValueError("repeat must be >= 1")
    events = parse_trace(source)
    span = events[-1].t if events else 0.0
    for cycle in range(repeat):
        offset = cycle * span
        for ev in events:
            yield Arrival(
                (ev.t + offset) * time_scale,
                service=ev.service,
                hash=ev.hash,
                timeout=ev.timeout,
            )
