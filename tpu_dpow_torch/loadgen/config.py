"""Loadgen configuration: the ``--loadgen_*`` flag surface.

The port's copy of ``tpu_dpow/loadgen/config.py``: the same flags,
defaults and builders, for anything that wants a schedule+population from
flags (``chip_smoke.py``'s swarm phase builds its population here).
"""

from __future__ import annotations

import argparse
from dataclasses import dataclass
from typing import Iterator, Optional

from .arrival import Arrival, ConstantRate, DiurnalRate, RateFunction, SpikeOverlay
from .arrival import poisson_schedule, trace_schedule
from .population import ServicePopulation


@dataclass
class LoadgenConfig:
    loadgen_n: int = 10000
    loadgen_rate: float = 0.0
    loadgen_peak: float = 0.0
    loadgen_period: float = 600.0
    loadgen_spike_factor: float = 10.0
    loadgen_spike_at: float = -1.0
    loadgen_spike_duration: float = 30.0
    loadgen_trace: Optional[str] = None
    loadgen_trace_scale: float = 1.0
    loadgen_services: int = 1000
    loadgen_seed: int = 0
    loadgen_window: float = 5.0
    loadgen_ws_fraction: float = 0.1
    loadgen_max_inflight: int = 20000
    loadgen_out: Optional[str] = None


def add_flags(p: argparse.ArgumentParser) -> None:
    c = LoadgenConfig()
    p.add_argument("--loadgen_n", type=int, default=c.loadgen_n,
                   help="total requests in the schedule")
    p.add_argument("--loadgen_rate", type=float, default=c.loadgen_rate,
                   help="base arrival rate in requests/second — the "
                   "diurnal trough when --loadgen_peak is also set. 0 "
                   "(default) = AUTO: the capture derives the acceptance "
                   "shape from measured capacity instead")
    p.add_argument("--loadgen_peak", type=float, default=c.loadgen_peak,
                   help="diurnal crest rate (0 = constant-rate Poisson at "
                   "--loadgen_rate)")
    p.add_argument("--loadgen_period", type=float, default=c.loadgen_period,
                   help="diurnal period in seconds (a compressed 'day')")
    p.add_argument("--loadgen_spike_factor", type=float,
                   default=c.loadgen_spike_factor,
                   help="flash-crowd multiplier on the instantaneous rate")
    p.add_argument("--loadgen_spike_at", type=float, default=c.loadgen_spike_at,
                   help="spike start (schedule seconds); -1 = at the first "
                   "diurnal crest")
    p.add_argument("--loadgen_spike_duration", type=float,
                   default=c.loadgen_spike_duration,
                   help="spike length in seconds (0 disables the spike)")
    p.add_argument("--loadgen_trace", default=c.loadgen_trace,
                   help="replay arrivals from this JSONL trace instead of "
                   "generating them (one {\"t\": seconds, ...} per line; "
                   "non-monotonic timestamps are refused with the line "
                   "number)")
    p.add_argument("--loadgen_trace_scale", type=float,
                   default=c.loadgen_trace_scale,
                   help="time-compression factor for --loadgen_trace "
                   "(0.1 replays 10x faster)")
    p.add_argument("--loadgen_services", type=int, default=c.loadgen_services,
                   help="simulated service population size (each registered "
                   "in the store with its own quota identity)")
    p.add_argument("--loadgen_seed", type=int, default=c.loadgen_seed,
                   help="seed for the schedule and the population (same "
                   "seed = same request stream)")
    p.add_argument("--loadgen_window", type=float, default=c.loadgen_window,
                   help="recorder timeline window (seconds)")
    p.add_argument("--loadgen_ws_fraction", type=float,
                   default=c.loadgen_ws_fraction,
                   help="fraction of requests issued over the websocket "
                   "face instead of HTTP POST (live mode)")
    p.add_argument("--loadgen_max_inflight", type=int,
                   default=c.loadgen_max_inflight,
                   help="generator safety valve: past this many outstanding "
                   "requests, arrivals are recorded as shed_client instead "
                   "of issued (a degraded capture, and labeled as such)")
    p.add_argument("--loadgen_out", default=c.loadgen_out,
                   help="write the capture JSON here")


def parse_args(argv=None) -> LoadgenConfig:
    p = argparse.ArgumentParser("tpu-dpow-torch open-loop load generator")
    add_flags(p)
    return LoadgenConfig(**vars(p.parse_args(argv)))


def from_namespace(ns: argparse.Namespace) -> LoadgenConfig:
    """Extract the loadgen fields from a larger parser's namespace."""
    fields = LoadgenConfig.__dataclass_fields__
    return LoadgenConfig(**{k: getattr(ns, k) for k in fields})


def build_rate(c: LoadgenConfig) -> RateFunction:
    if c.loadgen_rate <= 0:
        raise ValueError(
            "build_rate needs an explicit --loadgen_rate (> 0); rate 0 "
            "means 'auto shape', which is the capture harness's job"
        )
    if c.loadgen_peak > 0:
        rate: RateFunction = DiurnalRate(
            c.loadgen_rate, c.loadgen_peak, period=c.loadgen_period
        )
        crest = c.loadgen_period / 2.0
    else:
        rate = ConstantRate(c.loadgen_rate)
        crest = 0.0
    if c.loadgen_spike_duration > 0 and c.loadgen_spike_factor > 1.0:
        at = c.loadgen_spike_at if c.loadgen_spike_at >= 0 else crest
        rate = SpikeOverlay(
            rate, at=at, duration=c.loadgen_spike_duration,
            factor=c.loadgen_spike_factor,
        )
    return rate


def build_schedule(c: LoadgenConfig) -> Iterator[Arrival]:
    if c.loadgen_trace:
        with open(c.loadgen_trace, encoding="utf-8") as f:
            # materialized parse: the validator wants line numbers
            return iter(list(trace_schedule(
                f, time_scale=c.loadgen_trace_scale
            )))
    return poisson_schedule(
        build_rate(c), n=c.loadgen_n, seed=c.loadgen_seed
    )


def build_population(c: LoadgenConfig) -> ServicePopulation:
    return ServicePopulation(c.loadgen_services, seed=c.loadgen_seed)
