"""Autoscaler configuration: the ``--slo_*`` operator surface.

The flags, their defaults and :func:`config_dict`'s keys are
``tpu_dpow.autoscale.config``'s (docs/flags.md): the journal header carries
``config_dict``, and a replay in either package rebuilds its controller from
it. The controller is deliberately configured in SIGNAL units
(milliseconds of p95, polls of streak, seconds of cooldown) rather than
internals, because these are the numbers an operator reasons about when
writing the SLO down.
"""

from __future__ import annotations

import argparse
from dataclasses import dataclass
from typing import Optional


@dataclass
class AutoscaleConfig:
    # -- the SLO and how it is judged ----------------------------------
    slo_p95_ms: float = 1000.0
    slo_poll_interval: float = 2.0
    slo_window: float = 15.0
    #: consecutive breaching polls before the controller acts (hysteresis:
    #: one noisy sample must never scale anything)
    slo_breach_polls: int = 3
    #: consecutive clear polls before de-escalation is even considered
    slo_clear_polls: int = 5
    #: "clear" means p95 below slo * this factor (the hysteresis band:
    #: between clear_factor*slo and slo the controller holds position)
    slo_clear_factor: float = 0.6
    #: queued-work depth that counts as a breach on its own — under hard
    #: overload completions stall, so the p95 of what DID complete
    #: flatters the system; queue depth is the leading indicator
    slo_queue_high: float = 32.0
    #: seconds after any action during which no further action fires
    slo_cooldown: float = 10.0
    # -- the replica lever ---------------------------------------------
    slo_min_replicas: int = 1
    slo_max_replicas: int = 3
    #: de-escalation gate: scale-down requires queue == 0 AND occupancy
    #: at or below this (the window has drained, not merely quieted)
    slo_drain_occupancy: float = 0.5
    # -- the other levers ----------------------------------------------
    #: fleet_horizon (seconds) pushed to replicas while under pressure;
    #: 0 = leave the horizon lever alone
    slo_pressure_horizon: float = 0.0
    #: calm-state fleet_horizon restored on de-escalation
    slo_calm_horizon: float = 0.0
    #: disable the precache-shed lever entirely
    slo_no_shed: bool = False
    # -- plumbing (CLI only) -------------------------------------------
    metrics_urls: str = ""
    control_urls: str = ""
    journal: Optional[str] = None
    replay: Optional[str] = None
    replica_cmd: Optional[str] = None
    replica_upcheck: Optional[str] = None
    log_file: Optional[str] = None


def add_flags(p: argparse.ArgumentParser) -> None:
    c = AutoscaleConfig()
    p.add_argument("--slo_p95_ms", type=float, default=c.slo_p95_ms,
                   help="the SLO: windowed p95 service latency (ms) the "
                   "controller defends")
    p.add_argument("--slo_poll_interval", type=float,
                   default=c.slo_poll_interval,
                   help="seconds between signal polls / decisions")
    p.add_argument("--slo_window", type=float, default=c.slo_window,
                   help="seconds of signal history each p95 is computed "
                   "over (histogram delta window)")
    p.add_argument("--slo_breach_polls", type=int, default=c.slo_breach_polls,
                   help="consecutive breaching polls before the controller "
                   "escalates (hysteresis against noisy signals)")
    p.add_argument("--slo_clear_polls", type=int, default=c.slo_clear_polls,
                   help="consecutive clear polls before de-escalation is "
                   "considered")
    p.add_argument("--slo_clear_factor", type=float, default=c.slo_clear_factor,
                   help="clear means p95 below slo_p95_ms times this "
                   "(the hold band between clear and breach)")
    p.add_argument("--slo_queue_high", type=float, default=c.slo_queue_high,
                   help="admission queue depth that counts as a breach by "
                   "itself (completions stall under hard overload, so "
                   "completed-request p95 alone flatters the system)")
    p.add_argument("--slo_cooldown", type=float, default=c.slo_cooldown,
                   help="seconds after any action during which no further "
                   "action fires")
    p.add_argument("--slo_min_replicas", type=int, default=c.slo_min_replicas,
                   help="floor on the replica count")
    p.add_argument("--slo_max_replicas", type=int, default=c.slo_max_replicas,
                   help="ceiling on the replica count")
    p.add_argument("--slo_drain_occupancy", type=float,
                   default=c.slo_drain_occupancy,
                   help="scale-down additionally requires zero queued work "
                   "and window occupancy at or below this — retire only "
                   "after drain, never against in-flight dispatches")
    p.add_argument("--slo_pressure_horizon", type=float,
                   default=c.slo_pressure_horizon,
                   help="fleet_horizon (s) pushed to replicas while under "
                   "pressure (0 = leave the horizon lever alone)")
    p.add_argument("--slo_calm_horizon", type=float, default=c.slo_calm_horizon,
                   help="fleet_horizon (s) restored on de-escalation")
    p.add_argument("--slo_no_shed", action="store_true",
                   help="never actuate the precache admission shed lever")
    p.add_argument("--metrics_urls", default=c.metrics_urls,
                   help="comma-separated replica /metrics base URLs "
                   "(http://host:upcheck_port) to poll signals from")
    p.add_argument("--control_urls", default=c.control_urls,
                   help="comma-separated replica /control/ base URLs "
                   "(default: the metrics URLs)")
    p.add_argument("--journal", default=c.journal,
                   help="decision-journal JSONL path (TRUNCATED per run — "
                   "one file is one run; replayable with --replay)")
    p.add_argument("--replay", default=c.replay,
                   help="re-judge a decision journal offline: re-run the "
                   "controller over the journaled signals and exit 0 iff "
                   "every journaled decision reproduces")
    p.add_argument("--replica_cmd", default=c.replica_cmd,
                   help="command template to spawn replica {i} (shlex-"
                   "split; '{i}' substituted) — enables the process "
                   "spawn/retire lever from the CLI; the replicas behind "
                   "--metrics_urls are adopted as the current fleet, so "
                   "scale-up spawns only the delta")
    p.add_argument("--replica_upcheck", default=c.replica_upcheck,
                   help="upcheck base-URL template for spawned replica "
                   "{i} (e.g. http://127.0.0.1:15{i}31) — required with "
                   "--replica_cmd so the actuator can watch and drain "
                   "what it spawns")
    p.add_argument("--log_file", default=c.log_file,
                   help="log destination (default stderr)")


def parse_args(argv=None) -> AutoscaleConfig:
    p = argparse.ArgumentParser("tpu-dpow-torch SLO autoscaler")
    add_flags(p)
    return AutoscaleConfig(**vars(p.parse_args(argv)))


def config_dict(c: AutoscaleConfig) -> dict:
    """The controller-relevant knobs, for the journal header (replay
    rebuilds an identical controller from this)."""
    return {
        k: getattr(c, k)
        for k in (
            "slo_p95_ms", "slo_poll_interval", "slo_window",
            "slo_breach_polls", "slo_clear_polls", "slo_clear_factor",
            "slo_queue_high", "slo_cooldown", "slo_min_replicas",
            "slo_max_replicas", "slo_drain_occupancy",
            "slo_pressure_horizon", "slo_calm_horizon", "slo_no_shed",
        )
    }
