"""Autoscaler entrypoint: ``python -m tpu_dpow_torch.autoscale [flags]``.

Two modes:

  * poll loop (default) — scrape the replicas named by ``--metrics_urls``
    every ``--slo_poll_interval``, journal every decision, and actuate
    whatever levers are configured: the shed/horizon control face always
    (over ``--control_urls``, defaulting to the metrics URLs), the
    replica spawn/retire lever only when ``--replica_cmd`` provides a
    command template (journal-only otherwise — safe to point at a
    production ring before trusting it with levers);
  * ``--replay journal.jsonl`` — offline re-judgement: rebuild the
    controller from the journal's own header, re-run every journaled
    poll, exit 0 iff every decision reproduces (docs/loadgen.md).
"""

from __future__ import annotations

import asyncio
import shlex
import sys

from ..resilience.clock import SystemClock
from ..utils.logging import get_logger
from . import journal as journal_mod
from .actuator import HttpControlActuator, LogActuator, ReplicaFleetActuator
from .config import parse_args
from .controller import SCALE_DOWN, SCALE_UP, SLOController
from .signals import MetricsPoller

logger = get_logger("tpu_dpow_torch.autoscale")


def _urls(raw: str) -> list:
    return [u.strip().rstrip("/") for u in raw.split(",") if u.strip()]


async def amain(argv=None) -> int:
    config = parse_args(argv)
    get_logger("tpu_dpow_torch.autoscale", file_path=config.log_file)
    if config.replay:
        report = journal_mod.replay(config.replay)
        print(report.render())
        return 0 if report.ok else 1

    metrics_urls = _urls(config.metrics_urls)
    if not metrics_urls:
        print("autoscale: --metrics_urls is required (or use --replay)",
              file=sys.stderr)
        return 2
    control_urls = _urls(config.control_urls) or metrics_urls
    clock = SystemClock()
    poller = MetricsPoller(metrics_urls, clock=clock, window=config.slo_window)
    controller = SLOController(
        config, initial_replicas=max(config.slo_min_replicas, len(metrics_urls))
    )
    control = HttpControlActuator(control_urls)
    fleet = None
    if config.replica_cmd:
        template = config.replica_cmd
        upcheck_tpl = config.replica_upcheck or ""
        if "{i}" not in upcheck_tpl:
            print(
                "autoscale: --replica_cmd needs --replica_upcheck with an "
                "{i} placeholder (how the actuator reaches a spawned "
                "replica's /metrics + /control/ to drain it)",
                file=sys.stderr,
            )
            return 2

        def spawn_spec(i: int) -> dict:
            return {
                "cmd": shlex.split(template.replace("{i}", str(i))),
                "service_url": "",
                "upcheck_url": upcheck_tpl.replace("{i}", str(i)).rstrip("/"),
            }

        def on_change(specs):
            # the controller must see (and the levers must reach) the
            # fleet it actually runs — including replicas it spawned
            urls = [s["upcheck_url"] for s in specs]
            poller.set_sources(urls)
            control.set_faces(urls)

        fleet = ReplicaFleetActuator(
            spawn_spec, clock=clock, on_change=on_change,
        )
        # the replicas already running behind --metrics_urls ARE the
        # current fleet: adopt them (proc None: the actuator may drain
        # their faces but never signals a process it did not spawn), so
        # the first scale_up spawns ONE replica, not a duplicate fleet
        for i, url in enumerate(metrics_urls):
            fleet.adopt(i, None, {
                "cmd": [], "service_url": "", "upcheck_url": url,
            })
    fallback = LogActuator()
    journal = (
        journal_mod.DecisionJournal(
            config.journal, config, initial_state=controller.state_dict()
        )
        if config.journal
        else None
    )
    logger.info(
        "autoscaler up: %d source(s), SLO p95 %.0f ms, levers: control=%s "
        "fleet=%s journal=%s",
        len(metrics_urls), config.slo_p95_ms,
        bool(control_urls), bool(fleet), config.journal or "-",
    )
    try:
        # the replicas may have served for hours: their cumulative pages
        # are the baseline, so the first row judges the first interval only
        await poller.prime()
        while True:
            await clock.sleep(config.slo_poll_interval)
            signals = await poller.poll()
            actions = controller.decide(signals)
            if journal is not None:
                journal.record(signals, actions, controller.state_dict())
            for action in actions:
                logger.info("autoscale: %s — %s", action.kind, action.reason)
                if action.kind in (SCALE_UP, SCALE_DOWN):
                    if fleet is None:
                        await fallback.apply(action)  # journaled only
                    else:
                        await fleet.apply(action)
                else:
                    await control.apply(action)
    except (KeyboardInterrupt, asyncio.CancelledError):
        return 0
    finally:
        if journal is not None:
            journal.close()
        await poller.close()
        await control.close()
        if fleet is not None:
            await fleet.close()


def main(argv=None) -> None:
    try:
        rc = asyncio.run(amain(argv))
    except KeyboardInterrupt:
        rc = 0
    sys.exit(rc)


if __name__ == "__main__":
    main()
