"""SLO autoscaler of the port: the feedback loop over the signals the hub exports.

The port's own copy of ``tpu_dpow/autoscale/`` (same names, same journal
format, no import of the reference). Every signal it reads and every lever
it pulls already exists in the port's hub:

  signals     — one :class:`~.signals.Signals` row per poll, read from
                ``obs.snapshot()`` in-process or scraped from N replicas'
                ``/metrics`` pages (the same surface operators scrape —
                no privileged side channel): windowed p95 from the
                request-latency histogram deltas, sched queue depth and
                window occupancy, coalesce rate, fleet hashrate, ring
                liveness;
  controller  — a deterministic state machine judging p95 against the SLO
                with hysteresis (consecutive-poll streaks, not single
                samples) and per-action cooldowns. Escalation under
                sustained breach: shed precache admission → add a replica
                → tighten ``fleet_horizon``. De-escalation only after the
                system has DRAINED (queue empty, occupancy low) — a
                scale-down that races in-flight dispatches is the classic
                flapping bug;
  journal     — every decision appended to a replayable JSONL log:
                ``replay()`` re-runs the same controller code over the
                journaled signals and must reproduce the same verdicts, so
                any production decision can be re-judged offline. The file
                format is ``tpu_dpow``'s: a journal of either package
                replays under the other's ``replay``;
  actuator    — the levers: spawn/retire real ``python -m
                tpu_dpow_torch.server`` replica processes (retire = drain
                via the /control/ face, then SIGINT so the replica leaves
                the ring cleanly), and POST horizon/shed to every live
                replica's /control/ face.

``python -m tpu_dpow_torch.autoscale`` runs the poll loop against live
replicas (or ``--replay`` re-judges a journal). The package imports only
the standard library, aiohttp (lazily) and the port's own modules: no
torch, so a process that embeds it opens no CUDA context.
"""

from .config import AutoscaleConfig, parse_args  # noqa: F401
from .controller import Action, SLOController  # noqa: F401
from .journal import DecisionJournal, replay  # noqa: F401
from .signals import MetricsPoller, Signals, signals_from_snapshot  # noqa: F401
