"""The SLO controller: a deterministic state machine over Signals rows.

Design rules, each with a test pinning it (tests/test_torch_autoscale.py holds
this controller against ``tpu_dpow``'s, action for action):

  * HYSTERESIS — nothing moves on one sample. A breach must persist for
    ``slo_breach_polls`` consecutive polls before the controller
    escalates, a clear for ``slo_clear_polls`` before it de-escalates,
    and between ``slo_clear_factor * slo`` and ``slo`` the controller
    holds position (the dead band). A p95 oscillating across the SLO
    line produces zero actions.
  * COOLDOWN — after any action the controller is silent for
    ``slo_cooldown`` seconds: the system gets time to show the action's
    effect before the next one (no scale-up staircases inside one
    breach confirmation).
  * QUEUE IS A BREACH TOO — under hard overload completions stall, so
    the p95 of what *did* complete flatters the system; an admission
    queue deeper than ``slo_queue_high`` counts as breaching on its own.
  * SCALE-DOWN ONLY AFTER DRAIN — de-escalation additionally requires
    zero queued work and window occupancy ≤ ``slo_drain_occupancy``.
    Retiring a replica that still holds in-flight dispatches hands its
    work to the takeover path mid-flight for no reason.
  * DETERMINISM — ``decide()`` reads nothing but (config, internal
    state, the Signals row). No clocks, no randomness, no I/O. That is
    what makes the decision journal REPLAYABLE: the same journal through
    a fresh controller reproduces the same verdicts, so any production
    decision can be re-judged offline (journal.replay pins this).

Escalation order under sustained breach (cheapest lever first):
shed precache admission → add a replica → tighten fleet_horizon.
De-escalation reverses it: restore horizon → re-open precache → retire
replicas one at a time, each behind its own drain check + cooldown.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from .. import obs
from .config import AutoscaleConfig
from .signals import Signals

#: action kinds (the actuator's vocabulary)
SCALE_UP = "scale_up"
SCALE_DOWN = "scale_down"
SHED_ON = "shed_precache_on"
SHED_OFF = "shed_precache_off"
SET_HORIZON = "set_horizon"


@dataclass(frozen=True)
class Action:
    kind: str
    value: Optional[float] = None
    reason: str = ""

    def to_dict(self) -> dict:
        return {"kind": self.kind, "value": self.value, "reason": self.reason}

    @classmethod
    def from_dict(cls, d: dict) -> "Action":
        return cls(d["kind"], d.get("value"), d.get("reason", ""))


class SLOController:
    def __init__(self, config: AutoscaleConfig, *, initial_replicas: Optional[int] = None):
        self.cfg = config
        self.replicas_target = (
            initial_replicas
            if initial_replicas is not None
            else config.slo_min_replicas
        )
        self.shed = False
        self.horizon = config.slo_calm_horizon
        self.breach_streak = 0
        self.clear_streak = 0
        self.cooldown_until = -float("inf")
        self.decisions = 0
        reg = obs.get_registry()
        self._m_decisions = reg.counter(
            "dpow_autoscale_decisions_total",
            "Controller actions emitted, by kind", ("kind",))
        self._m_p95 = reg.gauge(
            "dpow_autoscale_p95_seconds",
            "Windowed p95 the controller last judged (-1 = no data)")
        self._m_target = reg.gauge(
            "dpow_autoscale_replicas_target",
            "Replica count the controller currently wants")
        self._m_state = reg.gauge(
            "dpow_autoscale_state",
            "Controller posture: breach streak (+) or clear streak (-)")
        self._m_target.set(float(self.replicas_target))

    # -- state serialization (journal) ---------------------------------

    def state_dict(self) -> dict:
        return {
            "replicas_target": self.replicas_target,
            "shed": self.shed,
            "horizon": self.horizon,
            "breach_streak": self.breach_streak,
            "clear_streak": self.clear_streak,
            "cooldown_until": (
                self.cooldown_until
                if self.cooldown_until != -float("inf")
                else None
            ),
        }

    # -- classification -------------------------------------------------

    def _classify(self, s: Signals) -> str:
        """breach / clear / hold for one row."""
        cfg = self.cfg
        slo_s = cfg.slo_p95_ms / 1e3
        if s.queue_depth > cfg.slo_queue_high:
            return "breach"
        if s.p95_s is None:
            # nothing completed: healthy-idle iff nothing is queued either
            return "clear" if s.queue_depth == 0 and s.inflight == 0 else "hold"
        if s.p95_s > slo_s:
            return "breach"
        if s.p95_s <= slo_s * cfg.slo_clear_factor and s.queue_depth == 0:
            return "clear"
        return "hold"

    def _drained(self, s: Signals) -> bool:
        if s.queue_depth > 0:
            return False
        occ = s.occupancy
        if occ is None:
            # unbounded window: judge drain on raw inflight vs nothing
            return s.inflight == 0
        return occ <= self.cfg.slo_drain_occupancy

    # -- the decision ----------------------------------------------------

    def decide(self, s: Signals) -> List[Action]:
        cfg = self.cfg
        verdict = self._classify(s)
        if verdict == "breach":
            self.breach_streak += 1
            self.clear_streak = 0
        elif verdict == "clear":
            self.clear_streak += 1
            self.breach_streak = 0
        else:
            self.breach_streak = 0
            self.clear_streak = 0
        self._m_p95.set(s.p95_s if s.p95_s is not None else -1.0)
        self._m_state.set(float(self.breach_streak - self.clear_streak))

        actions: List[Action] = []
        if s.t < self.cooldown_until:
            return actions

        if self.breach_streak >= cfg.slo_breach_polls:
            actions = self._escalate(s)
        elif self.clear_streak >= cfg.slo_clear_polls:
            actions = self._deescalate(s)
        if actions:
            self.cooldown_until = s.t + cfg.slo_cooldown
            self.decisions += len(actions)
            for a in actions:
                self._m_decisions.inc(1, a.kind)
            self._m_target.set(float(self.replicas_target))
            # an action resets both streaks: the next confirmation must
            # be re-earned against the post-action system
            self.breach_streak = 0
            self.clear_streak = 0
        return actions

    def _escalate(self, s: Signals) -> List[Action]:
        cfg = self.cfg
        why = (
            f"p95={s.p95_s * 1e3:.0f}ms" if s.p95_s is not None else "p95=n/a"
        ) + f" queue={s.queue_depth:.0f} for {self.breach_streak} polls"
        if not self.shed and not cfg.slo_no_shed:
            self.shed = True
            return [Action(SHED_ON, reason=f"breach ({why}): shed precache first")]
        if self.replicas_target < cfg.slo_max_replicas:
            self.replicas_target += 1
            return [Action(
                SCALE_UP, value=float(self.replicas_target),
                reason=f"breach ({why}): add replica "
                f"-> {self.replicas_target}",
            )]
        if (
            cfg.slo_pressure_horizon > 0
            and self.horizon != cfg.slo_pressure_horizon
        ):
            self.horizon = cfg.slo_pressure_horizon
            return [Action(
                SET_HORIZON, value=self.horizon,
                reason=f"breach ({why}) at max replicas: right-size "
                f"dispatches to {self.horizon}s",
            )]
        return []  # every lever is already pulled

    def _deescalate(self, s: Signals) -> List[Action]:
        cfg = self.cfg
        why = (
            f"p95={s.p95_s * 1e3:.0f}ms" if s.p95_s is not None else "idle"
        ) + f" for {self.clear_streak} polls"
        if cfg.slo_pressure_horizon > 0 and self.horizon != cfg.slo_calm_horizon:
            self.horizon = cfg.slo_calm_horizon
            return [Action(
                SET_HORIZON, value=self.horizon,
                reason=f"clear ({why}): restore horizon",
            )]
        if self.shed:
            self.shed = False
            return [Action(SHED_OFF, reason=f"clear ({why}): re-open precache")]
        if self.replicas_target > cfg.slo_min_replicas:
            if not self._drained(s):
                # clear p95 but the window still holds work: retiring a
                # replica now would orphan in-flight dispatches — wait
                return []
            self.replicas_target -= 1
            occ = (
                f"{s.occupancy:.2f}" if s.occupancy is not None else "n/a"
            )
            return [Action(
                SCALE_DOWN, value=float(self.replicas_target),
                reason=f"clear ({why}) and drained (queue=0, occ={occ}): "
                f"retire -> {self.replicas_target}",
            )]
        return []
