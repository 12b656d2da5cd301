"""The decision journal: every controller verdict, replayable offline.

JSONL, append-only. Line 1 is a header carrying the controller config and
the initial state; every subsequent line is one poll:

    {"meta": {"config": {...}, "initial": {...}, "version": 1}}
    {"seq": 0, "t": 12.0, "signals": {...}, "actions": [...], "state": {...}}

``signals`` is the full Signals row the controller judged, ``actions``
what it decided, ``state`` the controller state AFTER the decision.
Because ``SLOController.decide`` is deterministic (no clock, no RNG, no
I/O — controller.py module docstring), :func:`replay` can rebuild the
controller from the header and re-run every journaled row: the journal
is self-verifying. A mismatch means the journal was edited, the
controller code changed since the run, or determinism broke — each of
which an operator wants to KNOW before trusting an incident review.

The format is ``tpu_dpow.autoscale.journal``'s: a journal written by either
package replays under the other's :func:`replay`
(tests/test_torch_autoscale.py pins both directions).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import IO, Iterable, List, Optional, Union

from .config import AutoscaleConfig, config_dict
from .controller import Action, SLOController
from .signals import Signals

VERSION = 1


class DecisionJournal:
    """Writer: header on open, one line per recorded poll, flushed per
    line (a crashed autoscaler must leave a usable journal). A path is
    TRUNCATED on open — one journal file is one run; appending a second
    header would corrupt replay at the seam."""

    def __init__(self, path_or_fp: Union[str, IO[str]], config: AutoscaleConfig,
                 *, initial_state: Optional[dict] = None):
        if isinstance(path_or_fp, str):
            self._fp: IO[str] = open(path_or_fp, "w", encoding="utf-8")
            self._owns = True
        else:
            self._fp = path_or_fp
            self._owns = False
        self.seq = 0
        self._fp.write(json.dumps({
            "meta": {
                "version": VERSION,
                "config": config_dict(config),
                "initial": initial_state or {},
            }
        }) + "\n")
        self._fp.flush()

    def record(self, signals: Signals, actions: List[Action], state: dict) -> None:
        self._fp.write(json.dumps({
            "seq": self.seq,
            "t": signals.t,
            "signals": signals.to_dict(),
            "actions": [a.to_dict() for a in actions],
            "state": state,
        }) + "\n")
        self._fp.flush()
        self.seq += 1

    def close(self) -> None:
        if self._owns:
            self._fp.close()


# ---------------------------------------------------------------------------
# offline replay
# ---------------------------------------------------------------------------


@dataclass
class ReplayReport:
    entries: int = 0
    actions_journaled: int = 0
    actions_replayed: int = 0
    mismatches: List[dict] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.mismatches

    def render(self) -> str:
        if self.ok:
            return (
                f"replay: OK — {self.entries} entries, "
                f"{self.actions_journaled} action(s) reproduced exactly"
            )
        lines = [
            f"replay: {len(self.mismatches)} MISMATCH(ES) over "
            f"{self.entries} entries — the journal does not reproduce "
            "(edited journal, changed controller code, or broken determinism)"
        ]
        for m in self.mismatches[:10]:
            lines.append(
                f"  seq={m['seq']} t={m['t']}: journaled {m['journaled']} "
                f"!= replayed {m['replayed']}"
            )
        return "\n".join(lines)


def replay(source: Union[str, IO[str], Iterable[str]]) -> ReplayReport:
    """Re-judge a journal: rebuild the controller from the header, feed it
    the journaled signals, compare every decision."""
    if isinstance(source, str):
        with open(source, encoding="utf-8") as f:
            lines = f.read().splitlines()
    elif hasattr(source, "read"):
        lines = source.read().splitlines()
    else:
        lines = list(source)
    it = iter(ln for ln in lines if ln.strip())
    try:
        header = json.loads(next(it))
    except StopIteration:
        raise ValueError("empty journal") from None
    meta = header.get("meta")
    if not isinstance(meta, dict):
        raise ValueError("journal line 1 is not a meta header")
    cfg = AutoscaleConfig(**meta.get("config", {}))
    initial = meta.get("initial") or {}
    controller = SLOController(
        cfg, initial_replicas=initial.get("replicas_target")
    )
    if "shed" in initial:
        controller.shed = bool(initial["shed"])
    if "horizon" in initial:
        controller.horizon = float(initial["horizon"])
    # a journal can open mid-streak or mid-cooldown (runtime rotation):
    # the FULL recorded state seeds the replay, or the first polls would
    # re-judge differently and report a phantom mismatch
    controller.breach_streak = int(initial.get("breach_streak", 0) or 0)
    controller.clear_streak = int(initial.get("clear_streak", 0) or 0)
    cooldown = initial.get("cooldown_until")
    if cooldown is not None:
        controller.cooldown_until = float(cooldown)
    report = ReplayReport()
    for line in it:
        entry = json.loads(line)
        signals = Signals.from_dict(entry["signals"])
        journaled = entry.get("actions", [])
        replayed = [a.to_dict() for a in controller.decide(signals)]
        report.entries += 1
        report.actions_journaled += len(journaled)
        report.actions_replayed += len(replayed)
        # verdict identity = same kinds and values in the same order
        # (reasons are prose; they ride along but don't gate)
        j = [(a["kind"], a.get("value")) for a in journaled]
        r = [(a["kind"], a.get("value")) for a in replayed]
        if j != r:
            report.mismatches.append({
                "seq": entry.get("seq"),
                "t": entry.get("t"),
                "journaled": j,
                "replayed": r,
            })
    return report
