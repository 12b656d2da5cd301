"""FaultSchedule: the deterministic script driving every injected fault.

A schedule is an ordered list of :class:`Rule`s. Each chaos wrapper asks
``decide(op, subject)`` before the real operation — ``op`` names the seam
event ("publish", "deliver", "generate", a store method name, or "*") and
``subject`` is the topic / key / block hash. The FIRST rule that matches
and still has budget fires; exhausted rules fall through so scripts like
"drop the first two publishes, then delay the third" compose naturally.

Determinism: counts (``times``/``after``) are exact, and probabilistic
rules (``prob < 1``) draw from the schedule's own seeded RNG — the same
seed replays the same faults, so a chaos test failure reproduces.

Every fired fault is appended to ``events`` (for assertions and the demo's
printout) and counted in ``dpow_chaos_injected_total{op,action}``.
"""

from __future__ import annotations

import fnmatch
import random
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from .. import obs

# Actions (which wrapper honors which is documented in docs/resilience.md):
DROP = "drop"  # transport: swallow the publish/delivery
DELAY = "delay"  # any seam: clock.sleep(rule.delay) first
DUPLICATE = "duplicate"  # transport: publish/deliver the message twice
REORDER = "reorder"  # transport deliver: hold until after the next message
DISCONNECT = "disconnect"  # transport publish: raise TransportError
ERROR = "error"  # store: ConnectionError; backend: WorkError
HANG = "hang"  # backend: block until cancelled; store: sleep rule.delay
WRONG_WORK = "wrong_work"  # backend: return a nonce that fails validation

ACTIONS = (DROP, DELAY, DUPLICATE, REORDER, DISCONNECT, ERROR, HANG, WRONG_WORK)


@dataclass
class Rule:
    op: str  # seam event this rule applies to, or "*"
    pattern: str = "*"  # fnmatch over the subject (topic, key, hash)
    action: str = DROP
    times: int = 1  # fire at most this many times; -1 = unlimited
    after: int = 0  # let this many matches pass untouched first
    delay: float = 0.0  # seconds, for DELAY (and HANG on stores)
    prob: float = 1.0  # fire chance per eligible match (seeded RNG)
    # bookkeeping (not script inputs)
    seen: int = field(default=0, compare=False)
    fired: int = field(default=0, compare=False)

    def __post_init__(self):
        if self.action not in ACTIONS:
            raise ValueError(f"unknown chaos action {self.action!r}")


class FaultSchedule:
    def __init__(self, rules: Optional[List[Rule]] = None, *, seed: int = 0):
        self.rules: List[Rule] = list(rules or [])
        self.rng = random.Random(seed)
        self.events: List[Tuple[str, str, str]] = []  # (op, subject, action)
        reg = obs.get_registry()
        self._m_injected = reg.counter(
            "dpow_chaos_injected_total",
            "Faults injected by the chaos layer", ("op", "action"))

    def add(self, *rules: Rule) -> "FaultSchedule":
        self.rules.extend(rules)
        return self

    def decide(self, op: str, subject: str) -> Optional[Rule]:
        """The rule to apply to this event, or None to run it clean."""
        for rule in self.rules:
            if rule.op != "*" and rule.op != op:
                continue
            if not fnmatch.fnmatchcase(subject, rule.pattern):
                continue
            if rule.times >= 0 and rule.fired >= rule.times:
                continue  # exhausted: later rules get a shot
            rule.seen += 1
            if rule.seen <= rule.after:
                continue  # still in its pass-through prefix
            if rule.prob < 1.0 and self.rng.random() >= rule.prob:
                return None  # eligible but the dice said no — event is clean
            rule.fired += 1
            self.events.append((op, subject, rule.action))
            self._m_injected.inc(1, op, rule.action)
            return rule
        return None

    def fired(self, action: Optional[str] = None) -> int:
        """How many faults have fired (optionally of one action)."""
        if action is None:
            return len(self.events)
        return sum(1 for _, _, a in self.events if a == action)
