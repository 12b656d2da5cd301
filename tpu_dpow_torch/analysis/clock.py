"""DPOW101 clock-discipline: timers must ride the injectable Clock.

FakeClock chaos tests only cover code that reads time and sleeps through
``resilience.Clock``. A direct ``time.time()`` / ``time.monotonic()`` /
``loop.time()`` / ``asyncio.sleep()`` / ``time.sleep()`` silently exempts
its whole path from every deterministic-time test, so each one outside the
Clock seam itself and the allowlist below is a finding.

``asyncio.sleep(0)`` (the literal) is a cooperative yield, not a timer,
and is always allowed.
"""

from __future__ import annotations

import ast
from typing import List

from .core import Finding, Project, dotted_name, resolve_call

#: checker families this module contributes (aggregated into the registry in __init__.py)
FAMILIES = (("clock-discipline", ("DPOW101",)),)


CODE = "DPOW101"

#: path-prefix allowlist, relative to ``project.package_dir`` so that one
#: table serves ``tpu_dpow`` and its port alike, with the justification the
#: catalogue (tpu_dpow_torch/docs/analysis.md) repeats. Everything else uses inline
#: ``# dpowlint: disable=DPOW101 — why`` waivers.
ALLOWLIST = {
    "resilience/clock.py": "the Clock seam itself wraps these calls",
    "scripts/": "operator CLI tools probe the live system on wall "
    "clock by definition (no FakeClock can drive a real broker)",
    "obs/trace.py": "trace stamps are wall-clock so one span can "
    "cross process boundaries (module docstring)",
    "store/sqlite_store.py": "TTL deadlines persist to disk as "
    "wall-clock epochs; monotonic time would not survive a restart",
}

_BANNED_CALLS = {
    "time.time": "time.time()",
    "time.monotonic": "time.monotonic()",
    "time.sleep": "time.sleep()",
    "asyncio.sleep": "asyncio.sleep()",
}


def _is_loop_time(node: ast.Call) -> bool:
    """``loop.time()`` / ``self._loop.time()`` — the event-loop clock."""
    f = node.func
    if not (isinstance(f, ast.Attribute) and f.attr == "time"):
        return False
    base = dotted_name(f.value)
    return base is not None and base.split(".")[-1] in ("loop", "_loop")


def check(project: Project) -> List[Finding]:
    findings: List[Finding] = []
    pkg = project.package_dir.rstrip("/") + "/"
    for src in project.sources():
        if any(src.rel.startswith(pkg + p) for p in ALLOWLIST):
            continue
        aliases = src.aliases
        for node in src.nodes():
            if not isinstance(node, ast.Call):
                continue
            target = resolve_call(node, aliases)
            label = _BANNED_CALLS.get(target or "")
            if label == "asyncio.sleep()" and node.args:
                arg = node.args[0]
                if isinstance(arg, ast.Constant) and arg.value == 0:
                    continue  # a yield, not a timer
            if label is None and _is_loop_time(node):
                label = "loop.time()"
            if label is not None:
                findings.append(
                    Finding(
                        src.rel,
                        node.lineno,
                        CODE,
                        f"{label} bypasses the injectable resilience.Clock "
                        "(FakeClock tests cannot drive this timer)",
                    )
                )
    return findings
