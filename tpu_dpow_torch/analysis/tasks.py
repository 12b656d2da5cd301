"""DPOW301 task-leak: dropped ``create_task`` results are GC-cancellable.

The event loop holds only a weak reference to tasks: a bare-expression
``asyncio.create_task(coro())`` can be garbage-collected — and silently
cancelled — mid-flight (the asyncio docs' own warning). Every spawned task
must be retained (assigned, appended, gathered, awaited) or explicitly
waived with a reason.
"""

from __future__ import annotations

import ast
from typing import List

from .core import Finding, Project, import_aliases, resolve_call

#: checker families this module contributes (aggregated into the registry in __init__.py)
FAMILIES = (("task-leak", ("DPOW301",)),)


CODE = "DPOW301"

_SPAWNERS = {"asyncio.create_task", "asyncio.ensure_future"}


def _is_spawner(node: ast.Call, aliases) -> bool:
    target = resolve_call(node, aliases)
    if target in _SPAWNERS:
        return True
    # loop.create_task(...) / self._loop.create_task(...)
    f = node.func
    return (
        isinstance(f, ast.Attribute)
        and f.attr == "create_task"
        and target is not None
        and target.split(".")[-2:][0] in ("loop", "_loop")
    )


def check(project: Project) -> List[Finding]:
    findings: List[Finding] = []
    for src in project.sources():
        aliases = src.aliases
        for node in src.nodes():
            if (
                isinstance(node, ast.Expr)
                and isinstance(node.value, ast.Call)
                and _is_spawner(node.value, aliases)
            ):
                findings.append(
                    Finding(
                        src.rel,
                        node.lineno,
                        CODE,
                        "task result dropped: an un-retained task is "
                        "GC-cancellable mid-flight — keep a reference "
                        "(self._tasks.append / await / gather)",
                    )
                )
    return findings
