"""DPOW401 lock-across-await: no suspension while holding a threading lock.

``await`` inside ``with <threading.Lock/RLock>`` parks the coroutine with
the lock held: any *thread* (engine executor, to_thread scan) touching the
same lock then blocks for the await's full duration, and a second coroutine
entering the same ``with`` deadlocks the loop outright. The obs registry's
locks stay safe precisely because their critical sections never await
(obs/registry.py design constraints) — this check keeps it that way.

Heuristic receiver match: the context-manager expression is a name/attr
whose last component contains "lock" (``self._lock``, ``registry.lock``).
``async with`` (asyncio.Lock) is exempt by construction.
"""

from __future__ import annotations

import ast
from typing import List

from .core import Finding, Project, dotted_name

#: checker families this module contributes (aggregated into the registry in __init__.py)
FAMILIES = (("lock-across-await", ("DPOW401",)),)


CODE = "DPOW401"


def _lockish(expr: ast.AST) -> bool:
    name = dotted_name(expr)
    if name is None and isinstance(expr, ast.Call):
        name = dotted_name(expr.func)  # with self._make_lock(): …
    return name is not None and "lock" in name.split(".")[-1].lower()


def _awaits_inside(body) -> List[ast.AST]:
    """Await nodes lexically in this block, not crossing into nested defs
    (a nested function's awaits run under its own caller)."""
    found: List[ast.AST] = []

    class V(ast.NodeVisitor):
        def visit_FunctionDef(self, node):  # noqa: D401
            return

        def visit_AsyncFunctionDef(self, node):
            return

        def visit_Await(self, node: ast.Await) -> None:
            found.append(node)
            self.generic_visit(node)

    for stmt in body:
        V().visit(stmt)
    return found


def check(project: Project) -> List[Finding]:
    findings: List[Finding] = []
    for src in project.sources():
        for node in src.nodes():
            if not isinstance(node, ast.With):
                continue
            held = [
                dotted_name(i.context_expr) or "lock"
                for i in node.items
                if _lockish(i.context_expr)
            ]
            if not held:
                continue
            for aw in _awaits_inside(node.body):
                findings.append(
                    Finding(
                        src.rel,
                        aw.lineno,
                        CODE,
                        f"await while holding threading lock '{held[0]}': "
                        "threads block for the await's duration and a "
                        "second coroutine deadlocks the loop",
                    )
                )
    return findings
