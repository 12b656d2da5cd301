"""DPOW201 async-blocking: no synchronous stalls on the event loop.

A blocking call lexically inside ``async def`` freezes every coroutine on
the loop — heartbeats stop, supervisors stall, and a soak flake was
exactly this shape (a multi-second compile hidden on the dispatch path).
Flagged: ``time.sleep``, the ``subprocess`` one-shots, synchronous socket
connection/DNS helpers, ``sqlite3.connect``, ``urllib.request.urlopen``,
and the stores' synchronous checkpoint methods (``*.load/save/sweep`` on a
receiver named ``...store``).

A nested *sync* ``def`` inside an async function is skipped: that is the
idiom for bodies handed to ``asyncio.to_thread`` / ``run_in_executor``.
"""

from __future__ import annotations

import ast
from typing import List

from .core import Finding, Project, dotted_name, import_aliases, resolve_call

#: checker families this module contributes (aggregated into the registry in __init__.py)
FAMILIES = (("async-blocking", ("DPOW201",)),)


CODE = "DPOW201"

_BLOCKING_CALLS = {
    "time.sleep",
    "subprocess.run",
    "subprocess.call",
    "subprocess.check_call",
    "subprocess.check_output",
    "os.system",
    "os.popen",
    "socket.create_connection",
    "socket.getaddrinfo",
    "socket.gethostbyname",
    "sqlite3.connect",
    "urllib.request.urlopen",
}

#: sync Store methods (MemoryStore checkpoint I/O, SqliteStore sweep) —
#: attribute calls on a receiver whose name ends in "store".
_STORE_SYNC_METHODS = {"load", "save", "sweep"}


def _store_sync_call(node: ast.Call) -> bool:
    f = node.func
    if not (isinstance(f, ast.Attribute) and f.attr in _STORE_SYNC_METHODS):
        return False
    base = dotted_name(f.value)
    return base is not None and base.split(".")[-1].lower().endswith("store")


def _calls_outside_nested_sync_defs(fn: ast.AsyncFunctionDef) -> List[ast.Call]:
    """Calls lexically on this async function's own loop path: nested sync
    defs are executor-body idiom and nested async defs are visited as their
    own functions by the outer walk."""
    calls: List[ast.Call] = []

    class V(ast.NodeVisitor):
        def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
            return

        def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
            if node is fn:
                self.generic_visit(node)

        def visit_Call(self, node: ast.Call) -> None:
            calls.append(node)
            self.generic_visit(node)

    V().visit(fn)
    return calls


def check(project: Project) -> List[Finding]:
    findings: List[Finding] = []
    for src in project.sources():
        aliases = src.aliases
        for node in src.nodes():
            if not isinstance(node, ast.AsyncFunctionDef):
                continue
            for call in _calls_outside_nested_sync_defs(node):
                target = resolve_call(call, aliases)
                if target in _BLOCKING_CALLS:
                    what = target
                elif _store_sync_call(call):
                    what = f"sync store method .{call.func.attr}()"
                else:
                    continue
                findings.append(
                    Finding(
                        src.rel,
                        call.lineno,
                        CODE,
                        f"{what} blocks the event loop inside "
                        f"'async def {node.name}' (run it via "
                        "asyncio.to_thread or the engine executor)",
                    )
                )
    return findings
