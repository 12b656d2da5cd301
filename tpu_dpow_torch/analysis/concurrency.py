"""DPOW801-803 — flow-sensitive async race, lock-order and taint checkers.

The dpowlint families before this one are lexical: they judge one
statement at a time. The bug class that actually bit this repo in review
(stale-epoch rewinds, re-cover bookkeeping recorded before its publish
landed, waiter-promotion races) is *interleaving-sensitive* — it lives in
the gap between a check and the act it guards, across an ``await`` where
any other coroutine can run. These checkers see across that gap:

DPOW801 **await-interference** — inside an ``async def``, shared state
(``self.*`` attributes, module-level containers) that is CHECKED, then
MUTATED after an intervening ``await``, without re-validation and without
a lock spanning both, is a check-then-act race candidate. The detection
model (see tpu_dpow_torch/docs/analysis.md for the full write-up):

  * events (guards, awaits, writes) are linearized per function in source
    order, tagged with their if/else branch path so a write in one branch
    is never blamed on an await in the sibling branch;
  * a GUARD is a read of the state in a test position (``if``/``while``/
    ``assert``/ternary tests) or a Compare anywhere (``x in self.d``,
    ``self.d.get(k) is fut``), including through one level of local
    aliasing (``fut = self.d.get(k)`` … ``if fut is None``);
  * a WRITE is a subscript/attribute assignment, ``del``, a mutating
    method call (pop/update/add/…), or a call to a same-class helper that
    performs such a write with no guard of its own (the
    ``_drop_dispatch_state`` idiom is resolved one level deep);
  * the checker fires on the NEAREST guard-before-write pair with an
    unprotected ``await`` strictly between them. Code that re-checks after
    its awaits (the identity-guard idiom used all over server/app.py) is
    clean by construction, because the re-check becomes the nearest guard.
  * ``async with <lock>``/``with <lock>`` scopes are protected: a guard
    and write under the same lock statement never fire.

DPOW802 **lock-order** — every ``with``/``async with`` of a lock-ish
context manager across the repo contributes acquisition edges (outer →
inner, including ``with a, b:`` item order). The checker flags (a) cycles
in the global acquisition graph — a potential deadlock the moment the two
paths run concurrently — and (b) reentrant acquisition of the same lock
identity (``asyncio.Lock`` is not reentrant: the inner acquire deadlocks
its own holder). Lock identity is ``Class.attr`` / ``module:name``; a
lock *factory* call (``self._difficulty_lock(h)``) is one identity with
``()`` appended — nesting two acquisitions from the same factory can be
the same key, which is exactly the self-deadlock case.

DPOW803 **untrusted-input flow** — bytes arriving from transport
callbacks (parameters named ``payload``/``content``) must pass the wire
decode boundary (``wire.decode_*_any`` / the v0 parsers / ``json.loads``)
before reaching ``struct`` unpacks, ``WorkRequest`` construction, or
store keys. The taint model is per-function and syntactic: the parameter
and anything assigned from an expression containing it are tainted;
values returned by a sanctioned decoder are clean; a tainted value
reaching a sink fires. The decoder modules themselves
(``transport/wire.py``, ``transport/mqtt_codec.py``) are the boundary and
are exempt.

All three are stdlib-``ast`` only, run from the same parsed-once Project
sources as every other family, and obey the standard waiver syntax.
Known blind spots are catalogued in tpu_dpow_torch/docs/analysis.md; the runtime half of
the contract — the schedule-perturbing sanitizer that tries to make the
801 candidates actually fail — lives in analysis/sanitizer.py.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from .core import Finding, Project, dotted_name, resolve_call

#: checker families this module contributes (aggregated into the registry in __init__.py)
FAMILIES = (("concurrency", ("DPOW801", "DPOW802", "DPOW803")),)


CODE_INTERFERENCE = "DPOW801"
CODE_LOCK_ORDER = "DPOW802"
CODE_TAINT = "DPOW803"

#: method names that mutate their receiver (dict/set/list/deque surface)
_MUTATORS = {
    "pop", "popleft", "popitem", "setdefault", "update", "add", "remove",
    "discard", "append", "appendleft", "extend", "insert", "clear",
}

#: read-style accessors whose result derives from the receiver (used for
#: the one-level alias tracking: ``fut = self.d.get(k)``)
_READERS = {"get", "items", "keys", "values", "copy"}


def _lockish(expr: ast.AST) -> bool:
    """Same heuristic as DPOW401: the last path component mentions lock."""
    name = dotted_name(expr)
    if name is None and isinstance(expr, ast.Call):
        name = dotted_name(expr.func)
    return name is not None and "lock" in name.split(".")[-1].lower()


def _self_root(expr: ast.AST) -> Optional[str]:
    """``self.a.b`` → "self.a.b" for attribute chains rooted at self/cls."""
    name = dotted_name(expr)
    if name and name.split(".")[0] in ("self", "cls") and "." in name:
        return name
    return None


# ---------------------------------------------------------------------------
# DPOW801 await-interference
# ---------------------------------------------------------------------------

GUARD, AWAIT, WRITE = "guard", "await", "write"


@dataclass
class _Event:
    kind: str
    line: int
    root: Optional[str] = None  # guards/writes
    branch: Tuple[Tuple[int, int], ...] = ()  # ((if_node_id, side), ...)
    locks: frozenset = frozenset()  # ids of enclosing lock With nodes


def _compatible(a: Tuple[Tuple[int, int], ...], b) -> bool:
    """Can both events occur in one execution? Incompatible iff they sit
    in opposite arms of the same ``if``."""
    da = dict(a)
    return all(da.get(nid, side) == side for nid, side in b)


def _terminates(body: List[ast.stmt]) -> bool:
    """Does this suite never fall through? (return/raise/continue/break as
    the last statement, or an if whose both arms terminate)."""
    if not body:
        return False
    last = body[-1]
    if isinstance(last, (ast.Return, ast.Raise, ast.Continue, ast.Break)):
        return True
    if isinstance(last, ast.If):
        return bool(last.orelse) and _terminates(last.body) and _terminates(last.orelse)
    return False


class _FnScan:
    """Linearize one function body into guard/await/write events."""

    def __init__(self, module_roots: Set[str], helpers: Dict[str, Dict[str, bool]]):
        self.module_roots = module_roots  # module-level mutable containers
        #: method name -> {root: may_write_after_an_internal_await}. A
        #: helper whose write lands before its first suspension is atomic
        #: with the call site's guard; one that writes after suspending is
        #: not — the distinction decides whether the call-site WRITE event
        #: lands before or after the call's AWAIT event.
        self.helpers = helpers
        self.events: List[_Event] = []
        self.aliases: Dict[str, str] = {}  # local -> root (x = self.d)
        self.derived: Dict[str, str] = {}  # local -> root (x = self.d.get(k))
        self.branch: List[Tuple[int, int]] = []
        self.locks: List[int] = []

    # -- helpers -------------------------------------------------------

    def _root_of(self, expr: ast.AST) -> Optional[str]:
        """The shared-state root an expression reads/mutates, if any."""
        root = _self_root(expr)
        if root is not None:
            return root
        if isinstance(expr, ast.Name):
            if expr.id in self.aliases:
                return self.aliases[expr.id]
            if expr.id in self.module_roots:
                return expr.id
        return None

    def _emit(self, kind: str, line: int, root: Optional[str] = None) -> None:
        self.events.append(
            _Event(kind, line, root, tuple(self.branch), frozenset(self.locks))
        )

    # -- expression scanning ------------------------------------------

    def _helper_roots(self, node: ast.AST) -> Optional[Dict[str, bool]]:
        """{root: post_await} when ``node`` is a same-class helper call."""
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and isinstance(node.func.value, ast.Name)
            and node.func.value.id in ("self", "cls")
            and node.func.attr in self.helpers
        ):
            return self.helpers[node.func.attr]
        return None

    def _scan_call_children(self, node: ast.Call, in_test: bool) -> None:
        self._scan_expr(node.func.value, in_test)
        for a in node.args:
            self._scan_expr(a, in_test)
        for kw in node.keywords:
            self._scan_expr(kw.value, in_test)

    def _scan_expr(self, node: ast.AST, in_test: bool) -> None:
        """Emit awaits/guards for one expression, approximating source
        order; Compare nodes are guard positions wherever they appear."""
        if node is None:
            return
        if isinstance(node, ast.Await):
            roots = self._helper_roots(node.value)
            if roots is not None:
                # ``await self._helper(...)``: the helper's pre-suspension
                # writes are atomic with whatever guard precedes the call;
                # its post-suspension writes land after the await.
                self._scan_call_children(node.value, in_test)
                for root in sorted(r for r, post in roots.items() if not post):
                    self._emit(WRITE, node.lineno, root)
                self._emit(AWAIT, node.lineno)
                for root in sorted(r for r, post in roots.items() if post):
                    self._emit(WRITE, node.lineno, root)
                return
            self._scan_expr(node.value, in_test)
            self._emit(AWAIT, node.lineno)
            return
        if isinstance(node, ast.Compare):
            for sub in [node.left, *node.comparators]:
                self._scan_expr(sub, True)
            return
        if isinstance(node, ast.IfExp):
            self._scan_expr(node.test, True)
            self._scan_expr(node.body, in_test)
            self._scan_expr(node.orelse, in_test)
            return
        if isinstance(node, ast.Call):
            func = node.func
            # reads like self.d.get(k) inside a test are guards; mutator
            # calls are handled at statement level (they also READ first —
            # emitting the guard here makes ``if self.d.pop(k):`` safe).
            if isinstance(func, ast.Attribute):
                base_root = self._root_of(func.value)
                if base_root is not None and in_test:
                    self._emit(GUARD, node.lineno, base_root)
                self._scan_expr(func.value, in_test)
            else:
                self._scan_expr(func, in_test)
            for a in node.args:
                self._scan_expr(a, in_test)
            for kw in node.keywords:
                self._scan_expr(kw.value, in_test)
            roots = self._helper_roots(node)
            if roots is not None:
                # un-awaited helper call (sync helper): its writes happen
                # synchronously within this statement.
                for root in sorted(roots):
                    self._emit(WRITE, node.lineno, root)
            return
        root = self._root_of(node)
        if root is not None:
            if in_test:
                self._emit(GUARD, node.lineno, root)
            # plain reads outside tests are not events
            if isinstance(node, ast.Attribute):
                return
        if isinstance(node, ast.Name):
            if in_test and node.id in self.derived:
                self._emit(GUARD, node.lineno, self.derived[node.id])
            return
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                continue  # nested scopes run under their own caller
            self._scan_expr(child, in_test)

    # -- write extraction ---------------------------------------------

    def _writes_in(self, stmt: ast.stmt) -> List[Tuple[str, int]]:
        out: List[Tuple[str, int]] = []
        if isinstance(stmt, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = stmt.targets if isinstance(stmt, ast.Assign) else [stmt.target]
            for t in targets:
                if isinstance(t, ast.Tuple):
                    elts = t.elts
                else:
                    elts = [t]
                for el in elts:
                    if isinstance(el, ast.Subscript):
                        root = self._root_of(el.value)
                        if root is not None:
                            out.append((root, el.lineno))
                    elif isinstance(el, ast.Attribute):
                        root = _self_root(el)
                        if root is not None:
                            out.append((root, el.lineno))
        elif isinstance(stmt, ast.Delete):
            for t in stmt.targets:
                if isinstance(t, ast.Subscript):
                    root = self._root_of(t.value)
                elif isinstance(t, ast.Attribute):
                    root = _self_root(t)
                else:
                    root = None
                if root is not None:
                    out.append((root, t.lineno))
        # mutator calls anywhere in the statement (helper calls are
        # emitted by _scan_expr, interleaved with the call's await)
        for node in ast.walk(stmt):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                continue
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if not isinstance(f, ast.Attribute):
                continue
            if f.attr in _MUTATORS:
                root = self._root_of(f.value)
                if root is not None:
                    out.append((root, node.lineno))
        return out

    # -- alias / derived tracking -------------------------------------

    def _track_assign(self, stmt: ast.Assign) -> None:
        if len(stmt.targets) != 1 or not isinstance(stmt.targets[0], ast.Name):
            return
        name = stmt.targets[0].id
        self.aliases.pop(name, None)
        self.derived.pop(name, None)
        value = stmt.value
        direct = _self_root(value)
        if direct is not None:
            self.aliases[name] = direct
            return
        # x = self.d.get(k) / x = self.d[k] / x = k in self.d / x = len(self.d)
        for node in ast.walk(value):
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
                if node.func.attr in _READERS | _MUTATORS:
                    root = self._root_of(node.func.value)
                    if root is not None:
                        self.derived[name] = root
                        return
            elif isinstance(node, (ast.Subscript, ast.Compare)):
                expr = node.value if isinstance(node, ast.Subscript) else None
                candidates = (
                    [expr] if expr is not None
                    else [node.left, *node.comparators]
                )
                for c in candidates:
                    root = self._root_of(c)
                    if root is None and isinstance(c, ast.Name):
                        root = self.derived.get(c.id)
                    if root is not None:
                        self.derived[name] = root
                        return

    # -- statement scanning -------------------------------------------

    def scan_body(self, body: List[ast.stmt]) -> None:
        """Scan a suite. An ``if`` whose taken arm cannot fall through
        (return/raise/continue/break) constrains every LATER statement of
        this suite to the other arm — recorded as a branch entry so an
        await inside the terminated arm is never blamed for a write that
        can only execute when that arm was not taken."""
        pushed = 0
        for stmt in body:
            entry = self._scan_stmt(stmt)
            if entry is not None:
                self.branch.append(entry)
                pushed += 1
        if pushed:
            del self.branch[len(self.branch) - pushed:]

    def _scan_stmt(self, stmt: ast.stmt) -> Optional[Tuple[int, int]]:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            return None
        if isinstance(stmt, ast.If):
            self._scan_expr(stmt.test, True)
            for side, body in ((0, stmt.body), (1, stmt.orelse)):
                self.branch.append((id(stmt), side))
                self.scan_body(body)
                self.branch.pop()
            body_ends = _terminates(stmt.body)
            else_ends = bool(stmt.orelse) and _terminates(stmt.orelse)
            if body_ends and not else_ends:
                return (id(stmt), 1)  # fall-through implies the else arm
            if else_ends and not body_ends:
                return (id(stmt), 0)
            return None
        if isinstance(stmt, ast.While):
            self._scan_expr(stmt.test, True)
            self.scan_body(stmt.body)
            self.scan_body(stmt.orelse)
            # The loop exits through one final test evaluation AFTER the
            # last body iteration: re-emit the test's guards so code after
            # the loop is recognized as re-checked (the pop_random idiom).
            self._scan_expr(stmt.test, True)
            return None
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            self._scan_expr(stmt.iter, False)
            if isinstance(stmt, ast.AsyncFor):
                self._emit(AWAIT, stmt.lineno)
            self.scan_body(stmt.body)
            self.scan_body(stmt.orelse)
            return None
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            lock_items = [i for i in stmt.items if _lockish(i.context_expr)]
            for item in stmt.items:
                self._scan_expr(item.context_expr, False)
            if lock_items and isinstance(stmt, ast.AsyncWith):
                self._emit(AWAIT, stmt.lineno)  # acquiring the lock suspends
            if lock_items:
                self.locks.append(id(stmt))
            self.scan_body(stmt.body)
            if lock_items:
                self.locks.pop()
            return None
        if isinstance(stmt, ast.Try):
            self.scan_body(stmt.body)
            for h in stmt.handlers:
                self.scan_body(h.body)
            self.scan_body(stmt.orelse)
            self.scan_body(stmt.finalbody)
            return None
        if isinstance(stmt, ast.Assert):
            self._scan_expr(stmt.test, True)
            return None
        # simple statement: value-side events, then write events
        if isinstance(stmt, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            self._scan_expr(stmt.value, False)
        elif isinstance(stmt, (ast.Expr, ast.Return)):
            self._scan_expr(stmt.value, False)
        elif isinstance(stmt, ast.Raise):
            self._scan_expr(stmt.exc, False)
        writes = self._writes_in(stmt)
        for root, line in writes:
            self._emit(WRITE, line, root)
        if isinstance(stmt, ast.Assign):
            self._track_assign(stmt)
        return None


def _module_container_roots(tree: ast.Module) -> Set[str]:
    """Module-level names bound to mutable container literals — shared
    state for every coroutine importing the module."""
    out: Set[str] = set()
    for node in tree.body:
        if (
            isinstance(node, ast.Assign)
            and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
            and isinstance(node.value, (ast.Dict, ast.List, ast.Set, ast.DictComp))
        ):
            out.add(node.targets[0].id)
    return out


def _nearest_guard_idx(events: List[_Event], i: int) -> Optional[int]:
    """Index of the nearest preceding same-root, branch-compatible guard
    for the WRITE at ``events[i]`` — the guard a re-check-after-await
    idiom contributes, which is why NEAREST is the one that matters."""
    ev = events[i]
    for j in range(i - 1, -1, -1):
        g = events[j]
        if g.kind == GUARD and g.root == ev.root and _compatible(
            g.branch, ev.branch
        ):
            return j
    return None


def _await_in_gap(
    events: List[_Event], guard_idx: int, i: int
) -> Optional[int]:
    """Line of an unprotected await strictly between guard and write, or
    None when the pair is safe (shared lock statement, or no suspension
    point in the gap). One predicate for both the direct check and the
    helper-write table, so the race rule cannot drift between them."""
    g, ev = events[guard_idx], events[i]
    if g.locks & ev.locks:
        return None  # guard and write under one lock statement
    for j in range(guard_idx + 1, i):
        a = events[j]
        if a.kind == AWAIT and _compatible(a.branch, ev.branch):
            return a.line
    return None


def _race_for_write(
    events: List[_Event], i: int
) -> Optional[Tuple[_Event, int]]:
    """For the WRITE at ``events[i]``: (nearest guard, await line) when the
    guard-await-write pattern holds unprotected, else None. None also for
    blind writes (no guard at all: not a check-then-act) and for pairs
    protected by a shared lock statement."""
    guard_idx = _nearest_guard_idx(events, i)
    if guard_idx is None:
        return None
    await_line = _await_in_gap(events, guard_idx, i)
    if await_line is None:
        return None
    return events[guard_idx], await_line


def _unguarded_helper_writes(
    fn, module_roots: Set[str]
) -> Dict[str, bool]:
    """Roots a helper mutates with NO same-root guard covering the write
    (the writes a call site must guard itself) → whether the write can
    land AFTER one of the helper's own awaits (post-suspension)."""
    scan = _FnScan(module_roots, {})
    scan.scan_body(fn.body)
    unguarded: Dict[str, bool] = {}
    for i, ev in enumerate(scan.events):
        if ev.kind != WRITE or ev.root is None:
            continue
        guard_idx = _nearest_guard_idx(scan.events, i)
        if guard_idx is not None and _await_in_gap(
            scan.events, guard_idx, i
        ) is None:
            continue  # guarded: lock-protected or no await in the gap
        post = any(
            e.kind == AWAIT and _compatible(e.branch, ev.branch)
            for e in scan.events[:i]
        )
        unguarded[ev.root] = unguarded.get(ev.root, False) or post
    return unguarded


def _called_helper_names(fn: ast.AsyncFunctionDef) -> Set[str]:
    """Names invoked as ``self.X(...)``/``cls.X(...)`` inside ``fn`` — the
    only methods whose write-sets the one-level resolution needs."""
    out: Set[str] = set()
    for node in ast.walk(fn):
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and isinstance(node.func.value, ast.Name)
            and node.func.value.id in ("self", "cls")
        ):
            out.add(node.func.attr)
    return out


def _class_helper_tables(
    classes: List[ast.ClassDef],
    wanted: Set[str],
    module_roots: Set[str],
) -> Dict[int, Dict[str, Dict[str, bool]]]:
    """Per ClassDef (by id): method name → unguarded roots it writes.
    Only methods in ``wanted`` (those some async def actually calls) are
    analyzed — the rest can never contribute call-site writes."""
    tables: Dict[int, Dict[str, Dict[str, bool]]] = {}
    for node in classes:
        table: Dict[str, Dict[str, bool]] = {}
        for stmt in node.body:
            if (
                isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef))
                and stmt.name in wanted
            ):
                roots = _unguarded_helper_writes(stmt, module_roots)
                if roots:
                    table[stmt.name] = roots
        tables[id(node)] = table
    return tables


def check_interference(project: Project) -> List[Finding]:
    findings: List[Finding] = []
    for src in project.sources():
        if "async def" not in src.text:
            continue  # 801 events only exist inside async defs
        async_defs = [
            n for n in src.nodes() if isinstance(n, ast.AsyncFunctionDef)
        ]
        if not async_defs:
            continue
        module_roots = _module_container_roots(src.tree)
        classes = [n for n in src.nodes() if isinstance(n, ast.ClassDef)]
        wanted: Set[str] = set()
        for fn in async_defs:
            wanted |= _called_helper_names(fn)
        helper_tables = _class_helper_tables(classes, wanted, module_roots)
        # map each async def to its enclosing class (if any)
        enclosing: Dict[int, int] = {}
        for node in classes:
            for stmt in node.body:
                if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    enclosing[id(stmt)] = id(node)
        for node in async_defs:
            helpers = helper_tables.get(enclosing.get(id(node), -1), {})
            # the function's own writes must not resolve through itself
            helpers = {k: v for k, v in helpers.items() if k != node.name}
            scan = _FnScan(module_roots, helpers)
            scan.scan_body(node.body)
            seen: Set[Tuple[str, int]] = set()
            for i, ev in enumerate(scan.events):
                if ev.kind != WRITE or ev.root is None:
                    continue
                race = _race_for_write(scan.events, i)
                if race is None:
                    continue
                g, await_line = race
                key = (ev.root, ev.line)
                if key in seen:
                    continue
                seen.add(key)
                findings.append(
                    Finding(
                        src.rel,
                        ev.line,
                        CODE_INTERFERENCE,
                        f"'{ev.root}' is checked (line {g.line}) and then "
                        f"mutated here, but an await on line {await_line} "
                        "sits between: another coroutine can change it "
                        "mid-gap — re-check after the await or hold one "
                        "asyncio.Lock across both",
                    )
                )
    return findings


# ---------------------------------------------------------------------------
# DPOW802 lock-order
# ---------------------------------------------------------------------------


@dataclass
class _LockSite:
    lock_id: str
    path: str
    line: int


def _lock_identity(expr: ast.AST, class_name: str, module: str) -> Optional[str]:
    """Stable name for the lock object a with-item acquires."""
    if isinstance(expr, ast.Call):
        name = dotted_name(expr.func)
        if name is None or "lock" not in name.split(".")[-1].lower():
            return None
        suffix = "()"
    else:
        name = dotted_name(expr)
        if name is None or "lock" not in name.split(".")[-1].lower():
            return None
        suffix = ""
    parts = name.split(".")
    if parts[0] in ("self", "cls"):
        return f"{class_name}.{'.'.join(parts[1:])}{suffix}"
    return f"{module}:{name}{suffix}"


class _LockNestScan(ast.NodeVisitor):
    """Collect acquisition edges (held → acquired) within one function."""

    def __init__(self, class_name: str, module: str, path: str):
        self.class_name = class_name
        self.module = module
        self.path = path
        self.stack: List[_LockSite] = []
        self.edges: List[Tuple[_LockSite, _LockSite]] = []

    def visit_FunctionDef(self, node):  # nested defs: own scope
        return

    def visit_AsyncFunctionDef(self, node):
        return

    def _visit_with(self, node) -> None:
        acquired: List[_LockSite] = []
        for item in node.items:
            lock_id = _lock_identity(item.context_expr, self.class_name, self.module)
            if lock_id is None:
                continue
            site = _LockSite(lock_id, self.path, item.context_expr.lineno)
            for held in self.stack + acquired:
                self.edges.append((held, site))
            acquired.append(site)
        self.stack.extend(acquired)
        for stmt in node.body:
            self.visit(stmt)
        del self.stack[len(self.stack) - len(acquired):]

    def visit_With(self, node):
        self._visit_with(node)

    def visit_AsyncWith(self, node):
        self._visit_with(node)


def _function_class_map(src) -> Dict[int, str]:
    out: Dict[int, str] = {}
    for node in src.nodes():
        if isinstance(node, ast.ClassDef):
            for sub in ast.walk(node):
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    out[id(sub)] = node.name
    return out


def check_lock_order(project: Project) -> List[Finding]:
    findings: List[Finding] = []
    #: acquisition graph over lock ids: edge -> first site that created it
    edges: Dict[Tuple[str, str], _LockSite] = {}
    for src in project.sources():
        if "lock" not in src.text.lower():
            continue  # _lock_identity only matches lock-ish names
        module = src.rel.rsplit("/", 1)[-1].removesuffix(".py")
        class_of = _function_class_map(src)
        for node in src.nodes():
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            scan = _LockNestScan(class_of.get(id(node), module), module, src.rel)
            for stmt in node.body:
                scan.visit(stmt)
            for held, acq in scan.edges:
                if held.lock_id == acq.lock_id:
                    findings.append(
                        Finding(
                            src.rel,
                            acq.line,
                            CODE_LOCK_ORDER,
                            f"reentrant acquisition of '{acq.lock_id}' "
                            f"(already held since line {held.line}): "
                            "asyncio/threading locks are not reentrant — "
                            "the inner acquire deadlocks its own holder",
                        )
                    )
                    continue
                edges.setdefault((held.lock_id, acq.lock_id), acq)
    # cycle detection over the global digraph
    graph: Dict[str, List[str]] = {}
    for a, b in edges:
        graph.setdefault(a, []).append(b)
    reported: Set[frozenset] = set()

    def dfs(start: str, node: str, path: List[str]) -> None:
        for nxt in sorted(graph.get(node, ())):
            if nxt == start and len(path) > 1:
                cycle = frozenset(path)
                if cycle in reported:
                    continue
                reported.add(cycle)
                site = edges[(path[-1], start)]
                findings.append(
                    Finding(
                        site.path,
                        site.line,
                        CODE_LOCK_ORDER,
                        "lock-order cycle "
                        + " -> ".join(path + [start])
                        + ": two tasks taking these locks in opposite "
                        "orders deadlock — impose one global acquisition "
                        "order",
                    )
                )
            elif nxt not in path and nxt != start:
                dfs(start, nxt, path + [nxt])

    for start in sorted(graph):
        dfs(start, start, [start])
    return findings


# ---------------------------------------------------------------------------
# DPOW803 untrusted-input flow
# ---------------------------------------------------------------------------

#: parameters that carry raw transport bytes into a callback
_TAINT_PARAMS = {"payload", "content"}

#: the decode boundary: calls whose RESULT is trusted even for tainted args
_SANCTIONED = {
    "decode_work_any", "decode_result_any", "decode_work_frame",
    "decode_result_frame", "parse_work_payload", "parse_result_payload",
    "wire_version", "loads",  # json.loads: parse + field validation idiom
}

#: modules that ARE the boundary (they may struct-unpack raw payloads)
_BOUNDARY_MODULES = (
    "transport/wire.py",
    "transport/mqtt_codec.py",
)

_STRUCT_SINKS = {"unpack", "unpack_from", "iter_unpack"}


def _is_sanctioned(call: ast.Call, aliases: Dict[str, str]) -> bool:
    target = resolve_call(call, aliases) or ""
    return target.split(".")[-1] in _SANCTIONED


def _tainted_names(expr: ast.AST, tainted: Set[str], aliases) -> Set[str]:
    """Tainted names referenced by ``expr``, ignoring sub-expressions whose
    value passed a sanctioned decoder."""
    found: Set[str] = set()

    def walk(node: ast.AST) -> None:
        if isinstance(node, ast.Call) and _is_sanctioned(node, aliases):
            return  # its result is clean regardless of arguments
        if isinstance(node, ast.Name) and node.id in tainted:
            found.add(node.id)
        for child in ast.iter_child_nodes(node):
            walk(child)

    walk(expr)
    return found


def check_taint(project: Project) -> List[Finding]:
    findings: List[Finding] = []
    for src in project.sources():
        if any(src.rel.endswith(m) for m in _BOUNDARY_MODULES):
            continue
        aliases = src.aliases
        for fn in src.nodes():
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            params = {
                a.arg for a in fn.args.args + fn.args.kwonlyargs
            } & _TAINT_PARAMS
            if not params:
                continue
            tainted: Set[str] = set(params)
            for node in ast.walk(fn):
                if isinstance(node, ast.Assign):
                    hit = _tainted_names(node.value, tainted, aliases)
                    for t in node.targets:
                        names = (
                            [t] if isinstance(t, ast.Name)
                            else [e for e in getattr(t, "elts", [])
                                  if isinstance(e, ast.Name)]
                        )
                        for n in names:
                            if hit:
                                tainted.add(n.id)
                            else:
                                tainted.discard(n.id)
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                f = node.func
                sink = None
                if isinstance(f, ast.Attribute) and f.attr in _STRUCT_SINKS:
                    target = resolve_call(node, aliases) or ""
                    base = dotted_name(f.value) or ""
                    if target.startswith("struct.") or base.endswith("struct") \
                            or base.startswith("_U"):
                        sink = f"struct.{f.attr}"
                elif (dotted_name(f) or "").split(".")[-1] == "WorkRequest":
                    sink = "WorkRequest()"
                elif (
                    isinstance(f, ast.Attribute)
                    and (dotted_name(f.value) or "").split(".")[-1] == "store"
                ):
                    sink = f"store.{f.attr}()"
                if sink is None:
                    continue
                hit: Set[str] = set()
                for arg in list(node.args) + [k.value for k in node.keywords]:
                    hit |= _tainted_names(arg, tainted, aliases)
                if hit:
                    findings.append(
                        Finding(
                            src.rel,
                            node.lineno,
                            CODE_TAINT,
                            f"raw transport payload ({', '.join(sorted(hit))}) "
                            f"reaches {sink} without passing the wire decode "
                            "boundary (wire.decode_*_any / the v0 parsers) — "
                            "parse and validate before consuming",
                        )
                    )
    return findings


def check(project: Project) -> List[Finding]:
    return (
        check_interference(project)
        + check_lock_order(project)
        + check_taint(project)
    )
