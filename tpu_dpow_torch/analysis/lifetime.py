"""DPOW1101-1104 resource-lifetime: acquire/release ownership discipline.

Nearly every hot path in this codebase holds a revocable resource — an
admission ticket, a precache lease, a control slot, an adoption claim, a
coalesce gate/future, a forward-origin entry, a retained background task
— and the most recurring bug class of the project
is "acquire → await → exception/cancel path leaks it" (the
promote-window ticket leak, the forward-origin leak, the slot-release
race, the retire-before-future-install strand). This module encodes the
ownership rules those fixes converged on:

  * DPOW1101 — release-on-all-paths: a bound acquire must be dominated
    by a release on EVERY exit, including the cancellation paths an
    ``await`` interposes. Accepted protections: the acquire sits inside
    a ``try`` whose ``finally`` (or full exception-handler set) releases
    the handle — one-level helper resolution like DPOW801, identity
    guards included — or the handle reaches a release, a declared
    ownership transfer, or a ``return`` with NO await in between;
  * DPOW1102 — ownership-transfer: a handle handed to another owner
    must be recorded at the transfer site (stored into a transfer table
    declared in RESOURCE_TABLE, then neutralized in the very next
    statement) — else both or neither own it, and the old owner's
    releasing path double-frees or leaks;
  * DPOW1103 — double-release / use-after-release: a released handle
    reaching a second release, or any other call, on the same
    straight-line path without a reassignment in between;
  * DPOW1104 — the "Resource ownership" table in docs/resilience.md
    must mirror RESOURCE_TABLE, both directions (DPOW501-style): kinds,
    acquire/release shapes and coverage column.

RESOURCE_TABLE is the single declaration point: each kind's acquire /
release / transfer call shapes, and whether the flow-sensitive families
apply ("static+ledger") or the kind is dict-shaped and only the runtime
LeakLedger (obs/ledger.py) sees it ("ledger" — the documented static
blind spot: gate/future/origin/bgtask installs are plain dict stores
with no handle-shaped call to anchor flow analysis on). Leases are
static-checked for 1102/1103 but exempt from 1101: a granted precache
lease LAPSES after ``--precache_lease`` seconds by design (the sweep in
sched/window.py is the release of last resort), so "no release on some
path" is not a leak there.

Runtime confirmation: the LeakLedger registers every acquire and
discharge at the seams these shapes name; dpowsan asserts zero
outstanding at scenario teardown and folds verdicts onto DPOW1101
findings as confirmed / not-reproduced / unexercised, exactly like
DPOW801 (analysis/sanitizer.py).
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .core import Finding, Project, dotted_name
from .tracing import own_nodes

#: checker families this module contributes (aggregated in __init__.py)
FAMILIES = (
    ("lifetime", ("DPOW1101", "DPOW1102", "DPOW1103", "DPOW1104")),
)

CODE_RELEASE = "DPOW1101"
CODE_TRANSFER = "DPOW1102"
CODE_DOUBLE = "DPOW1103"
CODE_DOC = "DPOW1104"

#: the documented coverage labels (the doc-table's coverage column must
#: match the declaration verbatim)
COVER_STATIC = "static+ledger"
COVER_LEDGER = "ledger"


@dataclass(frozen=True)
class Resource:
    """One revocable resource kind and its lifecycle call shapes."""

    kind: str
    #: call tail names that mint a handle (``x = [await] shape(...)``)
    acquire: Tuple[str, ...] = ()
    #: attribute bases the acquire must hang off ("" entry = any base);
    #: a bare-name call resolves through import aliases instead
    acquire_bases: Tuple[str, ...] = ()
    #: call tail names that retire a handle (the handle is an argument)
    release: Tuple[str, ...] = ()
    #: call tail names that retire by KEY (no handle argument needed)
    keyed_release: Tuple[str, ...] = ()
    #: ``self.<table>[...] = handle`` targets that take ownership
    transfer_stores: Tuple[str, ...] = ()
    #: callables a handle may be handed to (argument/keyword position)
    transfer_calls: Tuple[str, ...] = ()
    #: DPOW1101 applies (False = lapse-backstopped or dict-shaped)
    all_paths: bool = False
    #: "static+ledger" or "ledger" — mirrored in docs/resilience.md
    coverage: str = COVER_LEDGER
    #: one-line ownership story (the doc row's meaning column)
    doc: str = ""


#: Every revocable resource kind in the package. The doc table in
#: docs/resilience.md ("Resource ownership") mirrors this, checked both
#: directions by DPOW1104; the LeakLedger kinds (obs/ledger.py call
#: sites) use exactly these names.
RESOURCE_TABLE: Tuple[Resource, ...] = (
    Resource(
        kind="ticket",
        acquire=("acquire_dispatch",),
        release=("release",),
        keyed_release=("release_key",),
        transfer_stores=("_dispatch_tickets",),
        all_paths=True,
        coverage=COVER_STATIC,
        doc="on-demand admission window slot (sched/window.py); the "
        "dispatch teardown releases it on every path",
    ),
    Resource(
        kind="lease",
        acquire=("try_acquire_precache",),
        release=("release",),
        keyed_release=("release_key",),
        all_paths=False,  # the window sweep lapses a dead lease by design
        coverage=COVER_STATIC,
        doc="precache admission lease; lapses after --precache_lease "
        "seconds if no result lands (release of last resort)",
    ),
    Resource(
        kind="slot",
        acquire=("register",),
        acquire_bases=("ctl", "control"),
        release=("release",),
        transfer_calls=("_Launch", "_submit_launch"),
        all_paths=True,
        coverage=COVER_STATIC,
        doc="control-slot table entry (ops/control.py); travels with "
        "the launch record, released by the launch thread's finally "
        "and the apply path (DPOW1004 polices placement)",
    ),
    Resource(
        kind="claim",
        acquire=("claim_adoption",),
        release=("release_adoption", "drop_member_record"),
        all_paths=True,
        coverage=COVER_STATIC,
        doc="adoption election win (replica/fence.py); released by the "
        "leftovers re-open, the drained-slice retire, or the claim TTL",
    ),
    Resource(
        kind="gate",
        transfer_stores=("_dispatch_gates",),
        coverage=COVER_LEDGER,
        doc="coalesce gate (server/app.py _dispatch_gates); installed "
        "and removed under the dispatcher prologue's finally",
    ),
    Resource(
        kind="future",
        transfer_stores=("work_futures",),
        coverage=COVER_LEDGER,
        doc="dispatch future (server/app.py work_futures); every side "
        "table lives and dies with it via _drop_dispatch_state",
    ),
    Resource(
        kind="origin",
        transfer_stores=("_forward_origins",),
        coverage=COVER_LEDGER,
        doc="forward-origin relay entry (server/app.py); added via "
        "_add_origin, removed only through _pop_origins",
    ),
    Resource(
        kind="bgtask",
        coverage=COVER_LEDGER,
        doc="retained background write task (server/app.py _spawn); "
        "discharged by the task's done callback on every exit",
    ),
)

#: kinds with call-shaped acquires the flow families can anchor on
_STATIC_KINDS = tuple(r for r in RESOURCE_TABLE if r.acquire)

#: subscript store → the Resource that declares it as a transfer table
_TRANSFER_STORES: Dict[str, Resource] = {
    store: r for r in RESOURCE_TABLE for store in r.transfer_stores
}


# ---------------------------------------------------------------------------
# shape predicates
# ---------------------------------------------------------------------------


def _call_tail(node: ast.Call) -> Optional[str]:
    name = dotted_name(node.func)
    return name.split(".")[-1] if name else None


def _acquire_call(node: ast.AST, aliases: Dict[str, str]) -> Optional[Resource]:
    """The Resource this call mints a handle of, if any (awaits unwrapped
    by the caller)."""
    if not isinstance(node, ast.Call):
        return None
    name = dotted_name(node.func)
    if name is None:
        return None
    parts = name.split(".")
    for res in _STATIC_KINDS:
        if parts[-1] not in res.acquire:
            continue
        if res.acquire_bases:
            if len(parts) == 1:
                origin = aliases.get(parts[0], "")
                if not any(
                    origin.endswith(f"{b}.{parts[-1]}") or
                    origin.endswith(f"control.{parts[-1]}")
                    for b in res.acquire_bases
                ):
                    continue
            elif parts[-2] not in res.acquire_bases:
                continue
        return res
    return None


def _handle_arg(node: ast.Call, handle: str) -> bool:
    for arg in list(node.args) + [kw.value for kw in node.keywords]:
        if isinstance(arg, ast.Name) and arg.id == handle:
            return True
    return False


def _is_release_call(node: ast.Call, res: Resource, handle: Optional[str]) -> bool:
    """Direct release event: a release shape carrying the handle, a keyed
    release, or (claims) a ledger discharge of the kind literal."""
    tail = _call_tail(node)
    if tail is None:
        return False
    if tail in res.keyed_release:
        return True
    if tail in res.release:
        if res.kind == "claim":
            return True  # claims are keyed by their arguments
        if handle is not None and _handle_arg(node, handle):
            return True
        if handle is None and (node.args or node.keywords):
            return True  # helper-body scan: any released handle counts
    if res.kind == "claim" and tail == "discharge":
        first = node.args[0] if node.args else None
        return isinstance(first, ast.Constant) and first.value == "claim"
    return False


class _Helpers:
    """One-level helper resolution: ``self.X(...)`` / ``X(...)`` whose
    body contains a release shape counts as a release at the call site
    (the DPOW801 idiom — _drop_dispatch_state is the canonical case)."""

    def __init__(self, src):
        #: method name → FunctionDef, per enclosing class (flattened:
        #: same-name methods across classes in one file share an entry —
        #: acceptable for a one-file, one-level resolution)
        self.methods: Dict[str, ast.AST] = {}
        self.functions: Dict[str, ast.AST] = {}
        for node in src.nodes():
            if isinstance(node, ast.ClassDef):
                for item in node.body:
                    if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        self.methods.setdefault(item.name, item)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.functions.setdefault(node.name, node)

    def releases(self, call: ast.Call, res: Resource) -> bool:
        name = dotted_name(call.func)
        if name is None:
            return False
        parts = name.split(".")
        fn = None
        if len(parts) == 2 and parts[0] == "self":
            fn = self.methods.get(parts[1])
        elif len(parts) == 1:
            fn = self.functions.get(parts[0])
        if fn is None:
            return False
        return any(
            isinstance(n, ast.Call) and _is_release_call(n, res, None)
            for n in ast.walk(fn)
        )


def _release_event(stmts: Sequence[ast.AST], res: Resource,
                   handle: Optional[str], helpers: _Helpers) -> bool:
    """Does this subtree contain a release of the handle — directly or
    through a one-level helper?"""
    for stmt in stmts:
        for node in ast.walk(stmt):
            if not isinstance(node, ast.Call):
                continue
            if _is_release_call(node, res, handle):
                return True
            if helpers.releases(node, res):
                return True
    return False


def _transfer_event(stmt: ast.stmt, res: Resource, handle: str) -> bool:
    """The handle is handed to a declared new owner in this statement."""
    for node in ast.walk(stmt):
        if isinstance(node, ast.Assign):
            for target in node.targets:
                if (
                    isinstance(target, ast.Subscript)
                    and isinstance(target.value, ast.Attribute)
                    and target.value.attr in res.transfer_stores
                    and isinstance(node.value, ast.Name)
                    and node.value.id == handle
                ):
                    return True
        if isinstance(node, ast.Call):
            tail = _call_tail(node)
            if tail in res.transfer_calls and _handle_arg(node, handle):
                return True
    return False


def _contains_await(node: ast.AST) -> bool:
    return any(isinstance(n, ast.Await) for n in ast.walk(node))


def _try_protects(try_node: ast.Try, res: Resource, handle: Optional[str],
                  helpers: _Helpers) -> bool:
    """A try statement whose teardown releases the handle on every
    abnormal exit: a finally-resident release, or a full handler set
    (covering BaseException / bare except) where EVERY handler
    releases."""
    if try_node.finalbody and _release_event(
        try_node.finalbody, res, handle, helpers
    ):
        return True
    if not try_node.handlers:
        return False
    broad = False
    for h in try_node.handlers:
        if not _release_event(h.body, res, handle, helpers):
            return False
        if h.type is None:
            broad = True
        else:
            name = dotted_name(h.type)
            if name and name.split(".")[-1] == "BaseException":
                broad = True
    return broad


# ---------------------------------------------------------------------------
# DPOW1101 release-on-all-paths
# ---------------------------------------------------------------------------

#: path frame: (suite, index, owner_stmt, field) — owner_stmt/field name
#: the compound statement and suite the frame sits in (None at fn.body)
_Frame = Tuple[List[ast.stmt], int, Optional[ast.stmt], str]


def _iter_suites(stmt: ast.stmt):
    """(field, suite) pairs of a compound statement's nested suites."""
    for fld in ("body", "orelse", "finalbody"):
        suite = getattr(stmt, fld, None)
        if suite:
            yield fld, suite
    for h in getattr(stmt, "handlers", ()) or ():
        yield "handler", h.body


def _find_acquires(fn, aliases):
    """Yield (path, stmt, res, handle) for every acquire in ``fn``'s own
    statements (nested defs judged on their own), where ``path`` is the
    frame stack from fn.body down to the statement."""
    out = []

    def visit(suite: List[ast.stmt], path: List[_Frame],
              owner: Optional[ast.stmt], fld: str):
        for i, stmt in enumerate(suite):
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            frame = (suite, i, owner, fld)
            value = None
            handle = None
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                    and isinstance(stmt.targets[0], ast.Name):
                handle = stmt.targets[0].id
                value = stmt.value
            elif isinstance(stmt, ast.Expr):
                value = stmt.value
            if value is not None:
                if isinstance(value, ast.Await):
                    value = value.value
                res = _acquire_call(value, aliases)
                if res is not None:
                    out.append((path + [frame], stmt, res, handle))
            for sub_fld, sub in _iter_suites(stmt):
                visit(sub, path + [frame], stmt, sub_fld)

    visit(fn.body, [], None, "body")
    return out


def _protected(path: List[_Frame], stmt: ast.stmt, res: Resource,
               handle: Optional[str], helpers: _Helpers) -> Tuple[bool, str]:
    """Is this acquire released on all exits? Returns (ok, why-not)."""
    # 1) an enclosing try whose teardown releases — the acquire must sit
    #    in the try BODY (a release-in-finally does not cover its own
    #    finalbody or handlers).
    for suite, _i, owner, fld in path:
        if isinstance(owner, ast.Try) and fld == "body":
            if _try_protects(owner, res, handle, helpers):
                return True, ""
    # 2) forward scan: from the acquire to the next protection, with no
    #    cancellation point (await) in the gap. Falling off the end of a
    #    suite continues after the enclosing compound statement.
    depth = len(path) - 1
    suite, idx, _owner, _fld = path[depth]
    idx += 1
    while True:
        while idx >= len(suite):
            depth -= 1
            if depth < 0:
                return False, (
                    "no release on the fall-through path (function end "
                    "reached with the handle still owned)"
                )
            suite, idx, owner, fld = path[depth]
            if isinstance(owner, ast.Try) and fld in ("handler", "finalbody"):
                # leaving an except/finally continues after the try
                pass
            idx += 1
        nxt = suite[idx]
        if isinstance(nxt, ast.Try):
            if _try_protects(nxt, res, handle, helpers):
                return True, ""
            if _contains_await(nxt):
                return False, (
                    "an await inside an unprotecting try interposes a "
                    "cancellation path before any release"
                )
            idx += 1
            continue
        if _release_event([nxt], res, handle, helpers):
            return True, ""
        if handle is not None and _transfer_event(nxt, res, handle):
            return True, ""
        if (
            handle is not None
            and isinstance(nxt, ast.Return)
            and isinstance(nxt.value, ast.Name)
            and nxt.value.id == handle
        ):
            return True, ""  # ownership passes to the caller
        if _contains_await(nxt):
            return False, (
                "an await interposes a cancellation path between the "
                "acquire and the first release/transfer"
            )
        if isinstance(nxt, (ast.Return, ast.Raise, ast.Break, ast.Continue)):
            return False, (
                "this exit path drops the handle without releasing it"
            )
        idx += 1


def check_release_paths(project: Project) -> List[Finding]:
    findings: List[Finding] = []
    gate_words = tuple(
        shape for r in _STATIC_KINDS for shape in r.acquire
    )
    for src in project.sources():
        if not any(w in src.text for w in gate_words):
            continue
        helpers = _Helpers(src)
        for fn in src.nodes():
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            for path, stmt, res, handle in _find_acquires(fn, src.aliases):
                if not res.all_paths:
                    continue
                if handle is None:
                    findings.append(
                        Finding(
                            src.rel, stmt.lineno, CODE_RELEASE,
                            f"{res.kind} acquire ({res.acquire[0]}) "
                            "discards its handle: nothing can ever "
                            "release this resource",
                        )
                    )
                    continue
                ok, why = _protected(path, stmt, res, handle, helpers)
                if not ok:
                    findings.append(
                        Finding(
                            src.rel, stmt.lineno, CODE_RELEASE,
                            f"{res.kind} acquired into {handle!r} is not "
                            f"released on all paths: {why} — protect it "
                            "with a try/finally (identity-guarded "
                            "release), transfer ownership "
                            "(RESOURCE_TABLE shapes), or release before "
                            "the first await",
                        )
                    )
    return findings


# ---------------------------------------------------------------------------
# DPOW1102 ownership transfer
# ---------------------------------------------------------------------------


def _tracked_handles(fn, aliases) -> Dict[str, Resource]:
    handles: Dict[str, Resource] = {}
    for node in own_nodes(fn):
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)):
            continue
        value = node.value
        if isinstance(value, ast.Await):
            value = value.value
        res = _acquire_call(value, aliases)
        if res is not None:
            handles[node.targets[0].id] = res
    return handles


def _neutralizes(stmt: ast.stmt, handle: str) -> bool:
    if isinstance(stmt, ast.Assign):
        return (
            len(stmt.targets) == 1
            and isinstance(stmt.targets[0], ast.Name)
            and stmt.targets[0].id == handle
            and isinstance(stmt.value, ast.Constant)
            and stmt.value.value is None
        )
    if isinstance(stmt, ast.Delete):
        return any(
            isinstance(t, ast.Name) and t.id == handle for t in stmt.targets
        )
    return False


def check_transfers(project: Project) -> List[Finding]:
    findings: List[Finding] = []
    gate_words = tuple(
        shape for r in _STATIC_KINDS for shape in r.acquire
    )

    def scan_suite(suite, handles, src):
        for i, stmt in enumerate(suite):
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if isinstance(stmt, ast.Assign):
                for target in stmt.targets:
                    if not (
                        isinstance(target, ast.Subscript)
                        and isinstance(target.value, ast.Attribute)
                        and isinstance(stmt.value, ast.Name)
                        and stmt.value.id in handles
                    ):
                        continue
                    handle = stmt.value.id
                    res = handles[handle]
                    store = target.value.attr
                    if store not in res.transfer_stores:
                        findings.append(
                            Finding(
                                src.rel, stmt.lineno, CODE_TRANSFER,
                                f"{res.kind} handle {handle!r} stored "
                                f"into undeclared table {store!r}: "
                                "record the transfer in RESOURCE_TABLE "
                                "(transfer_stores) or release instead — "
                                "an unrecorded owner is invisible to "
                                "every teardown",
                            )
                        )
                        continue
                    nxt = suite[i + 1] if i + 1 < len(suite) else None
                    if nxt is None or not _neutralizes(nxt, handle):
                        findings.append(
                            Finding(
                                src.rel, stmt.lineno, CODE_TRANSFER,
                                f"{res.kind} handle {handle!r} "
                                f"transferred into {store!r} without "
                                "neutralizing the local in the next "
                                f"statement ({handle} = None): until "
                                "then both the table and this frame own "
                                "the release (a finally here would "
                                "double-release, skipping it leaks)",
                            )
                        )
            for _fld, sub in _iter_suites(stmt):
                scan_suite(sub, handles, src)

    for src in project.sources():
        if not any(w in src.text for w in gate_words):
            continue
        for fn in src.nodes():
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            handles = _tracked_handles(fn, src.aliases)
            if handles:
                scan_suite(fn.body, handles, src)
    return findings


# ---------------------------------------------------------------------------
# DPOW1103 double-release / use-after-release
# ---------------------------------------------------------------------------


def _own_expr_nodes(stmt: ast.stmt) -> List[ast.AST]:
    """The statement's OWN expressions — nested suites excluded, so a
    release inside an if-arm never taints the enclosing straight line."""
    if isinstance(stmt, (ast.If, ast.While)):
        return list(ast.walk(stmt.test))
    if isinstance(stmt, ast.For):
        return list(ast.walk(stmt.iter))
    if isinstance(stmt, (ast.Try, ast.With, ast.AsyncWith,
                         ast.FunctionDef, ast.AsyncFunctionDef)):
        return []
    return list(ast.walk(stmt))


def check_double_release(project: Project) -> List[Finding]:
    findings: List[Finding] = []
    gate_words = tuple(
        shape for r in _STATIC_KINDS for shape in r.acquire
    )

    def scan_suite(suite, handles, src):
        released: Dict[str, int] = {}  # handle → release line
        for stmt in suite:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            # a reassignment (x = ... / x = None) re-arms the handle
            if isinstance(stmt, ast.Assign):
                for target in stmt.targets:
                    if isinstance(target, ast.Name):
                        released.pop(target.id, None)
            nodes = _own_expr_nodes(stmt)
            for node in nodes:
                if not isinstance(node, ast.Call):
                    continue
                for handle, res in handles.items():
                    if res.kind == "claim":
                        continue  # keyed by args, no handle identity
                    if _is_release_call(node, res, handle):
                        if handle in released:
                            findings.append(
                                Finding(
                                    src.rel, node.lineno, CODE_DOUBLE,
                                    f"{res.kind} handle {handle!r} "
                                    "released twice on the same path "
                                    f"(first at line {released[handle]})"
                                    " — neutralize after the first "
                                    f"release ({handle} = None) or "
                                    "identity-guard the second",
                                )
                            )
                        released[handle] = node.lineno
            if not nodes:
                for _fld, sub in _iter_suites(stmt):
                    scan_suite(sub, handles, src)
                continue
            for handle in list(released):
                uses = [
                    n for n in nodes
                    if isinstance(n, ast.Name) and n.id == handle
                    and isinstance(n.ctx, ast.Load)
                ]
                # the releasing statement itself mentions the handle;
                # only LATER statements count as use-after-release
                if uses and stmt.lineno > released[handle]:
                    findings.append(
                        Finding(
                            src.rel, uses[0].lineno, CODE_DOUBLE,
                            f"{handles[handle].kind} handle {handle!r} "
                            "used after its release at line "
                            f"{released[handle]}: the slot may already "
                            "belong to another owner — reorder, or "
                            f"neutralize ({handle} = None) and re-check",
                        )
                    )
                    released.pop(handle, None)

    for src in project.sources():
        if not any(w in src.text for w in gate_words):
            continue
        for fn in src.nodes():
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            handles = _tracked_handles(fn, src.aliases)
            if handles:
                scan_suite(fn.body, handles, src)
    return findings


# ---------------------------------------------------------------------------
# DPOW1104 resource-ownership doc table
# ---------------------------------------------------------------------------

DOC_FILE = "resilience.md"

#: | `kind` | acquire | release | coverage | meaning |
_ROW_RE = re.compile(
    r"^\|\s*`([a-z]+)`\s*\|([^|]*)\|([^|]*)\|\s*([a-z+ ()-]+?)\s*\|"
)
_CODE_RE = re.compile(r"`([A-Za-z_][A-Za-z0-9_.]*)`")


@dataclass
class _DocRow:
    kind: str
    acquire: Set[str]
    release: Set[str]
    coverage: str
    line: int


def _doc_rows(project: Project) -> Tuple[Dict[str, _DocRow], List[Finding]]:
    findings: List[Finding] = []
    rows: Dict[str, _DocRow] = {}
    text = project.doc(DOC_FILE)
    doc_path = f"{project.docs_dir}/{DOC_FILE}"
    if text is None:
        return rows, findings
    known = {r.kind for r in RESOURCE_TABLE}
    for i, line in enumerate(text.splitlines(), 1):
        m = _ROW_RE.match(line.strip())
        if not m or m.group(1) not in known:
            continue
        row = _DocRow(
            m.group(1),
            set(_CODE_RE.findall(m.group(2))),
            set(_CODE_RE.findall(m.group(3))),
            m.group(4).strip(),
            i,
        )
        if row.kind in rows:
            findings.append(
                Finding(
                    doc_path, i, CODE_DOC,
                    f"resource kind {row.kind} has two ownership rows "
                    f"(first at line {rows[row.kind].line}) — each kind "
                    "gets exactly one",
                )
            )
            continue
        rows[row.kind] = row
    return rows, findings


def check_doc_table(project: Project) -> List[Finding]:
    if project.doc(DOC_FILE) is None:
        return []  # fixture tree without docs: nothing to cross-check
    rows, findings = _doc_rows(project)
    doc_path = f"{project.docs_dir}/{DOC_FILE}"
    for res in RESOURCE_TABLE:
        row = rows.get(res.kind)
        if row is None:
            findings.append(
                Finding(
                    doc_path, 1, CODE_DOC,
                    f"resource kind {res.kind} (RESOURCE_TABLE, "
                    "analysis/lifetime.py) has no row in the Resource "
                    f"ownership table of {doc_path}",
                )
            )
            continue
        declared = set(res.acquire)
        if declared and not declared <= row.acquire:
            findings.append(
                Finding(
                    doc_path, row.line, CODE_DOC,
                    f"{res.kind} acquire shapes "
                    f"{sorted(declared - row.acquire)} missing from its "
                    "ownership row",
                )
            )
        declared = set(res.release) | set(res.keyed_release)
        if declared and not declared <= row.release:
            findings.append(
                Finding(
                    doc_path, row.line, CODE_DOC,
                    f"{res.kind} release shapes "
                    f"{sorted(declared - row.release)} missing from its "
                    "ownership row",
                )
            )
        if row.coverage != res.coverage:
            findings.append(
                Finding(
                    doc_path, row.line, CODE_DOC,
                    f"{res.kind} coverage column {row.coverage!r} != "
                    f"declared {res.coverage!r} (RESOURCE_TABLE)",
                )
            )
    # the reverse direction (a row whose kind the table no longer
    # declares) is filtered by construction above — an undeclared kind
    # never matches ``known`` — so stale rows are caught by diffing:
    text = project.doc(DOC_FILE)
    if text is not None:
        known = {r.kind for r in RESOURCE_TABLE}
        for i, line in enumerate(text.splitlines(), 1):
            m = _ROW_RE.match(line.strip())
            if m and m.group(1) not in known and m.group(4).strip() in (
                COVER_STATIC, COVER_LEDGER
            ):
                findings.append(
                    Finding(
                        doc_path, i, CODE_DOC,
                        f"ownership row for {m.group(1)!r} names no "
                        "RESOURCE_TABLE kind (stale row, or the "
                        "declaration was renamed)",
                    )
                )
    return findings


# ---------------------------------------------------------------------------


def check(project: Project) -> List[Finding]:
    findings: List[Finding] = []
    findings.extend(check_release_paths(project))
    findings.extend(check_transfers(project))
    findings.extend(check_double_release(project))
    findings.extend(check_doc_table(project))
    return findings
