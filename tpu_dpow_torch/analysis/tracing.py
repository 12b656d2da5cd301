"""DPOW1001-1004 — engine-discipline checkers (the port's copy).

Three costly bug classes of the engine — stale-epoch frontier
rewinds, control-slot release racing a still-running launch thread, and
unwarmed-shape compiles landing on the dispatch path — were each caught
only by runtime choreography after shipping, yet all three are lexically
recognizable invariants of the engine code. Accelerator-matched code
accretes machine-specific discipline (traced values, compile caches,
async dispatch) that generic linters cannot see; these checkers close
that gap the same way DPOW101-901 closed the Clock/async/contract gaps.

DPOW1001 **epoch-fence discipline** — a frontier-mutating write on an
apply path (``set_base`` calls, per-device ``dev_bases``/``dev_scanned``
stores, ``device_ema`` EMA credit) not dominated by a comparison against
the job's current epoch/partition token. An *apply path* is a function
that reads a launch's epoch snapshot (``dev_epochs``; the port's launch
record names it ``epochs``) or takes an ``epoch``
parameter — the functions that consume device results; dispatch-time
base advances (which legitimately run unfenced) reference neither and
are exempt by construction. *Dominated* means an enclosing ``if``/
``while`` test compares something epoch-ish, or an earlier epoch-guard
``if`` in the same suite cannot fall through (the ``!= … continue``
idiom). Deleting the epoch guard from ``_apply_plain_rows`` re-fires
this checker (pinned in tests/test_torch_analysis.py).

DPOW1002 **device-value leakage onto the event loop** — the torch
counterpart of ``tpu_dpow``'s traced-value rule. A device value reaching
host control flow inside an ``async def`` makes the host wait for every
kernel queued ahead of it, on the event-loop thread, so the whole server
stalls behind the grid. It fires, inside an ``async def`` (nested defs and
lambdas pruned: those run elsewhere), on ``.item()``/``.tolist()``/
``.cpu()``/``.numpy()`` of a torch op's result; on ``if``/``while``/
``assert``/``bool()``/``int()``/``float()`` over one; and on any
``.synchronize()`` (``torch.cuda.synchronize()``, an Event's, a Stream's).
A torch op is a ``torch.*`` call after import aliasing, minus the host
namespaces (``torch.cuda.is_available()``, ``torch.device``...); taint
follows local names through assignment and method chains, and a host copy
or cast clears it. Values that arrive as parameters or attributes
(``self.buf``) are not tracked (blind spot, catalogued).

DPOW1003 **recompile/warm-ladder hazard** (kept as in ``tpu_dpow``; the
port has no ``jit`` and no ``_warm`` ladder, so it has no site here) — (a) a call to a
jit-wrapped function passing a non-hashable display (list/dict/set/
comprehension) or an f-string (per-request-varying ⇒ one compile-cache
entry per distinct value) to one of its declared ``static_argnames``,
or a non-hashable display to an ``lru_cache`` compile-factory; (b) in a
class that owns the ``_warm`` shape set, a method that submits a device
launch (``_submit_launch``/``_timed_launch``/``_launch``) with a
non-constant step count while never consulting the warm ladder
(``_warm`` / ``_pick_shape``) — a cold compile on the dispatch path,
as lint, not just a test.

DPOW1004 **slot/launch lifetime** — (a) a control-slot ``release``
(``ctl.release``/``control.release``) reachable outside a ``finally``
block: the slot must live exactly as long as the launch thread, and an
early release feeds a still-running loop dead zeros and UNDOES its
cancel/kill flags (the zombie launch); (b) a launch-thread
liveness judgment made from the asyncio wrapper (``rec.fut.done()`` /
``.cancelled()``) instead of the ``thread_done`` Event — cancelling the
wrapper's waiter marks it done while the executor thread may still be
wedged. A ``.fut``-based check is exempt when the enclosing function
tested ``thread_done`` first (the sanctioned None-fallback idiom).

All stdlib-``ast``, one parse per file (core.SourceFile), standard
waiver syntax. Known blind spots are catalogued in
tpu_dpow_torch/docs/analysis.md.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from .core import Finding, Project, dotted_name, resolve_call
from .concurrency import _terminates

CODE_EPOCH = "DPOW1001"
CODE_TRACED = "DPOW1002"
CODE_WARM = "DPOW1003"
CODE_SLOT = "DPOW1004"

#: checker families this module contributes (aggregated into the
#: registry in __init__.py — the families=N headline denominator)
FAMILIES = (
    ("epoch-fence", (CODE_EPOCH,)),
    ("traced-leak", (CODE_TRACED,)),
    ("warm-ladder", (CODE_WARM,)),
    ("slot-lifetime", (CODE_SLOT,)),
)


def own_nodes(fn: ast.AST) -> List[ast.AST]:
    """``fn``'s own statements/expressions in source (pre-)order, PRUNING
    nested function/lambda subtrees — ``ast.walk`` can do neither (it is
    breadth-first and cannot skip a subtree), and both properties matter
    here: taint must propagate in execution order, and a nested def's
    body must be judged on its own merits, not under the enclosing
    function's taint/ownership."""
    out: List[ast.AST] = []
    stack = list(reversed(list(ast.iter_child_nodes(fn))))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        out.append(node)
        stack.extend(reversed(list(ast.iter_child_nodes(node))))
    return out


# ---------------------------------------------------------------------------
# DPOW1001 epoch-fence discipline
# ---------------------------------------------------------------------------

#: attribute roots whose element stores move the scan frontier / credit —
#: exactly the state a stale-epoch launch must never touch
_FRONTIER_SUBSCRIPTS = {"dev_bases", "dev_scanned", "device_ema"}


def _mentions_epoch(expr: ast.AST) -> bool:
    for node in ast.walk(expr):
        if isinstance(node, ast.Name) and "epoch" in node.id.lower():
            return True
        if isinstance(node, ast.Attribute) and "epoch" in node.attr.lower():
            return True
    return False


def _epoch_compare(test: ast.AST) -> bool:
    """Does this test contain a comparison against an epoch-ish value?
    (``epoch == job.dev_epoch``, ``rec.dev_epochs[row] != job.dev_epoch``,
    buried in ``and``/``or`` chains included.)"""
    for node in ast.walk(test):
        if isinstance(node, ast.Compare) and (
            _mentions_epoch(node.left)
            or any(_mentions_epoch(c) for c in node.comparators)
        ):
            return True
    return False


#: a launch record's per-row epoch snapshot: ``dev_epochs`` in
#: ``tpu_dpow``'s engine, ``epochs`` (``rec.epochs``) in the port's
_EPOCH_SNAPSHOTS = ("dev_epochs", "epochs")


def _is_apply_path(fn: ast.AST) -> bool:
    """A function that consumes launch results: it reads a per-launch
    epoch snapshot (``dev_epochs``, or the port's ``rec.epochs``) or takes
    the epoch as a parameter. Dispatch paths (which advance bases
    unfenced, legitimately) do neither."""
    args = fn.args
    for a in args.args + args.kwonlyargs + args.posonlyargs:
        if a.arg in ("epoch", "epochs", "epoch_dev"):
            return True
    for node in ast.walk(fn):
        if isinstance(node, ast.Name) and node.id == "dev_epochs":
            return True
        if isinstance(node, ast.Attribute) and node.attr in _EPOCH_SNAPSHOTS:
            return True
    return False


def _frontier_writes(stmt: ast.stmt) -> List[Tuple[int, str]]:
    """(line, what) frontier mutations lexically inside one statement
    (nested function/lambda bodies run under their own caller and are
    pruned)."""
    out: List[Tuple[int, str]] = []
    for node in [stmt] + own_nodes(stmt):
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "set_base"
        ):
            out.append((node.lineno, f"{dotted_name(node.func) or 'set_base'}()"))
        elif isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = (
                node.targets if isinstance(node, ast.Assign) else [node.target]
            )
            for t in targets:
                el = t
                if isinstance(el, ast.Subscript):
                    el = el.value
                if (
                    isinstance(el, ast.Attribute)
                    and el.attr in _FRONTIER_SUBSCRIPTS
                ):
                    out.append((t.lineno, f"{dotted_name(el) or el.attr} store"))
    return out


class _FenceScan:
    """Walk one apply-path function recording frontier writes that no
    epoch comparison dominates."""

    def __init__(self):
        self.unfenced: List[Tuple[int, str]] = []

    def scan(self, body: List[ast.stmt], guarded: bool) -> None:
        for stmt in body:
            self._stmt(stmt, guarded)
            if (
                isinstance(stmt, ast.If)
                and _epoch_compare(stmt.test)
                and (
                    _terminates(stmt.body)
                    or (bool(stmt.orelse) and _terminates(stmt.orelse))
                )
            ):
                # Early-exit epoch guard (``if epoch != …: continue``):
                # everything after it in this suite runs epoch-checked.
                guarded = True

    def _stmt(self, stmt: ast.stmt, guarded: bool) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            return
        if isinstance(stmt, ast.If):
            sub = guarded or _epoch_compare(stmt.test)
            # We cannot know which arm holds the CURRENT epoch, but either
            # arm of an epoch test is epoch-aware code — the bug class is
            # the write with no comparison anywhere above it.
            self.scan(stmt.body, sub)
            self.scan(stmt.orelse, sub)
            return
        if isinstance(stmt, ast.While):
            sub = guarded or _epoch_compare(stmt.test)
            self.scan(stmt.body, sub)
            self.scan(stmt.orelse, guarded)
            return
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            self.scan(stmt.body, guarded)
            self.scan(stmt.orelse, guarded)
            return
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            self.scan(stmt.body, guarded)
            return
        if isinstance(stmt, ast.Try):
            self.scan(stmt.body, guarded)
            for h in stmt.handlers:
                self.scan(h.body, guarded)
            self.scan(stmt.orelse, guarded)
            self.scan(stmt.finalbody, guarded)
            return
        if not guarded:
            self.unfenced.extend(_frontier_writes(stmt))


def check_epoch_fence(project: Project) -> List[Finding]:
    findings: List[Finding] = []
    for src in project.sources():
        if "epoch" not in src.text:
            continue  # apply paths carry the epoch by definition
        for fn in src.nodes():
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if not _is_apply_path(fn):
                continue
            scan = _FenceScan()
            scan.scan(fn.body, False)
            for line, what in scan.unfenced:
                findings.append(
                    Finding(
                        src.rel,
                        line,
                        CODE_EPOCH,
                        f"frontier-mutating {what} on the apply path "
                        f"('{fn.name}' consumes a launch epoch snapshot) "
                        "with no dominating epoch comparison: a result of "
                        "a launch dispatched before a re-partition could "
                        "rewind the frontier into a re-covered range — "
                        "fence it on the job's current epoch "
                        "(docs/device_sharding.md, epoch fencing)",
                    )
                )
    return findings


# ---------------------------------------------------------------------------
# DPOW1002 device-value leakage onto the event loop
# ---------------------------------------------------------------------------

#: jit/pmap wrapper leaves: DPOW1003 reads their ``static_argnames``
_TRACE_WRAPPERS = {"jit", "pmap"}

#: tensor methods that copy a device value to the host, waiting for every
#: kernel queued ahead of it on the stream; their result lives on the host
_HOST_COPIES = {"item", "tolist", "cpu", "numpy"}

#: builtins that force a one-element tensor to a Python value (a sync)
_HOST_CASTS = {"bool", "int", "float"}

#: ``torch.<ns>`` namespaces whose calls return host values or handles
#: (``torch.cuda.is_available()``, ``torch.device(...)``), not device data
_HOST_NAMESPACES = {
    "cuda", "backends", "utils", "device", "dtype", "distributed",
    "multiprocessing", "profiler", "Size", "Generator",
}
_HOST_LEAF_PREFIXES = ("is_", "get_", "set_", "manual_seed")

#: tensor attributes that are host metadata, not device data
_HOST_ATTRS = {
    "shape", "dtype", "device", "ndim", "is_cuda", "layout", "requires_grad",
}

#: tensor methods that read host metadata (no sync, a Python result)
_HOST_METHODS = {
    "numel", "nelement", "size", "dim", "stride", "element_size",
    "is_contiguous", "data_ptr", "get_device",
}


def _torch_op(node: ast.Call, aliases: Dict[str, str]) -> bool:
    """A call whose result lives on the device: a ``torch.*`` op after
    import aliasing, minus the host namespaces and query functions."""
    parts = (resolve_call(node, aliases) or "").split(".")
    if parts[0] != "torch" or len(parts) < 2:
        return False
    if parts[1] in _HOST_NAMESPACES:
        return False
    return not parts[-1].startswith(_HOST_LEAF_PREFIXES)


def _on_device(expr: ast.AST, tainted: Set[str], aliases) -> bool:
    """Does ``expr`` evaluate to device data? A torch op's result, a name
    bound to one, and anything computed from those (methods, indexing,
    arithmetic, comparisons) — but not a host copy, a cast, or metadata."""
    if isinstance(expr, ast.Name):
        return expr.id in tainted
    if isinstance(expr, ast.Call):
        f = expr.func
        if isinstance(f, ast.Attribute):
            if f.attr in _HOST_COPIES or f.attr in _HOST_METHODS:
                return False
            if _torch_op(expr, aliases):
                return True
            return _on_device(f.value, tainted, aliases)
        if isinstance(f, ast.Name) and f.id in _HOST_CASTS:
            return False
        return _torch_op(expr, aliases)
    if isinstance(expr, ast.Attribute):
        return expr.attr not in _HOST_ATTRS and _on_device(
            expr.value, tainted, aliases
        )
    if isinstance(expr, ast.Subscript):
        return _on_device(expr.value, tainted, aliases)
    if isinstance(expr, ast.BinOp):
        return _on_device(expr.left, tainted, aliases) or _on_device(
            expr.right, tainted, aliases
        )
    if isinstance(expr, ast.UnaryOp):
        return _on_device(expr.operand, tainted, aliases)
    if isinstance(expr, ast.Compare):
        return any(
            _on_device(e, tainted, aliases)
            for e in [expr.left] + list(expr.comparators)
        )
    if isinstance(expr, ast.BoolOp):
        return any(_on_device(e, tainted, aliases) for e in expr.values)
    if isinstance(expr, ast.IfExp):
        return _on_device(expr.body, tainted, aliases) or _on_device(
            expr.orelse, tainted, aliases
        )
    return False


def _sync_call(node: ast.Call, aliases) -> bool:
    """``torch.cuda.synchronize()``, ``event.synchronize()``,
    ``stream.synchronize()``: a host wait on the card, whatever the
    receiver (nothing else in the tree has a ``synchronize`` method)."""
    if isinstance(node.func, ast.Attribute) and node.func.attr == "synchronize":
        return True
    return (resolve_call(node, aliases) or "") == "torch.cuda.synchronize"


def check_traced_leak(project: Project) -> List[Finding]:
    findings: List[Finding] = []
    for src in project.sources():
        if "torch" not in src.text and "synchronize" not in src.text:
            continue
        aliases = src.aliases
        for fn in src.nodes():
            if not isinstance(fn, ast.AsyncFunctionDef):
                continue
            tainted: Set[str] = set()

            def _flag(line: int, what: str) -> None:
                findings.append(
                    Finding(
                        src.rel,
                        line,
                        CODE_TRACED,
                        f"{what} on a device value inside async def "
                        f"'{fn.name}': the host waits for the card's "
                        "queued kernels on the event-loop thread, so every "
                        "coroutine stalls behind the grid — do the copy "
                        "or the wait on a launch thread or in "
                        "loop.run_in_executor",
                    )
                )

            for node in own_nodes(fn):
                if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                    targets = (
                        node.targets
                        if isinstance(node, ast.Assign)
                        else [node.target]
                    )
                    on_dev = node.value is not None and _on_device(
                        node.value, tainted, aliases
                    )
                    for t in targets:
                        for el in t.elts if isinstance(t, ast.Tuple) else [t]:
                            if not isinstance(el, ast.Name):
                                continue
                            if on_dev:
                                tainted.add(el.id)
                            elif not isinstance(node, ast.AugAssign):
                                tainted.discard(el.id)
                elif isinstance(node, ast.If) and _on_device(
                    node.test, tainted, aliases
                ):
                    _flag(node.lineno, "Python if")
                elif isinstance(node, ast.While) and _on_device(
                    node.test, tainted, aliases
                ):
                    _flag(node.lineno, "Python while")
                elif isinstance(node, ast.Assert) and _on_device(
                    node.test, tainted, aliases
                ):
                    _flag(node.lineno, "assert")
                elif isinstance(node, ast.Call):
                    f = node.func
                    if _sync_call(node, aliases):
                        _flag(node.lineno, f"{dotted_name(f) or 'synchronize'}()")
                    elif (
                        isinstance(f, ast.Attribute)
                        and f.attr in _HOST_COPIES
                        and _on_device(f.value, tainted, aliases)
                    ):
                        _flag(node.lineno, f".{f.attr}()")
                    elif (
                        isinstance(f, ast.Name)
                        and f.id in _HOST_CASTS
                        and node.args
                        and _on_device(node.args[0], tainted, aliases)
                    ):
                        _flag(node.lineno, f"{f.id}()")
    return findings


# ---------------------------------------------------------------------------
# DPOW1003 recompile/warm-ladder hazard
# ---------------------------------------------------------------------------

#: displays that are unhashable (or vary per construction) — poison for a
#: jit static argument or an lru_cache compile-factory key
_UNHASHABLE = (
    ast.List, ast.Dict, ast.Set, ast.ListComp, ast.DictComp, ast.SetComp,
    ast.GeneratorExp,
)

#: launch-submitting method names (the engine's executor seam) and the
#: wrapper methods exempt from the warm-ladder rule (they ARE the seam)
_SUBMITTERS = ("_submit_launch", "_timed_launch", "_launch")
_WARM_SOURCES = ("_warm", "_pick_shape")


def _static_argnames(fn, aliases) -> Optional[Tuple[str, ...]]:
    """The literal static_argnames tuple of a jit-partial decorator."""
    for dec in fn.decorator_list:
        if not isinstance(dec, ast.Call):
            continue
        target = resolve_call(dec, aliases) or ""
        is_partial = target.rsplit(".", 1)[-1] == "partial"
        inner = dotted_name(dec.args[0]) if (is_partial and dec.args) else None
        direct = dotted_name(dec.func)
        wrapped = (
            (inner and inner.rsplit(".", 1)[-1] in _TRACE_WRAPPERS)
            or (direct and direct.rsplit(".", 1)[-1] in _TRACE_WRAPPERS)
        )
        if not wrapped:
            continue
        for kw in dec.keywords:
            if kw.arg == "static_argnames" and isinstance(
                kw.value, (ast.Tuple, ast.List)
            ):
                names = tuple(
                    e.value
                    for e in kw.value.elts
                    if isinstance(e, ast.Constant) and isinstance(e.value, str)
                )
                return names
            if kw.arg == "static_argnames" and isinstance(kw.value, ast.Constant):
                return (str(kw.value.value),)
        return ()
    return None


def _lru_cached(fn, aliases) -> bool:
    for dec in fn.decorator_list:
        name = dotted_name(dec.func) if isinstance(dec, ast.Call) else dotted_name(dec)
        if name and name.rsplit(".", 1)[-1] == "lru_cache":
            return True
    return False


def check_warm_ladder(project: Project) -> List[Finding]:
    findings: List[Finding] = []
    # repo-wide tables: jit static-arg surfaces and lru_cache factories,
    # resolved by leaf name (the project calls them unqualified or via a
    # module alias; a same-named foreign function is a documented blind
    # spot, not a crash).
    static_by_name: Dict[str, Tuple[str, ...]] = {}
    cached_names: Set[str] = set()
    sources = project.sources()
    for src in sources:
        for fn in src.nodes():
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            statics = _static_argnames(fn, src.aliases)
            if statics:
                static_by_name[fn.name] = statics
            if _lru_cached(fn, src.aliases):
                cached_names.add(fn.name)

    for src in sources:
        # (a) hazardous arguments into compile caches
        for node in src.nodes():
            if not isinstance(node, ast.Call):
                continue
            target = resolve_call(node, src.aliases) or ""
            leaf = target.rsplit(".", 1)[-1]
            statics = static_by_name.get(leaf)
            if statics:
                for kw in node.keywords:
                    if kw.arg not in statics:
                        continue
                    if isinstance(kw.value, _UNHASHABLE):
                        findings.append(
                            Finding(
                                src.rel,
                                kw.value.lineno,
                                CODE_WARM,
                                f"non-hashable value for static argument "
                                f"'{kw.arg}' of jitted '{leaf}': the "
                                "compile cache cannot key it — this "
                                "raises (or retraces) at dispatch time",
                            )
                        )
                    elif isinstance(kw.value, ast.JoinedStr):
                        findings.append(
                            Finding(
                                src.rel,
                                kw.value.lineno,
                                CODE_WARM,
                                f"f-string for static argument "
                                f"'{kw.arg}' of jitted '{leaf}': every "
                                "distinct value is a fresh trace+compile "
                                "on the dispatch path — pass a value "
                                "from a small closed set instead",
                            )
                        )
            if leaf in cached_names:
                for arg in list(node.args) + [k.value for k in node.keywords]:
                    if isinstance(arg, _UNHASHABLE):
                        findings.append(
                            Finding(
                                src.rel,
                                arg.lineno,
                                CODE_WARM,
                                f"non-hashable argument to lru_cache "
                                f"compile factory '{leaf}': the cache "
                                "key raises TypeError at dispatch — "
                                "pass a tuple",
                            )
                        )
        # (b) launches bypassing the warm ladder
        for cls in src.nodes():
            if not isinstance(cls, ast.ClassDef):
                continue
            owns_warm = any(
                isinstance(n, ast.Attribute) and n.attr == "_warm"
                for n in ast.walk(cls)
            )
            if not owns_warm:
                continue
            for meth in cls.body:
                if not isinstance(meth, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue
                if any(meth.name.startswith(s) for s in _SUBMITTERS) or (
                    meth.name.startswith("_await_launch")
                ):
                    continue  # the seam itself, not a dispatch decision
                consults_ladder = any(
                    isinstance(n, ast.Attribute) and n.attr in _WARM_SOURCES
                    for n in ast.walk(meth)
                )
                if consults_ladder:
                    continue
                for node in ast.walk(meth):
                    if not (
                        isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr in _SUBMITTERS
                        and isinstance(node.func.value, ast.Name)
                        and node.func.value.id in ("self", "cls")
                    ):
                        continue
                    steps = None
                    if len(node.args) >= 2:
                        steps = node.args[1]
                    for kw in node.keywords:
                        if kw.arg == "steps":
                            steps = kw.value
                    if steps is None or isinstance(steps, ast.Constant):
                        continue  # literal shapes are ladder rungs by fiat
                    findings.append(
                        Finding(
                            src.rel,
                            node.lineno,
                            CODE_WARM,
                            f"'{meth.name}' submits a device launch with "
                            "a computed step count but never consults "
                            "the warm ladder (self._warm / _pick_shape): "
                            "an unwarmed shape compiles inline ON the "
                            "dispatch path and stalls every active "
                            "request behind it",
                        )
                    )
    return findings


# ---------------------------------------------------------------------------
# DPOW1004 slot/launch lifetime
# ---------------------------------------------------------------------------

#: the control module that owns the slot table (package-dir-relative)
CONTROL_MODULE = "ops/control.py"


def _is_control_release(node: ast.Call, aliases) -> bool:
    name = dotted_name(node.func)
    if name is None:
        return False
    parts = name.split(".")
    if parts[-1] != "release":
        return False
    if len(parts) == 1:
        # bare ``release(...)`` counts only when imported from control
        origin = aliases.get("release", "")
        return origin.endswith("control.release")
    return parts[-2] in ("ctl", "control")


def _finally_lines(tree: ast.AST) -> Set[int]:
    """Line numbers lexically inside any ``finally:`` suite."""
    out: Set[int] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Try) and node.finalbody:
            for stmt in node.finalbody:
                for sub in ast.walk(stmt):
                    ln = getattr(sub, "lineno", None)
                    if ln is not None:
                        out.add(ln)
    return out


def check_slot_lifetime(project: Project) -> List[Finding]:
    findings: List[Finding] = []
    pkg = project.package_dir.rstrip("/") + "/"
    for src in project.sources():
        if src.rel == pkg + CONTROL_MODULE:
            continue  # the slot table's own module manages its entries
        if "release" not in src.text and ".fut" not in src.text:
            continue
        in_finally = _finally_lines(src.tree)
        # (a) release outside the launch thread's finally
        for node in src.nodes():
            if (
                isinstance(node, ast.Call)
                and _is_control_release(node, src.aliases)
                and node.lineno not in in_finally
            ):
                findings.append(
                    Finding(
                        src.rel,
                        node.lineno,
                        CODE_SLOT,
                        "control-slot release outside the launch "
                        "thread's finally: the slot must live exactly "
                        "as long as the thread — an early release feeds "
                        "a still-running loop dead zeros and UNDOES its "
                        "cancel/kill flags (the launch then grinds its "
                        "whole span while pinning an executor thread)",
                    )
                )
        # (b) fut-based liveness judgments
        for fn in src.nodes():
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            thread_done_checks = sorted(
                n.lineno
                for n in ast.walk(fn)
                if (isinstance(n, ast.Attribute) and n.attr == "thread_done")
                or (isinstance(n, ast.Name) and n.id == "thread_done")
            )
            for node in ast.walk(fn):
                if not (
                    isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("done", "cancelled")
                    and isinstance(node.func.value, ast.Attribute)
                    and node.func.value.attr == "fut"
                ):
                    continue
                if any(ln < node.lineno for ln in thread_done_checks):
                    continue  # the sanctioned thread_done-first fallback
                findings.append(
                    Finding(
                        src.rel,
                        node.lineno,
                        CODE_SLOT,
                        f".fut.{node.func.attr}() as a launch-liveness "
                        "signal: cancelling the asyncio wrapper's waiter "
                        "marks it done while the executor thread may "
                        "still be wedged — judge thread return by the "
                        "thread_done Event (set in the thread's own "
                        "finally), falling back to fut only when no "
                        "Event exists",
                    )
                )
    return findings


def check(project: Project) -> List[Finding]:
    return (
        check_epoch_fence(project)
        + check_traced_leak(project)
        + check_warm_ladder(project)
        + check_slot_lifetime(project)
    )
