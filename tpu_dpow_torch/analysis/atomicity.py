"""DPOW1005 store atomicity: no load-then-save RMW on shared key spaces.

DPOW901 fences ``replica:*`` writes into replica/fence.py; this checker
generalizes the other half of the replication lesson to the whole shared store
surface. A read-modify-write composed of a plain ``get``/``hgetall``
load and a plain ``set``/``hset`` save is atomic on exactly one process
— on a shared sqlite or redis store two writers interleave and the
second save silently reverts the first (the sqlite class). Shared
state must ride the store's atomic primitives (``incrby``/``hincrby``/
``setnx``) or the epoch-checked :class:`~tpu_dpow_torch.replica.fence.
FencedWriter`; anything else is last-writer-wins and must say so in a
waiver.

Detection model (per function, one-level helper resolution like
DPOW801): a Store READ (``get``/``hget``/``hgetall``/``smembers``/
``exists`` on a ``store``-named receiver) of a key classifiable into
one of the shared prefixes (``replica:``, ``quota:``, ``fleet:``,
``account:``, ``precache:``) — directly or via a same-class helper that
performs such a read — followed later in the same function by a
non-atomic Store WRITE (``set``/``hset``/``sadd``/``srem``) with a key
of the SAME prefix, fires at the write. Key classification resolves literals, module constants, class
constants (``self.PREFIX``), leading-literal f-strings, and f-strings
whose first placeholder is such a constant. ``replica/fence.py`` is the
sanctioned fenced-write boundary and exempt.

Blind spots (deliberate): keys assembled at runtime (a name looped off
``store.keys(...)``), reads and writes split across two objects, and
helper resolution deeper than one level — the chaos suites and dpowsan
remain the behavioral check.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from .core import Finding, Project, dotted_name, resolve_call
from .replica_keys import KEY_HELPERS, FENCE_MODULE
from .tracing import own_nodes

CODE_RMW = "DPOW1005"

#: checker families this module contributes (aggregated into the
#: registry in __init__.py — the families=N headline denominator)
FAMILIES = (("store-atomicity", (CODE_RMW,)),)

#: the shared key spaces two processes may race on
PREFIXES = ("replica:", "quota:", "fleet:", "account:", "precache:")

READ_METHODS = ("get", "hget", "hgetall", "smembers", "exists")

#: non-atomic write methods; incrby/hincrby/setnx are the sanctioned
#: primitives and deliberately absent
WRITE_METHODS = ("set", "hset", "sadd", "srem")


def _store_receiver(func: ast.Attribute) -> bool:
    """Is this a raw Store call? (receiver chain ends in ``store`` — the
    project idiom; FencedWriter instances are named ``writer``/``fenced``
    and stay exempt by construction.)"""
    base = dotted_name(func.value) or ""
    leaf = base.rsplit(".", 1)[-1]
    return leaf == "store" or leaf.endswith("_store")


def _class_constants(cls: ast.ClassDef) -> Dict[str, str]:
    out: Dict[str, str] = {}
    for stmt in cls.body:
        if (
            isinstance(stmt, ast.Assign)
            and len(stmt.targets) == 1
            and isinstance(stmt.targets[0], ast.Name)
            and isinstance(stmt.value, ast.Constant)
            and isinstance(stmt.value.value, str)
        ):
            out[stmt.targets[0].id] = stmt.value.value
    return out


def _const_str(
    node: ast.AST, consts: Dict[str, str], cls_consts: Dict[str, str]
) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.Name):
        return consts.get(node.id)
    if isinstance(node, ast.Attribute):
        name = dotted_name(node)
        if name and name.split(".")[0] in ("self", "cls") and name.count(".") == 1:
            return cls_consts.get(node.attr)
    return None


def _key_prefix(
    node: ast.AST,
    consts: Dict[str, str],
    cls_consts: Dict[str, str],
    aliases,
) -> Optional[str]:
    """The shared prefix a key expression statically resolves to."""
    head: Optional[str] = None
    direct = _const_str(node, consts, cls_consts)
    if direct is not None:
        head = direct
    elif isinstance(node, ast.JoinedStr) and node.values:
        first = node.values[0]
        if isinstance(first, ast.Constant) and isinstance(first.value, str):
            head = first.value
        elif isinstance(first, ast.FormattedValue):
            head = _const_str(first.value, consts, cls_consts)
    elif isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        head = _const_str(node.left, consts, cls_consts)
    elif isinstance(node, ast.Call):
        target = resolve_call(node, aliases)
        if target and target.rsplit(".", 1)[-1] in KEY_HELPERS:
            return "replica:"  # fence.py key builders build replica:* keys
    if head is None:
        return None
    for p in PREFIXES:
        if head.startswith(p):
            return p
    return None


def _store_ops(
    fn, consts, cls_consts, aliases
) -> List[Tuple[str, str, int]]:
    """('read'|'write', prefix, line) events in source order. Nested
    function bodies are PRUNED (own_nodes): a callback's read must not
    manufacture an RMW pair with the enclosing function's write."""
    out: List[Tuple[str, str, int]] = []
    for node in own_nodes(fn):
        if not (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.args
            and _store_receiver(node.func)
        ):
            continue
        prefix = _key_prefix(node.args[0], consts, cls_consts, aliases)
        if prefix is None:
            continue
        if node.func.attr in READ_METHODS:
            out.append(("read", prefix, node.lineno))
        elif node.func.attr in WRITE_METHODS:
            out.append(("write", prefix, node.lineno))
    return out


def _helper_read_prefixes(
    cls: ast.ClassDef, consts, cls_consts, aliases
) -> Dict[str, Set[str]]:
    """method name -> shared prefixes it store-READS (one-level model)."""
    out: Dict[str, Set[str]] = {}
    for meth in cls.body:
        if not isinstance(meth, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        prefixes = {
            p for kind, p, _ in _store_ops(meth, consts, cls_consts, aliases)
            if kind == "read"
        }
        if prefixes:
            out[meth.name] = prefixes
    return out


def check(project: Project) -> List[Finding]:
    findings: List[Finding] = []
    pkg = project.package_dir.rstrip("/") + "/"
    for src in project.sources():
        if src.rel == pkg + FENCE_MODULE:
            continue
        if not any(p in src.text for p in PREFIXES):
            continue
        consts = project.constants(src)
        classes = [n for n in src.nodes() if isinstance(n, ast.ClassDef)]
        cls_consts_of = {id(c): _class_constants(c) for c in classes}
        enclosing: Dict[int, ast.ClassDef] = {}
        for cls in classes:
            for stmt in cls.body:
                if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    enclosing[id(stmt)] = cls
        helper_tables = {
            id(cls): _helper_read_prefixes(
                cls, consts, cls_consts_of[id(cls)], src.aliases
            )
            for cls in classes
        }
        for fn in src.nodes():
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            cls = enclosing.get(id(fn))
            cls_consts = cls_consts_of[id(cls)] if cls else {}
            helpers = helper_tables.get(id(cls) if cls else -1, {})
            events = _store_ops(fn, consts, cls_consts, src.aliases)
            # fold in same-class helper reads at their call line (pruned
            # like _store_ops: a nested callback's helper call is not
            # this function's read)
            for node in own_nodes(fn):
                if (
                    isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id in ("self", "cls")
                    and node.func.attr in helpers
                    and node.func.attr != fn.name
                ):
                    for p in helpers[node.func.attr]:
                        events.append(("read", p, node.lineno))
            events.sort(key=lambda e: e[2])
            reads_seen: Dict[str, int] = {}
            reported: Set[int] = set()
            for kind, prefix, line in events:
                if kind == "read":
                    reads_seen.setdefault(prefix, line)
                elif prefix in reads_seen and line not in reported:
                    reported.add(line)
                    findings.append(
                        Finding(
                            src.rel,
                            line,
                            CODE_RMW,
                            f"load-then-save read-modify-write on shared "
                            f"'{prefix}*' keys ('{fn.name}' reads on line "
                            f"{reads_seen[prefix]}, plain-writes here): "
                            "two writers on a shared store interleave "
                            "and the second save reverts the first — "
                            "use incrby/setnx/FencedWriter, or waive "
                            "with the documented last-writer-wins "
                            "contract",
                        )
                    )
    return findings
