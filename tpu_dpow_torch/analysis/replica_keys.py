"""DPOW901 replica-key-fencing: every ``replica:*`` Store write rides fence.py.

Replication's zombie guarantee (docs/replication.md) rests on one rule: a
replica may mutate the shared ``replica:*`` key space only while its
membership epoch is still current. :mod:`tpu_dpow_torch.replica.fence` is the one
module that enforces that — its ``FencedWriter`` checks the per-replica
fence before every write, and its adopter-side helpers raise the fence
BEFORE moving a dead member's state. A single Store write with a
``replica:*`` key anywhere else is an unfenced write: a zombie replica (GC
pause, partition, wedged loop) could land it after being adopted and
silently resurrect state its adopter now owns. That failure needs a
two-process race to observe, so it will never be caught in review — this
checker makes it a lint failure instead:

  * DPOW901 — a Store write method is called with a ``replica:*`` key
    (literal, leading-literal f-string, module constant, or a fence key
    helper like ``member_key(...)``) outside ``replica/fence.py``.

Reads are exempt by design: a read cannot resurrect state, and the
registry/coordinator read membership and journals freely through fence.py's
read helpers.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional

from .core import Finding, Project, resolve_call

#: checker families this module contributes (aggregated into the registry in __init__.py)
FAMILIES = (("replica-key-fence", ("DPOW901",)),)


#: the single module allowed to write replica:* keys (package-dir-relative)
FENCE_MODULE = "replica/fence.py"

#: Store-protocol mutators (store/__init__.py Store ABC). Read-side methods
#: (get/hget/hgetall/smembers/keys/exists) are deliberately absent.
WRITE_METHODS = (
    "set",
    "setnx",
    "delete",
    "incrby",
    "hset",
    "hincrby",
    "sadd",
    "srem",
)

KEY_PREFIX = "replica:"

#: fence.py key builders: a write keyed by one of these OUTSIDE fence.py is
#: a replica:* write even though no literal appears at the call site.
KEY_HELPERS = ("member_key", "fence_key", "dispatch_key", "adopt_key")


def _fstring_prefix(node: ast.JoinedStr) -> Optional[str]:
    """The leading literal text of an f-string (None when it opens with a
    placeholder — such a key cannot be classified statically)."""
    if not node.values:
        return None
    head = node.values[0]
    if isinstance(head, ast.Constant) and isinstance(head.value, str):
        return head.value
    return None


def _key_repr(node: ast.AST, consts: Dict[str, str], aliases) -> Optional[str]:
    """The replica:* key (or helper call) this expression produces, rendered
    for the finding message — None when it is not a replica key."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value if node.value.startswith(KEY_PREFIX) else None
    if isinstance(node, ast.Name):
        val = consts.get(node.id)
        return val if val is not None and val.startswith(KEY_PREFIX) else None
    if isinstance(node, ast.JoinedStr):
        head = _fstring_prefix(node)
        if head is not None and head.startswith(KEY_PREFIX):
            return head + "…"
        return None
    if isinstance(node, ast.Call):
        target = resolve_call(node, aliases)
        if target is None:
            return None
        leaf = target.rsplit(".", 1)[-1]
        if leaf in KEY_HELPERS:
            return f"{leaf}(…)"
        return None
    return None


def check(project: Project) -> List[Finding]:
    findings: List[Finding] = []
    pkg = project.package_dir.rstrip("/") + "/"
    for src in project.sources():
        if src.rel == pkg + FENCE_MODULE:
            continue
        consts = project.constants(src)
        for node in src.nodes():
            if not (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in WRITE_METHODS
                and node.args
            ):
                continue
            key = _key_repr(node.args[0], consts, src.aliases)
            if key is None:
                continue
            findings.append(
                Finding(
                    src.rel,
                    node.lineno,
                    "DPOW901",
                    f"Store .{node.func.attr}() with replica key '{key}' "
                    f"outside {pkg}{FENCE_MODULE} — every replica:* write "
                    "must ride the FencedWriter / fence helpers so a "
                    "zombie replica's stale epoch bounces instead of "
                    "resurrecting adopted state (docs/replication.md)",
                )
            )
    return findings
