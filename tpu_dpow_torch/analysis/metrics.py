"""DPOW501-504 metrics-contract: code and catalogue must agree.

Every ``dpow_*`` family the code registers (``reg.counter/gauge/histogram``
with a literal name) is cross-checked against the metric catalogue tables
in docs/ — both directions:

  * DPOW501 — registered in code, missing from every catalogue table;
  * DPOW502 — catalogued in docs, registered nowhere in code;
  * DPOW503 — label sets disagree between a call site and the catalogue;
  * DPOW504 — kind (counter/gauge/histogram) disagrees.

Docs are the operator's contract (dashboards and alerts are written against
them); hand-edited catalogues drift.
Module-level string constants are resolved (obs/trace.py registers its
histogram through one), so indirection does not hide a family.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from .core import Finding, Project

#: checker families this module contributes (aggregated into the registry in __init__.py)
FAMILIES = (("metrics-contract", ("DPOW501", "DPOW502", "DPOW503", "DPOW504")),)


#: catalogue locations, project docs_dir-relative
DOC_FILES = (
    "observability.md",
    "resilience.md",
    "admission.md",
    "fleet.md",
    "replication.md",
    "loadgen.md",
    "precache.md",
)

_KINDS = {"counter", "gauge", "histogram"}

#: | `dpow_x` | kind | labels | meaning |
_ROW_RE = re.compile(
    r"^\|\s*`(dpow_[a-z0-9_]+)`\s*\|\s*(counter|gauge|histogram)\s*\|([^|]*)\|"
)
_PAREN_RE = re.compile(r"\([^)]*\)")
_LABEL_RE = re.compile(r"`([a-zA-Z_][a-zA-Z0-9_]*)`")


@dataclass
class MetricSite:
    name: str
    kind: str
    labels: Optional[Tuple[str, ...]]  # None = not statically resolvable
    path: str
    line: int


@dataclass
class DocRow:
    name: str
    kind: str
    labels: Tuple[str, ...]
    doc: str
    line: int


def _const_str(node: ast.AST, consts: Dict[str, str]) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.Name):
        return consts.get(node.id)
    return None


def _labels_arg(call: ast.Call, consts: Dict[str, str]) -> Optional[Tuple[str, ...]]:
    node = None
    if len(call.args) >= 3:
        node = call.args[2]
    for kw in call.keywords:
        if kw.arg == "labelnames":
            node = kw.value
    if node is None:
        return ()
    if isinstance(node, (ast.Tuple, ast.List)):
        vals = [_const_str(e, consts) for e in node.elts]
        if all(v is not None for v in vals):
            return tuple(vals)  # type: ignore[arg-type]
    return None


def code_sites(project: Project) -> List[MetricSite]:
    sites: List[MetricSite] = []
    for src in project.sources():
        consts = project.constants(src)
        for node in src.nodes():
            if not (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _KINDS
            ):
                continue
            if not node.args:
                continue
            name = _const_str(node.args[0], consts)
            if name is None or not name.startswith("dpow_"):
                continue
            sites.append(
                MetricSite(
                    name,
                    node.func.attr,
                    _labels_arg(node, consts),
                    src.rel,
                    node.lineno,
                )
            )
    return sites


def doc_rows(project: Project) -> List[DocRow]:
    rows: List[DocRow] = []
    for fname in DOC_FILES:
        text = project.doc(fname)
        if text is None:
            continue
        for i, line in enumerate(text.splitlines(), 1):
            m = _ROW_RE.match(line.strip())
            if not m:
                continue
            labels_cell = _PAREN_RE.sub("", m.group(3))
            labels = tuple(_LABEL_RE.findall(labels_cell))
            rows.append(
                DocRow(m.group(1), m.group(2), labels, f"{project.docs_dir}/{fname}", i)
            )
    return rows


def check(project: Project) -> List[Finding]:
    findings: List[Finding] = []
    sites = code_sites(project)
    rows = doc_rows(project)
    documented: Dict[str, DocRow] = {}
    for r in rows:
        prev = documented.setdefault(r.name, r)
        if prev is not r:
            # ANY second row — identical content included — is a finding:
            # a duplicate silently voids the delete-one-row-fails-lint
            # guarantee (the other copy keeps the checker green).
            findings.append(
                Finding(
                    r.doc,
                    r.line,
                    "DPOW503",
                    f"{r.name} is catalogued twice (first at {prev.doc}:"
                    f"{prev.line}) — each family gets exactly one row",
                )
            )
    registered: Dict[str, MetricSite] = {}
    for s in sites:
        registered.setdefault(s.name, s)
        row = documented.get(s.name)
        if row is None:
            findings.append(
                Finding(
                    s.path,
                    s.line,
                    "DPOW501",
                    f"metric {s.name} is registered here but absent from "
                    f"every catalogue table ({', '.join(DOC_FILES)})",
                )
            )
            continue
        if s.kind != row.kind:
            findings.append(
                Finding(
                    s.path,
                    s.line,
                    "DPOW504",
                    f"metric {s.name} registered as {s.kind} but catalogued "
                    f"as {row.kind} ({row.doc}:{row.line})",
                )
            )
        if s.labels is not None and tuple(s.labels) != row.labels:
            findings.append(
                Finding(
                    s.path,
                    s.line,
                    "DPOW503",
                    f"metric {s.name} labels {list(s.labels)} != catalogued "
                    f"{list(row.labels)} ({row.doc}:{row.line})",
                )
            )
    for r in rows:
        if r.name not in registered and documented[r.name] is r:
            findings.append(
                Finding(
                    r.doc,
                    r.line,
                    "DPOW502",
                    f"metric {r.name} is catalogued but no code registers "
                    "it (stale row, or the family lost its literal name)",
                )
            )
    return findings
