"""DPOW701-703 flag-drift: every --flag documented, defaults matching.

``server/config.py`` and ``client/config.py`` are the operator surface;
the package's flag table is its contract (generated once by this module's
``render_doc`` and kept honest by the checker ever after). The port's
table is ``tpu_dpow_torch/docs/flags.md``: its client takes ``--device``
and ``--backend torch``, which ``tpu_dpow``'s ``docs/flags.md`` does not
document. ``Project.doc`` reads the package's own ``docs/`` first.

  * DPOW701 — flag declared in a config but missing from its docs/flags.md
    section;
  * DPOW702 — docs/flags.md row whose flag no config declares;
  * DPOW703 — the documented default disagrees with the declared one.

Default resolution mirrors argparse: an explicit literal ``default=`` wins;
``default=c.field`` and store_true/false actions resolve through the
config dataclass; non-literal defaults (env overrides, computed
expressions) render as ``(computed)`` and required flags as ``(required)``.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from .core import Finding, Project

#: checker families this module contributes (aggregated into the registry in __init__.py)
FAMILIES = (("flag-drift", ("DPOW701", "DPOW702", "DPOW703")),)


FLAGS_DOC = "flags.md"

#: (section keyword in the docs header, config path under the package dir)
CONFIGS: Tuple[Tuple[str, str], ...] = (
    ("server", "server/config.py"),
    ("client", "client/config.py"),
    # the dpowsan CLI surface (analysis/sanitizer.py add_flags); the
    # analysis package is excluded from the code checkers but its flag
    # surface is an operator contract like any other
    ("sanitizer", "analysis/sanitizer.py"),
    # the load surfaces. "responder" MUST precede "loadgen": its doc
    # header names the module path (…loadgen.responder…), and section
    # matching takes the first keyword that appears in the header.
    ("responder", "loadgen/responder.py"),
    ("loadgen", "loadgen/config.py"),
    ("autoscale", "autoscale/config.py"),
)

_MISSING = object()

_ROW_RE = re.compile(r"^\|\s*`(--[a-z0-9_]+)`\s*\|\s*`?([^|`]*)`?\s*\|")


def _fold(node: ast.AST):
    """Literal constant folding for dataclass defaults (24*60*60.0 etc.)."""
    if isinstance(node, ast.Constant):
        return node.value
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        v = _fold(node.operand)
        return _MISSING if v is _MISSING else -v
    if isinstance(node, ast.BinOp) and isinstance(
        node.op, (ast.Add, ast.Sub, ast.Mult, ast.Div, ast.Pow)
    ):
        left, right = _fold(node.left), _fold(node.right)
        if left is _MISSING or right is _MISSING:
            return _MISSING
        try:
            if isinstance(node.op, ast.Add):
                return left + right
            if isinstance(node.op, ast.Sub):
                return left - right
            if isinstance(node.op, ast.Mult):
                return left * right
            if isinstance(node.op, ast.Div):
                return left / right
            return left**right
        except Exception:
            return _MISSING
    return _MISSING


def render_default(value) -> str:
    if value is _MISSING:
        return "(computed)"
    if value is None:
        return "None"
    if isinstance(value, bool):
        return "True" if value else "False"
    if isinstance(value, str):
        return value if value else '""'
    return repr(value)


@dataclass
class FlagInfo:
    flag: str
    default: str  # rendered
    help: str
    line: int


def _dataclass_defaults(tree: ast.Module) -> Dict[str, object]:
    out: Dict[str, object] = {}
    for node in ast.walk(tree):
        if not isinstance(node, ast.ClassDef):
            continue
        for stmt in node.body:
            if isinstance(stmt, ast.AnnAssign) and isinstance(stmt.target, ast.Name):
                out[stmt.target.id] = (
                    _fold(stmt.value) if stmt.value is not None else _MISSING
                )
    return out


def config_flags(project: Project, config_rel: str) -> List[FlagInfo]:
    # include_excluded: the sanitizer's flag surface lives under analysis/,
    # which the code checkers skip — the flag contract must not.
    src = next(
        (
            s
            for s in project.sources(include_excluded=True)
            if s.rel.endswith(config_rel)
        ),
        None,
    )
    if src is None:
        return []
    defaults = _dataclass_defaults(src.tree)
    flags: List[FlagInfo] = []
    for node in ast.walk(src.tree):
        if not (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "add_argument"
            and node.args
            and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, str)
            and node.args[0].value.startswith("--")
        ):
            continue
        flag = node.args[0].value
        kw = {k.arg: k.value for k in node.keywords if k.arg}
        dest = (
            kw["dest"].value
            if "dest" in kw and isinstance(kw["dest"], ast.Constant)
            else flag[2:]
        )
        if "required" in kw and getattr(kw["required"], "value", False) is True:
            rendered = "(required)"
        elif "default" in kw:
            d = kw["default"]
            folded = _fold(d)
            if folded is not _MISSING:
                rendered = render_default(folded)
            elif isinstance(d, ast.Attribute):
                rendered = render_default(defaults.get(d.attr, _MISSING))
            else:  # call (env override etc.) → the dataclass default
                rendered = render_default(defaults.get(dest, _MISSING))
        elif "action" in kw and getattr(kw["action"], "value", "") in (
            "store_true",
            "store_false",
        ):
            rendered = render_default(defaults.get(dest, _MISSING))
        else:
            rendered = render_default(defaults.get(dest, _MISSING))
        help_text = ""
        if "help" in kw:
            h = kw["help"]
            if isinstance(h, ast.Constant) and isinstance(h.value, str):
                help_text = " ".join(h.value.split())
        flags.append(FlagInfo(flag, rendered, help_text, node.lineno))
    return flags


def doc_flags(project: Project) -> Dict[str, Dict[str, Tuple[str, int]]]:
    """{section_key: {flag: (default, line)}} from docs/flags.md."""
    text = project.doc(FLAGS_DOC)
    out: Dict[str, Dict[str, Tuple[str, int]]] = {k: {} for k, _ in CONFIGS}
    if text is None:
        return out
    section: Optional[str] = None
    for i, line in enumerate(text.splitlines(), 1):
        if line.startswith("##"):
            lowered = line.lower()
            section = next((k for k, _ in CONFIGS if k in lowered), None)
            continue
        if section is None:
            continue
        m = _ROW_RE.match(line.strip())
        if m:
            out[section][m.group(1)] = (m.group(2).strip(), i)
    return out


def check(project: Project) -> List[Finding]:
    findings: List[Finding] = []
    documented = doc_flags(project)
    doc_path = project.doc_path(FLAGS_DOC)
    declared_by_section = {
        section: config_flags(project, config_rel)
        for section, config_rel in CONFIGS
    }
    if project.doc(FLAGS_DOC) is None:
        if any(declared_by_section.values()):
            findings.append(
                Finding(
                    doc_path,
                    1,
                    "DPOW701",
                    f"{doc_path} is missing — the operator flag surface "
                    "has no documented contract (generate with "
                    "tpu_dpow_torch.analysis.flags.render_doc)",
                )
            )
        return findings
    for section, config_rel in CONFIGS:
        declared = declared_by_section[section]
        if not declared:
            continue
        rows = documented.get(section, {})
        declared_names = {f.flag for f in declared}
        for f in declared:
            row = rows.get(f.flag)
            if row is None:
                findings.append(
                    Finding(
                        f"{project.package_dir}/{config_rel}",
                        f.line,
                        "DPOW701",
                        f"{f.flag} is declared here but missing from the "
                        f"{section} section of {doc_path}",
                    )
                )
            elif row[0] != f.default:
                findings.append(
                    Finding(
                        doc_path,
                        row[1],
                        "DPOW703",
                        f"{f.flag} documented default '{row[0]}' != declared "
                        f"default '{f.default}' ({config_rel})",
                    )
                )
        for flag, (_, line) in rows.items():
            if flag not in declared_names:
                findings.append(
                    Finding(
                        doc_path,
                        line,
                        "DPOW702",
                        f"{flag} is documented in the {section} section but "
                        f"{config_rel} declares no such flag",
                    )
                )
    return findings


def render_doc(project: Project) -> str:
    """Bootstrap/refresh helper: the full docs/flags.md content from the
    configs (meanings from help= strings; edit prose freely afterwards —
    the checker only reads the flag and default columns)."""
    lines = [
        "# Operator flags",
        "",
        "The argparse surface of the port's processes, one row",
        "per flag. **This file is machine-checked** (`python -m",
        "tpu_dpow_torch.analysis`, DPOW701-703,",
        "tpu_dpow_torch/docs/analysis.md): flags and the",
        "Default column must match the configs; the Meaning column is",
        "free-form prose.",
        "",
    ]
    titles = {
        "server": "Server flags (`python -m tpu_dpow_torch.server`, "
        "`tpu_dpow_torch/server/config.py`)",
        "client": "Client flags (`python -m tpu_dpow_torch.client`, "
        "`tpu_dpow_torch/client/config.py`)",
        "sanitizer": "Sanitizer flags (`python -m tpu_dpow_torch.analysis`, "
        "`tpu_dpow_torch/analysis/sanitizer.py`)",
        "responder": "Responder flags (`python -m "
        "tpu_dpow_torch.loadgen.responder`)",
        "loadgen": "Loadgen flags (`tpu_dpow_torch/loadgen/config.py`)",
        "autoscale": "Autoscale flags (`python -m tpu_dpow_torch.autoscale`, "
        "`tpu_dpow_torch/autoscale/config.py`)",
    }
    for section, config_rel in CONFIGS:
        lines += [f"## {titles.get(section, section)}", ""]
        lines += ["| Flag | Default | Meaning |", "|---|---|---|"]
        for f in config_flags(project, config_rel):
            help_text = f.help.replace("|", "\\|")
            lines.append(f"| `{f.flag}` | `{f.default}` | {help_text} |")
        lines.append("")
    return "\n".join(lines)
