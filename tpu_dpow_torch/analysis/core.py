"""dpowlint framework: sources, findings, waivers, baseline.

The port's own copy of ``tpu_dpow/analysis/core.py``. Its ``Project``
scans ``tpu_dpow_torch`` by default and reads a contract doc from the
package's own ``docs/`` first and the repo's ``docs/`` after it: the port
registers the same metric families, topics and owned resources as
``tpu_dpow``, so those catalogues are shared, while its flag table
(``tpu_dpow_torch/docs/flags.md``) is its own.

A checker is ``def check(project: Project) -> list[Finding]``. The Project
owns the parsed package sources and the doc/config paths the contract
checkers cross-reference, so tests can point a checker at a fixture tree
(or the real package with doctored docs) without monkeypatching.
"""

from __future__ import annotations

import ast
import io
import re
import sys
import tokenize
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Set, Tuple

#: comment syntax: ``# dpowlint: disable=DPOW101[,DPOW201] — justification``
#: A waiver applies to its own line and to the line directly below it (so a
#: standalone comment can sit above a long statement). The justification is
#: REQUIRED: a suppression nobody explained is unreviewable, and the meta
#: pass (DPOW002) flags waivers whose trailing text is empty.
WAIVER_RE = re.compile(r"#\s*dpowlint:\s*disable=([A-Z0-9,\s]+)(?:[—–:-]+\s*(.*))?")


@dataclass(frozen=True)
class Finding:
    path: str  # project-root-relative, forward slashes
    line: int
    code: str  # DPOWnnn
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}  {self.code}  {self.message}"

    def key(self) -> str:
        """Line-number-free fingerprint: baselined findings must survive
        unrelated edits shifting the file."""
        return f"{self.path}  {self.code}  {self.message}"


class SourceFile:
    """One parsed .py file: AST + the waiver comments tokenize found.

    The AST is parsed exactly once and shared by every checker; the two
    traversals every checker family needs — the flat node list and the
    import-alias map — are computed lazily and cached here too, so a run
    of 10+ checker families costs one parse and one full walk per file,
    not one per (file, checker) pair.
    """

    def __init__(self, path: Path, rel: str):
        self.path = path
        self.rel = rel
        self.text = path.read_text(encoding="utf-8")
        self.tree = ast.parse(self.text, filename=rel)
        self._nodes: Optional[List[ast.AST]] = None
        self._aliases: Optional[Dict[str, str]] = None
        self.waivers: Dict[int, Set[str]] = {}
        #: line → the waiver's trailing justification text ("" when the
        #: author wrote none — the meta pass flags those)
        self.waiver_notes: Dict[int, str] = {}
        try:
            tokens = tokenize.generate_tokens(io.StringIO(self.text).readline)
            for tok in tokens:
                if tok.type != tokenize.COMMENT:
                    continue
                m = WAIVER_RE.search(tok.string)
                if m:
                    codes = {c.strip() for c in m.group(1).split(",") if c.strip()}
                    ln = tok.start[0]
                    self.waivers.setdefault(ln, set()).update(codes)
                    note = (m.group(2) or "").strip()
                    if note or ln not in self.waiver_notes:
                        self.waiver_notes[ln] = note
        except tokenize.TokenError:
            pass

    def nodes(self) -> List[ast.AST]:
        """Every node of the tree, walk order, computed once. Checkers that
        scan for a node type iterate this instead of re-walking the AST."""
        if self._nodes is None:
            self._nodes = list(ast.walk(self.tree))
        return self._nodes

    @property
    def aliases(self) -> Dict[str, str]:
        """``import_aliases(self.tree)``, computed once per file."""
        if self._aliases is None:
            self._aliases = import_aliases(self.tree, self.nodes())
        return self._aliases

    def waived(self, code: str, line: int) -> bool:
        for ln in (line, line - 1):
            if code in self.waivers.get(ln, ()) or "ALL" in self.waivers.get(ln, ()):
                return True
        return False


def _module_constants(tree: ast.Module) -> Dict[str, str]:
    """Top-level ``NAME = "literal"`` assignments (metric/topic constants)."""
    out: Dict[str, str] = {}
    for node in tree.body:
        if (
            isinstance(node, ast.Assign)
            and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
            and isinstance(node.value, ast.Constant)
            and isinstance(node.value.value, str)
        ):
            out[node.targets[0].id] = node.value.value
    return out


def import_aliases(tree, nodes: Optional[Iterable[ast.AST]] = None) -> Dict[str, str]:
    """Map local names to dotted origins: ``import time as t`` → t: time;
    ``from asyncio import sleep`` → sleep: asyncio.sleep."""
    aliases: Dict[str, str] = {}
    for node in nodes if nodes is not None else ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                aliases[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0]
                )
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            for a in node.names:
                aliases[a.asname or a.name] = f"{node.module}.{a.name}"
    return aliases


def dotted_name(node: ast.AST) -> Optional[str]:
    """Render Name/Attribute chains as ``a.b.c`` (None for anything else)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def resolve_call(node: ast.Call, aliases: Dict[str, str]) -> Optional[str]:
    """The call target's dotted origin after import aliasing: a call to
    ``t.sleep`` with ``import time as t`` resolves to ``time.sleep``."""
    name = dotted_name(node.func)
    if name is None:
        return None
    head, _, rest = name.partition(".")
    origin = aliases.get(head)
    if origin:
        return f"{origin}.{rest}" if rest else origin
    return name


class Project:
    """The tree under analysis. ``package_dir``/``docs_dir`` are overridable
    so fixture tests can run one checker against a synthetic layout."""

    def __init__(
        self,
        root,
        package_dir: str = "tpu_dpow_torch",
        docs_dir: str = "docs",
        setup_users: str = "setup/broker/users.json",
        exclude: Tuple[str, ...] = ("analysis/",),
    ):
        self.root = Path(root)
        self.package_dir = package_dir
        self.docs_dir = docs_dir
        self.setup_users = setup_users
        self.exclude = exclude
        self._sources: Optional[List[SourceFile]] = None

    # -- sources -------------------------------------------------------

    def sources(self, include_excluded: bool = False) -> List[SourceFile]:
        if self._sources is None:
            files = sorted((self.root / self.package_dir).rglob("*.py"))
            out = []
            for f in files:
                if "__pycache__" in f.parts:
                    continue
                rel = f.relative_to(self.root).as_posix()
                out.append(SourceFile(f, rel))
            self._sources = out
        if include_excluded:
            return list(self._sources)
        pkg = self.package_dir.rstrip("/") + "/"
        return [
            s
            for s in self._sources
            if not any(s.rel.startswith(pkg + e) for e in self.exclude)
        ]

    def doc_path(self, name: str) -> str:
        """Root-relative path of the contract doc ``name``: the package's
        own ``docs/`` copy when it has one, else the shared ``docs_dir``."""
        own = f"{self.package_dir.rstrip('/')}/docs/{name}"
        if (self.root / own).exists():
            return own
        return f"{self.docs_dir}/{name}"

    def doc(self, name: str) -> Optional[str]:
        p = self.root / self.doc_path(name)
        return p.read_text(encoding="utf-8") if p.exists() else None

    def constants(self, src: SourceFile) -> Dict[str, str]:
        return _module_constants(src.tree)


# -- baseline ----------------------------------------------------------


@dataclass
class Baseline:
    """Committed debt file: one ``Finding.key()`` per line. Entries must
    carry a trailing ``  # why`` justification to be legible in review;
    ``#`` lines and blanks are ignored."""

    entries: Set[str] = field(default_factory=set)

    @classmethod
    def load(cls, path) -> "Baseline":
        entries: Set[str] = set()
        p = Path(path)
        if p.exists():
            for raw in p.read_text(encoding="utf-8").splitlines():
                line = raw.split(" # ")[0].strip() if " # " in raw else raw.strip()
                if line and not line.startswith("#"):
                    entries.add(line)
        return cls(entries)

    def save(self, path, findings: Iterable[Finding]) -> None:
        lines = [
            "# dpowlint baseline: accepted findings (python -m tpu_dpow_torch.analysis",
            "# --write-baseline). Every entry is intentional debt and should",
            '# carry a trailing " # why". Keep this file empty when you can.',
        ]
        lines += sorted(f.key() for f in findings)
        Path(path).write_text("\n".join(lines) + "\n", encoding="utf-8")

    def covers(self, finding: Finding) -> bool:
        return finding.key() in self.entries


DEFAULT_BASELINE = "baseline.txt"  # sibling of this module

#: meta-code: an inline waiver that suppresses zero findings, or names a
#: code no registered checker can emit, is itself a finding — stale
#: waivers read as active contracts in review and hide real regressions
#: behind the day the checker (or the code beneath it) changed.
CODE_STALE_WAIVER = "DPOW002"


def _consume_waiver(src: SourceFile, finding: Finding, consumed: Dict) -> bool:
    """``src.waived`` with bookkeeping: record WHICH waiver line and code
    suppressed the finding, so run_all can flag the ones that earn
    nothing. Mirrors the waived() line/line-above rule exactly."""
    for ln in (finding.line, finding.line - 1):
        codes = src.waivers.get(ln, ())
        if finding.code in codes:
            consumed.setdefault((src.rel, ln), set()).add(finding.code)
            return True
        if "ALL" in codes:
            consumed.setdefault((src.rel, ln), set()).add("ALL")
            return True
    return False


def _stale_waiver_findings(
    project: Project, consumed: Dict, known_codes, emittable
) -> List[Finding]:
    """DPOW002 for every waiver entry that suppressed nothing or names an
    unknown code. Staleness ('suppresses zero findings') is judged ONLY
    for codes in ``emittable`` — the codes the checkers that actually ran
    can produce: a DPOW801 waiver is not stale just because a caller ran
    the clock checker alone. DPOW002 itself may appear in a waiver list
    as an escape hatch for deliberately-preventive waivers and is never
    judged stale (no fixpoint: second-order staleness is not a thing)."""
    out: List[Finding] = []
    for src in project.sources():
        for ln in sorted(src.waivers):
            earned = consumed.get((src.rel, ln), set())
            for code in sorted(src.waivers[ln]):
                if code == CODE_STALE_WAIVER:
                    continue
                if code == "ALL" and not emittable:
                    continue
                if code not in known_codes:
                    out.append(
                        Finding(
                            src.rel,
                            ln,
                            CODE_STALE_WAIVER,
                            f"waiver names unknown code '{code}': no "
                            "registered checker can emit it, so it "
                            "suppresses nothing — fix the code name or "
                            "delete the waiver",
                        )
                    )
                elif code != "ALL" and code not in emittable:
                    continue  # its checker did not run: no staleness verdict
                elif code not in earned:
                    out.append(
                        Finding(
                            src.rel,
                            ln,
                            CODE_STALE_WAIVER,
                            f"stale waiver: 'disable={code}' suppresses "
                            "zero findings on this line — the hazard it "
                            "documented is gone (or moved); delete the "
                            "waiver so the justification stops reading "
                            "as a live contract",
                        )
                    )
    return out


#: recorded inline-waiver budget, sibling of baseline.txt. The file holds
#: the TOTAL number of inline waiver lines across the scanned package;
#: when present, any drift between the live count and the record is a
#: DPOW002 finding — so adding a waiver forces the author to (a) write a
#: justification on the line and (b) bump the budget in the same change,
#: making suppression growth reviewable instead of silent. Absent file =
#: unenforced (fixture projects in tests are unaffected).
WAIVER_BUDGET_FILE = "waivers.txt"


def _waiver_discipline_findings(project: Project) -> List[Finding]:
    """DPOW002 for (a) waivers with no written justification and (b) a
    live waiver count that drifted from the recorded budget."""
    out: List[Finding] = []
    total = 0
    for src in project.sources():
        for ln in sorted(src.waivers):
            total += 1
            if not src.waiver_notes.get(ln, ""):
                out.append(
                    Finding(
                        src.rel,
                        ln,
                        CODE_STALE_WAIVER,
                        "waiver carries no written justification — every "
                        "suppression must say why ('# dpowlint: "
                        "disable=CODE — reason'); an unexplained waiver "
                        "is unreviewable",
                    )
                )
    budget_path = (
        project.root / project.package_dir / "analysis" / WAIVER_BUDGET_FILE
    )
    if not budget_path.exists():
        return out
    rel = budget_path.relative_to(project.root).as_posix()
    recorded: Optional[int] = None
    for raw in budget_path.read_text(encoding="utf-8").splitlines():
        line = raw.strip()
        if line and not line.startswith("#"):
            try:
                recorded = int(line)
            except ValueError:
                recorded = None
            break
    if recorded is None:
        out.append(
            Finding(
                rel,
                1,
                CODE_STALE_WAIVER,
                "waiver budget file is unparseable: the first "
                "non-comment line must be the total inline-waiver count",
            )
        )
    elif total != recorded:
        verb = "grew" if total > recorded else "shrank"
        out.append(
            Finding(
                rel,
                1,
                CODE_STALE_WAIVER,
                f"inline waiver count {verb} to {total} but the recorded "
                f"budget is {recorded} — a new waiver needs a written "
                "justification AND a budget bump in the same change "
                "(a removed one, the matching decrement), so suppression "
                "growth stays reviewable",
            )
        )
    return out


def run_all(project: Project, checkers=None, known_codes=None) -> List[Finding]:
    """Every checker over the project; inline-waived findings removed
    (each suppression is ACCOUNTED: a waiver that earns nothing, or names
    an unknown code, surfaces as DPOW002), baseline NOT applied (that is
    the CLI's job)."""
    if checkers is None:
        from . import CHECKERS

        checkers = CHECKERS
    if known_codes is None:
        from . import KNOWN_CODES

        known_codes = KNOWN_CODES
    # the codes the checkers that will actually RUN can emit — staleness
    # judgments are scoped to these (derived from each check function's
    # module FAMILIES declaration; an unknown custom checker contributes
    # nothing and therefore never triggers a staleness verdict).
    emittable: Set[str] = set()
    for check in checkers:
        mod = sys.modules.get(getattr(check, "__module__", ""))
        for _name, cs in getattr(mod, "FAMILIES", ()):
            emittable.update(cs)
    by_rel = {s.rel: s for s in project.sources(include_excluded=True)}
    consumed: Dict[Tuple[str, int], Set[str]] = {}
    out: List[Finding] = []
    for check in checkers:
        for f in check(project):
            src = by_rel.get(f.path)
            if src is not None and _consume_waiver(src, f, consumed):
                continue
            out.append(f)
    meta = _stale_waiver_findings(project, consumed, known_codes, emittable)
    meta += _waiver_discipline_findings(project)
    for f in meta:
        src = by_rel.get(f.path)
        # Only an EXPLICIT DPOW002 co-waiver may silence the meta-pass —
        # a blanket ALL must not suppress its own staleness finding.
        if src is not None and any(
            CODE_STALE_WAIVER in src.waivers.get(ln, ())
            for ln in (f.line, f.line - 1)
        ):
            continue
        out.append(f)
    return sorted(out, key=lambda f: (f.path, f.line, f.code, f.message))
