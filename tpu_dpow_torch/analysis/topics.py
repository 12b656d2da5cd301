"""DPOW601-606 topic/ACL/payload-contract: the wire grammar stays machine-checked.

The MQTT topic table in docs/specification.md is the swarm's wire contract,
and the ACL matrix exists in THREE places that must agree: the spec table,
the deployable ``setup/broker/users.json`` template, and the in-code
defaults (``transport.default_users``). Hand-extending two of the three
for ``fleet/announce`` and the ``work/{type}/{worker_id}`` lanes — this
checker makes that drift a lint failure instead of an incident:

  * DPOW601 — topic used in code but absent from the spec summary table;
  * DPOW602 — spec summary row no code publishes, subscribes, or builds;
  * DPOW603 — code publish/subscribe not permitted by any users.json ACL;
  * DPOW604 — ACL matrix drift between spec table / users.json / defaults.

The payload grammar is checked the same both-ways way: the binary
wire codec's frame catalogue (``transport/wire.py`` FRAME_GRAMMAR — one
header byte + body layout per kind) must match the binary-frame table in
docs/specification.md field-for-field:

  * DPOW605 — frame kind in code missing from the spec table, or its
    header byte / body layout drifted from the documented row;
  * DPOW606 — spec binary-frame row no code declares.

Topic extraction is static: literal or f-string arguments of
``.publish(...)``/``.subscribe(...)``, any f-string whose leading text is a
known topic root (the ``work_topic`` helper idiom), and module-level topic
constants. F-string placeholders normalize to ``+`` (one segment).
"""

from __future__ import annotations

import ast
import json
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

from .core import Finding, Project

#: checker families this module contributes (aggregated into the registry in __init__.py)
FAMILIES = (
    ("topic-contract", ("DPOW601", "DPOW602", "DPOW603", "DPOW604")),
    ("payload-grammar", ("DPOW605", "DPOW606")),
)


SPEC_DOC = "specification.md"
ROOTS = ("work", "result", "cancel", "client", "fleet", "replica")
BARE_TOPICS = {"heartbeat", "statistics"}

_SEGMENT_RE = re.compile(r"^[A-Za-z0-9_.+-]+$")


def _valid_topic(t: str) -> bool:
    if t in BARE_TOPICS:
        return True
    segs = t.split("/")
    if len(segs) < 2 or segs[0] not in ROOTS:
        return False
    for i, s in enumerate(segs):
        if s == "#" and i == len(segs) - 1:
            continue
        if not _SEGMENT_RE.match(s):
            return False
    return True


def overlap(a: str, b: str) -> bool:
    """Can one concrete topic match both patterns? ``+`` = one segment,
    trailing ``#`` = any remainder."""
    sa, sb = a.split("/"), b.split("/")
    for i in range(max(len(sa), len(sb))):
        ea = sa[i] if i < len(sa) else None
        eb = sb[i] if i < len(sb) else None
        if ea == "#" or eb == "#":
            return True
        if ea is None or eb is None:
            return False
        if ea != eb and ea != "+" and eb != "+":
            return False
    return True


@dataclass
class TopicUse:
    topic: str
    op: str  # "publish" | "subscribe" | "mention"
    path: str
    line: int


# -- code extraction ---------------------------------------------------


def _fstring_topic(node: ast.JoinedStr) -> Optional[str]:
    parts: List[str] = []
    for v in node.values:
        if isinstance(v, ast.Constant) and isinstance(v.value, str):
            parts.append(v.value)
        elif isinstance(v, ast.FormattedValue):
            parts.append("\x00")
        else:
            return None
    flat = "".join(parts)
    if any(c.isspace() for c in flat):
        return None
    topic = "/".join(
        "+" if "\x00" in seg else seg for seg in flat.split("/")
    )
    return topic if _valid_topic(topic) else None


def _literal_topic(node: ast.AST, consts: Dict[str, str]) -> Optional[str]:
    if isinstance(node, ast.JoinedStr):
        return _fstring_topic(node)
    val = None
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        val = node.value
    elif isinstance(node, ast.Name):
        val = consts.get(node.id)
    return val if val is not None and _valid_topic(val) else None


def code_uses(project: Project) -> List[TopicUse]:
    uses: List[TopicUse] = []
    for src in project.sources():
        consts = project.constants(src)
        explicit_args = set()
        for node in src.nodes():
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in ("publish", "subscribe")
                and node.args
            ):
                topic = _literal_topic(node.args[0], consts)
                if topic is not None:
                    explicit_args.add(id(node.args[0]))
                    uses.append(
                        TopicUse(topic, node.func.attr, src.rel, node.lineno)
                    )
        for node in src.nodes():
            if isinstance(node, ast.JoinedStr) and id(node) not in explicit_args:
                topic = _fstring_topic(node)
                if topic is not None:
                    uses.append(TopicUse(topic, "mention", src.rel, node.lineno))
        for name, val in consts.items():
            if "/" in val and _valid_topic(val) and "#" not in val:
                line = next(
                    (
                        n.lineno
                        for n in src.tree.body
                        if isinstance(n, ast.Assign)
                        and isinstance(n.targets[0], ast.Name)
                        and n.targets[0].id == name
                    ),
                    1,
                )
                uses.append(TopicUse(val, "mention", src.rel, line))
    return uses


# -- docs / ACL sources ------------------------------------------------


def _cells(line: str) -> List[str]:
    return [c.strip() for c in line.strip().strip("|").split("|")]


def _row_topic(cell: str) -> Optional[str]:
    """Summary-table cell → pattern: backticked segments are placeholders."""
    segs = cell.split("/")
    out = []
    for s in segs:
        s = s.strip()
        if s.startswith("`") and s.endswith("`"):
            out.append("+")
        elif _SEGMENT_RE.match(s):
            out.append(s)
        else:
            return None
    topic = "/".join(out)
    return topic if _valid_topic(topic) else None


def spec_rows(project: Project) -> List[Tuple[str, int]]:
    """(topic_pattern, line) rows of the spec's Summary table."""
    text = project.doc(SPEC_DOC)
    rows: List[Tuple[str, int]] = []
    if text is None:
        return rows
    for i, line in enumerate(text.splitlines(), 1):
        if not line.lstrip().startswith("|"):
            continue
        cells = _cells(line)
        if len(cells) < 3 or set(cells[0]) <= {"-", " ", ":"}:
            continue
        if "/" not in cells[0] and cells[0] not in BARE_TOPICS:
            continue
        topic = _row_topic(cells[0])
        if topic is not None:
            rows.append((topic, i))
    return rows


def _acl_cell(cell: str) -> Tuple[str, ...]:
    cell = cell.replace("`", "").strip()
    if cell in ("", "—", "-"):
        return ()
    return tuple(p.strip() for p in cell.split(",") if p.strip())


def spec_acls(project: Project) -> Dict[str, Dict[str, Tuple[str, ...]]]:
    """User → {pub, sub} from the spec's Broker-access-control table."""
    text = project.doc(SPEC_DOC)
    out: Dict[str, Dict[str, Tuple[str, ...]]] = {}
    if text is None:
        return out
    in_section = False
    for line in text.splitlines():
        if line.startswith("##"):
            in_section = "access control" in line.lower()
            continue
        if not in_section or not line.lstrip().startswith("|"):
            continue
        cells = _cells(line)
        if len(cells) < 3 or set(cells[0]) <= {"-", " ", ":"}:
            continue
        user = cells[0].strip("`")
        if user.lower() in ("user", "") or "/" in user:
            continue
        out[user] = {"pub": _acl_cell(cells[1]), "sub": _acl_cell(cells[2])}
    return out


def users_json_acls(project: Project) -> Optional[Dict[str, Dict[str, Tuple[str, ...]]]]:
    p = project.root / project.setup_users
    if not p.exists():
        return None
    data = json.loads(p.read_text(encoding="utf-8"))
    out: Dict[str, Dict[str, Tuple[str, ...]]] = {}
    for user, rec in data.items():
        if not isinstance(rec, dict) or user.startswith("_"):
            continue
        out[user] = {
            "pub": tuple(rec.get("acl_pub", ())),
            "sub": tuple(rec.get("acl_sub", ())),
        }
    return out


def default_users_acls(project: Project) -> Optional[Dict[str, Dict[str, Tuple[str, ...]]]]:
    """The in-code ACL defaults (transport/__init__.py default_users)."""
    src = next(
        (
            s
            for s in project.sources()
            if s.rel.endswith("transport/__init__.py")
        ),
        None,
    )
    if src is None:
        return None
    out: Dict[str, Dict[str, Tuple[str, ...]]] = {}
    for node in src.nodes():
        if not isinstance(node, ast.Dict):
            continue
        for key, value in zip(node.keys, node.values):
            if not (
                isinstance(key, ast.Constant)
                and isinstance(key.value, str)
                and isinstance(value, ast.Call)
                and getattr(value.func, "id", getattr(value.func, "attr", None))
                == "User"
            ):
                continue
            rec = {"pub": (), "sub": ()}
            for kw in value.keywords:
                if kw.arg in ("acl_pub", "acl_sub") and isinstance(
                    kw.value, (ast.Tuple, ast.List)
                ):
                    vals = tuple(
                        e.value
                        for e in kw.value.elts
                        if isinstance(e, ast.Constant) and isinstance(e.value, str)
                    )
                    rec["pub" if kw.arg == "acl_pub" else "sub"] = vals
            out[key.value] = rec
    return out or None


# -- binary frame grammar (DPOW605/606) --------------------------------

#: package-dir-relative home of the binary codec's grammar literal
WIRE_SOURCE = "transport/wire.py"

#: | kind | `0xNN` | `layout` | rows of the spec's binary-frame table
_FRAME_ROW_RE = re.compile(
    r"^\|\s*`?([a-z][a-z0-9_]*)`?\s*\|\s*`?0x([0-9a-fA-F]{2})`?\s*\|\s*`?([^|`]*)`?\s*\|"
)


def frame_grammar_code(
    project: Project,
) -> Optional[Tuple[Dict[str, Tuple[int, str]], str, Dict[str, int]]]:
    """The FRAME_GRAMMAR literal out of transport/wire.py:
    (kind → (header byte, layout), source rel path, kind → line). None when
    the module or the literal is absent (pre-v1 trees, fixtures)."""
    src = next(
        (s for s in project.sources() if s.rel.endswith(WIRE_SOURCE)), None
    )
    if src is None:
        return None
    for node in src.tree.body:
        if not (
            isinstance(node, ast.Assign)
            and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
            and node.targets[0].id == "FRAME_GRAMMAR"
        ):
            continue
        try:
            value = ast.literal_eval(node.value)
        except ValueError:
            return None
        if not isinstance(value, dict):
            return None
        lines: Dict[str, int] = {}
        if isinstance(node.value, ast.Dict):
            for k in node.value.keys:
                if isinstance(k, ast.Constant) and isinstance(k.value, str):
                    lines[k.value] = k.lineno
        out: Dict[str, Tuple[int, str]] = {}
        for kind, spec in value.items():
            if (
                isinstance(kind, str)
                and isinstance(spec, tuple)
                and len(spec) == 2
            ):
                out[kind] = (int(spec[0]), str(spec[1]))
        return out, src.rel, lines
    return None


def spec_frames(project: Project) -> Dict[str, Tuple[int, str, int]]:
    """kind → (header byte, layout, line) from the spec's binary-frame
    table (any markdown table whose second column is a `0xNN` byte)."""
    text = project.doc(SPEC_DOC)
    out: Dict[str, Tuple[int, str, int]] = {}
    if text is None:
        return out
    for i, line in enumerate(text.splitlines(), 1):
        m = _FRAME_ROW_RE.match(line.strip())
        if m:
            out[m.group(1)] = (int(m.group(2), 16), m.group(3).strip(), i)
    return out


# -- the check ---------------------------------------------------------

#: which broker principal a module subtree runs as (package-dir-relative
#: prefix → users.json names, in preference order). A site whose subtree is
#: unmapped — or whose mapped users are absent from the ACL file, as in
#: fixture projects — is checked against every user's grants instead: the
#: broker will reject a publish the PRINCIPAL lacks even when another user
#: could have made it.
PRINCIPALS: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
    ("server/", ("dpowserver",)),
    ("fleet/", ("dpowserver",)),
    # orchestrator replicas connect as dpowserver too: the replica plane
    # (replica/dispatch/{id} forwards, result/{id}/{type} relays) is
    # server↔server traffic (docs/replication.md)
    ("replica/", ("dpowserver",)),
    ("client/", ("client",)),
    ("scripts/check_latency", ("dpowinterface",)),
)


def _principals_for(rel: str, project: Project, acls) -> str:
    pkg = project.package_dir.rstrip("/") + "/"
    sub = rel[len(pkg):] if rel.startswith(pkg) else rel
    for prefix, users in PRINCIPALS:
        if sub.startswith(prefix):
            named = [u for u in users if u in acls]
            if named:
                return "/".join(named)
    return "any user"


def _grants_for(rel: str, project: Project, acls, op: str) -> List[str]:
    pkg = project.package_dir.rstrip("/") + "/"
    sub = rel[len(pkg):] if rel.startswith(pkg) else rel
    for prefix, users in PRINCIPALS:
        if sub.startswith(prefix):
            named = [u for u in users if u in acls]
            if named:
                return [p for u in named for p in acls[u][op]]
    return [p for rec in acls.values() for p in rec[op]]


def check(project: Project) -> List[Finding]:
    findings: List[Finding] = []
    uses = code_uses(project)
    rows = spec_rows(project)
    spec_path = f"{project.docs_dir}/{SPEC_DOC}"
    have_spec = project.doc(SPEC_DOC) is not None

    if have_spec:
        for u in uses:
            if not any(overlap(u.topic, row) for row, _ in rows):
                findings.append(
                    Finding(
                        u.path,
                        u.line,
                        "DPOW601",
                        f"topic '{u.topic}' ({u.op}) is not covered by any "
                        f"row of the {spec_path} summary table",
                    )
                )
        seen: Set[str] = set()
        for row, line in rows:
            if row in seen:
                continue
            seen.add(row)
            if not any(overlap(u.topic, row) for u in uses):
                findings.append(
                    Finding(
                        spec_path,
                        line,
                        "DPOW602",
                        f"spec topic '{row}' is not published, subscribed, "
                        "or built anywhere in the package",
                    )
                )

    code_frames = frame_grammar_code(project)
    if code_frames is not None and have_spec:
        grammar, wire_rel, lines = code_frames
        doc_frames = spec_frames(project)
        for kind, (byte, layout) in sorted(grammar.items()):
            row = doc_frames.get(kind)
            line = lines.get(kind, 1)
            if row is None:
                findings.append(
                    Finding(
                        wire_rel,
                        line,
                        "DPOW605",
                        f"binary frame kind '{kind}' (0x{byte:02x}) is not "
                        f"catalogued in the {spec_path} binary-frame table",
                    )
                )
            elif (row[0], row[1]) != (byte, layout):
                findings.append(
                    Finding(
                        wire_rel,
                        line,
                        "DPOW605",
                        f"binary frame '{kind}' drifted: code has "
                        f"0x{byte:02x} {layout!r} but {spec_path}:{row[2]} "
                        f"documents 0x{row[0]:02x} {row[1]!r}",
                    )
                )
        for kind, (byte, layout, line) in sorted(doc_frames.items()):
            if kind not in grammar:
                findings.append(
                    Finding(
                        spec_path,
                        line,
                        "DPOW606",
                        f"spec binary frame '{kind}' (0x{byte:02x}) does "
                        f"not exist in {WIRE_SOURCE} FRAME_GRAMMAR",
                    )
                )

    acls = users_json_acls(project)
    if acls is not None:
        # ACL checks use the broker's own CONTAINMENT semantics
        # (transport.pattern_covers), not overlap: a grant must cover every
        # topic the code site can produce — overlap would wrongly pass a
        # subscription broader than its grant (e.g. code 'fleet/#' against
        # a grant of only 'fleet/announce'), which the live broker rejects
        # with AuthError. Normalized f-string placeholders ('+') get the
        # same treatment: the grant must cover all instantiations.
        from ..transport import pattern_covers

        for u in uses:
            if u.op not in ("publish", "subscribe"):
                continue
            grants = _grants_for(
                u.path, project, acls, "pub" if u.op == "publish" else "sub"
            )
            if not any(pattern_covers(p, u.topic) for p in grants):
                who = _principals_for(u.path, project, acls)
                findings.append(
                    Finding(
                        u.path,
                        u.line,
                        "DPOW603",
                        f"{u.op} '{u.topic}' is not permitted by "
                        f"{'acl_pub' if u.op == 'publish' else 'acl_sub'} "
                        f"of {who} in {project.setup_users}",
                    )
                )

    sources = {
        spec_path: spec_acls(project) if have_spec else None,
        project.setup_users: acls,
        f"{project.package_dir}/transport/__init__.py": default_users_acls(project),
    }
    present = {k: v for k, v in sources.items() if v}
    if len(present) >= 2:
        names = sorted(present)
        ref_name = names[0]
        ref = present[ref_name]
        for other_name in names[1:]:
            other = present[other_name]
            for user in sorted(set(ref) | set(other)):
                a, b = ref.get(user), other.get(user)
                if a is None or b is None:
                    findings.append(
                        Finding(
                            other_name if b is None else ref_name,
                            1,
                            "DPOW604",
                            f"ACL user '{user}' missing from "
                            f"{other_name if b is None else ref_name} but "
                            f"present in the other ACL sources",
                        )
                    )
                    continue
                for op in ("pub", "sub"):
                    if set(a[op]) != set(b[op]):
                        findings.append(
                            Finding(
                                other_name,
                                1,
                                "DPOW604",
                                f"ACL drift for '{user}' acl_{op}: "
                                f"{ref_name} has {sorted(set(a[op]))} but "
                                f"{other_name} has {sorted(set(b[op]))}",
                            )
                        )
    return findings
