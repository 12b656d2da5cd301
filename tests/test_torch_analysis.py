"""dpowlint and dpowsan of the port (``tpu_dpow_torch/analysis``) against
``tpu_dpow/analysis``.

* Fixture parity: every fixture project ``tests/test_analysis.py`` builds
  is laid out twice, under ``tpu_dpow/`` for the reference and under
  ``tpu_dpow_torch/`` for the port, and every checker of each package runs
  over its copy: the (package-relative path, line, code) findings must be
  equal. DPOW1002 is the one rule that differs by design (the port's reads
  torch device syncs on the event loop, not jax traced values), so it is
  compared apart: the port's never fires on the reference's jax fixtures.
* Both trees, the registries, the CLI, and the port's own DPOW1001,
  DPOW1002 and DPOW101 behaviour.
* dpowsan: the five hub scenarios give the same interleaving trace (and
  LeakLedger trace) in both packages seed for seed; the device-fault
  scenario is clean on the CPU's plain version, and on the card (marker
  ``cuda``, skipped here) on the run kernel.
"""

import ast
import importlib.util
import json
import logging
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import pytest
import torch

from tpu_dpow.analysis import CHECKERS as REF_CHECKERS
from tpu_dpow.analysis import FAMILIES as REF_FAMILIES
from tpu_dpow.analysis import KNOWN_CODES as REF_KNOWN_CODES
from tpu_dpow.analysis import sanitizer as ref_sanitizer
from tpu_dpow.analysis.core import Project as RefProject
from tpu_dpow.analysis.core import run_all as ref_run_all
from tpu_dpow_torch.analysis import CHECKERS, FAMILIES, KNOWN_CODES, clock, sanitizer, tracing
from tpu_dpow_torch.analysis.core import Baseline, Finding, Project, run_all
from tpu_dpow_torch.ops import cuda_kernel

REPO_ROOT = Path(__file__).resolve().parents[1]
PORT = "tpu_dpow_torch"
REF = "tpu_dpow"
HUB_SCENARIOS = ("coalesce", "fleet_recover", "takeover", "autoscale", "precache")


def _layout(root: Path, files: dict) -> None:
    for rel, content in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(content, encoding="utf-8")


def _to_port(text: str) -> str:
    """``tpu_dpow`` → ``tpu_dpow_torch`` in a path or a source, leaving the
    port's own name alone (``\\b`` does not split ``tpu_dpow_torch``)."""
    return re.sub(r"\btpu_dpow\b", PORT, text)


# ---------------------------------------------------------------------------
# fixture parity: record the fixtures tests/test_analysis.py builds
# ---------------------------------------------------------------------------


def _record_reference_fixtures() -> list:
    """Run every test of tests/test_analysis.py that builds a fixture
    project (through ``make_project`` or a helper that calls it), with
    ``make_project`` wrapped to record its files and keywords. Returns
    ``[(case id, files, kw)]`` in source order: one case per fixture."""
    path = REPO_ROOT / "tests" / "test_analysis.py"
    spec = importlib.util.spec_from_file_location("_reference_test_analysis", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    tree = ast.parse(path.read_text(encoding="utf-8"))
    defs = [n for n in tree.body if isinstance(n, ast.FunctionDef)]

    def calls(fn, names):
        return any(
            isinstance(n, ast.Call) and isinstance(n.func, ast.Name) and n.func.id in names
            for n in ast.walk(fn)
        )

    fixture_makers = {"make_project"}
    fixture_makers |= {
        fn.name for fn in defs if not fn.name.startswith("test_") and calls(fn, fixture_makers)
    }
    real = mod.make_project
    cases = []
    for fn in defs:
        if not fn.name.startswith("test_") or not calls(fn, fixture_makers):
            continue
        seen = []

        def recorder(tmp_path, files, **kw):
            seen.append((dict(files), dict(kw)))
            return real(tmp_path, files, **kw)

        mod.make_project = recorder
        try:
            with tempfile.TemporaryDirectory() as tmp:
                args = [Path(tmp)] if fn.args.args else []
                getattr(mod, fn.name)(*args)
        finally:
            mod.make_project = real
        cases += [(f"{fn.name}-{i}", files, kw) for i, (files, kw) in enumerate(seen)]
    return cases


logging.disable(logging.CRITICAL)
try:
    FIXTURES = _record_reference_fixtures()
finally:
    logging.disable(logging.NOTSET)


def _relative(findings, package_dir: str) -> set:
    pkg = package_dir.rstrip("/") + "/"
    return {
        (f.path[len(pkg):] if f.path.startswith(pkg) else f.path, f.line, f.code)
        for f in findings
    }


def test_every_reference_fixture_was_recorded():
    assert len(FIXTURES) >= 70
    assert len({case for case, _, _ in FIXTURES}) == len(FIXTURES)


@pytest.mark.parametrize(
    "files,kw", [(files, kw) for _, files, kw in FIXTURES],
    ids=[case for case, _, _ in FIXTURES],
)
def test_fixture_gives_the_reference_findings(tmp_path, files, kw):
    _layout(tmp_path / "ref", files)
    _layout(tmp_path / "port", {_to_port(k): _to_port(v) for k, v in files.items()})
    port_kw = {k: _to_port(v) if k == "package_dir" else v for k, v in kw.items()}
    ref = ref_run_all(RefProject(tmp_path / "ref", **kw), REF_CHECKERS)
    port = run_all(Project(tmp_path / "port", **port_kw), CHECKERS)
    ref_pkg = kw.get("package_dir", REF)
    port_pkg = port_kw.get("package_dir", PORT)
    assert _relative([f for f in port if f.code != "DPOW1002"], port_pkg) == _relative(
        [f for f in ref if f.code != "DPOW1002"], ref_pkg
    )
    # the jax traced-value fixtures hold no async def and no torch op
    assert [f for f in port if f.code == "DPOW1002"] == []


# ---------------------------------------------------------------------------
# registries, both trees, the CLI
# ---------------------------------------------------------------------------


def test_registries_match_the_reference():
    assert (len(CHECKERS), len(FAMILIES), len(KNOWN_CODES)) == (12, 17, 32)
    assert (len(REF_CHECKERS), len(REF_FAMILIES), len(REF_KNOWN_CODES)) == (12, 17, 32)
    assert list(FAMILIES) == list(REF_FAMILIES)
    assert KNOWN_CODES == REF_KNOWN_CODES
    assert [c.__module__.split(".")[-1] for c in CHECKERS] == [
        c.__module__.split(".")[-1] for c in REF_CHECKERS
    ]


def test_port_checkers_give_the_reference_tree_its_own_findings():
    ref = ref_run_all(RefProject(REPO_ROOT), REF_CHECKERS)
    port = run_all(Project(REPO_ROOT, package_dir=REF), CHECKERS)
    assert ref == []
    assert [f.render() for f in port] == [f.render() for f in ref]


def test_port_tree_is_clean_against_its_baseline():
    findings = run_all(Project(REPO_ROOT), CHECKERS)
    baseline = Baseline.load(REPO_ROOT / PORT / "analysis" / "baseline.txt")
    assert baseline.entries == set()
    fresh = [f for f in findings if not baseline.covers(f)]
    assert fresh == [], "\n".join(f.render() for f in fresh)


def test_waiver_budget_equals_the_waivers_counted():
    project = Project(REPO_ROOT)
    counted = sum(len(src.waivers) for src in project.sources())
    budget = (REPO_ROOT / PORT / "analysis" / "waivers.txt").read_text(encoding="utf-8")
    recorded = next(
        int(line) for line in budget.splitlines() if line.strip() and not line.startswith("#")
    )
    assert counted == recorded
    stale = [f for f in run_all(project, CHECKERS) if f.code == "DPOW002"]
    assert stale == [], "\n".join(f.render() for f in stale)


def test_baseline_round_trip_in_the_port(tmp_path):
    found = [Finding(f"{PORT}/a.py", 3, "DPOW101", "x"), Finding(f"{PORT}/b.py", 9, "DPOW201", "y")]
    path = tmp_path / "baseline.txt"
    Baseline().save(path, found)
    assert "python -m tpu_dpow_torch.analysis" in path.read_text(encoding="utf-8")
    loaded = Baseline.load(path)
    assert all(loaded.covers(f) for f in found)
    assert not loaded.covers(Finding(f"{PORT}/a.py", 3, "DPOW101", "other"))


def test_port_reads_its_own_flag_table():
    project = Project(REPO_ROOT)
    assert project.doc_path("flags.md") == f"{PORT}/docs/flags.md"
    assert project.doc_path("observability.md") == "docs/observability.md"
    assert "`--device`" in project.doc("flags.md")
    assert RefProject(REPO_ROOT).doc("flags.md") == (REPO_ROOT / "docs" / "flags.md").read_text(
        encoding="utf-8"
    )


def _cli(*args, timeout=180):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run(
        [sys.executable, "-m", f"{PORT}.analysis", *args], cwd=REPO_ROOT, env=env,
        capture_output=True, text=True, timeout=timeout,
    )


def test_cli_is_clean_on_the_port_and_prints_the_family_count():
    proc = _cli("--json")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    payload = json.loads(proc.stdout)
    assert payload["findings"] == [] and payload["families"] == 17
    assert "dpowlint: clean" in proc.stderr and "families=17" in proc.stderr


def test_cli_lists_the_catalogue_with_the_torch_rule():
    proc = _cli("--list")
    assert proc.returncode == 0
    for code in ("DPOW002", "DPOW101", "DPOW801", "DPOW1001", "DPOW1002", "DPOW1003",
                 "DPOW1004", "DPOW1005", "DPOW1101", "DPOW1104"):
        assert code in proc.stdout
    assert "synchronize" in proc.stdout


def test_static_pass_imports_neither_torch_nor_the_reference():
    probe = (
        "import sys\n"
        "from tpu_dpow_torch.analysis.__main__ import main\n"
        "rc = main([])\n"
        "print(rc, sorted({m.split('.')[0] for m in sys.modules}\n"
        "                 & {'torch', 'jax', 'tpu_dpow'}))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", probe], cwd=REPO_ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "0 []"


def test_cli_json_reports_a_finding_in_a_port_tree(tmp_path):
    bad = tmp_path / "proj"
    _layout(bad, {f"{PORT}/bad.py": "import time\n\ndef stamp():\n    return time.time()\n"})
    proc = _cli("--root", str(bad), "--json")
    assert proc.returncode == 1, proc.stdout + proc.stderr
    payload = json.loads(proc.stdout)
    assert [(f["path"], f["line"], f["code"]) for f in payload["findings"]] == [
        (f"{PORT}/bad.py", 4, "DPOW101")
    ]


def test_cli_changed_only_widens_when_the_port_checkers_change(tmp_path):
    bad_src = "import time\n\ndef stamp():\n    return time.time()\n"
    repo = tmp_path / "proj"
    _layout(repo, {f"{PORT}/legacy.py": bad_src, f"{PORT}/fresh.py": "X = 1\n"})
    env = {**os.environ, "GIT_AUTHOR_NAME": "t", "GIT_AUTHOR_EMAIL": "t@t",
           "GIT_COMMITTER_NAME": "t", "GIT_COMMITTER_EMAIL": "t@t"}
    for args in (["init", "-q"], ["add", "-A"], ["commit", "-qm", "seed"]):
        subprocess.run(["git", *args], cwd=repo, check=True, capture_output=True, env=env)
    (repo / PORT / "fresh.py").write_text(bad_src, encoding="utf-8")
    proc = _cli("--root", str(repo), "--changed_only")
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert f"{PORT}/fresh.py" in proc.stdout and "legacy.py" not in proc.stdout
    assert "(changed files only)" in proc.stderr
    _layout(repo, {f"{PORT}/analysis/new_checker.py": "X = 1\n"})
    proc = _cli("--root", str(repo), "--changed_only")
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert "widened to the full report" in proc.stderr
    assert "legacy.py" in proc.stdout


# ---------------------------------------------------------------------------
# DPOW1001 on the port's own engine
# ---------------------------------------------------------------------------


def _strip_epoch_guards(source: str) -> str:
    class Strip(ast.NodeTransformer):
        def visit_If(self, node):
            self.generic_visit(node)
            if tracing._epoch_compare(node.test):
                return node.body + node.orelse
            return node

    tree = Strip().visit(ast.parse(source))
    ast.fix_missing_locations(tree)
    return ast.unparse(tree)


def test_deleting_the_epoch_guard_from_the_port_apply_rows_fires(tmp_path):
    real = (REPO_ROOT / PORT / "backend" / "torch_backend.py").read_text(encoding="utf-8")
    fn_src = next(
        ast.get_source_segment(real, n) for n in ast.walk(ast.parse(real))
        if isinstance(n, ast.FunctionDef) and n.name == "_apply_plain_rows"
    )
    module = "class Engine:\n" + "\n".join("    " + line for line in fn_src.splitlines())
    _layout(tmp_path / "pre", {f"{PORT}/fix.py": module})
    assert tracing.check_epoch_fence(Project(tmp_path / "pre")) == []
    broken = _strip_epoch_guards(module)
    assert broken != module, "no epoch guard found to delete"
    _layout(tmp_path / "post", {f"{PORT}/fix.py": broken})
    fired = tracing.check_epoch_fence(Project(tmp_path / "post"))
    assert any(f.code == "DPOW1001" and "set_base" in f.message for f in fired), fired


# ---------------------------------------------------------------------------
# DPOW1002: device values reaching host control flow on the event loop
# ---------------------------------------------------------------------------

_SYNCS = (
    "import torch\n"
    "from torch.cuda import synchronize\n\n"
    "{kw}def step(params, n):\n"
    "    hits = torch.nonzero(params > 0)\n"
    "    first = hits[0].item()\n"
    "    rows = hits.sum(dim=1).tolist()\n"
    "    host = torch.ones(2).cpu()\n"
    "    if hits[0, 0] > 0:\n"
    "        pass\n"
    "    while torch.any(params == 0):\n"
    "        break\n"
    "    assert hits.any()\n"
    "    ok = bool(torch.max(hits) > 0)\n"
    "    torch.cuda.synchronize()\n"
    "    synchronize()\n"
    "    ev = torch.cuda.Event()\n"
    "    ev.synchronize()\n"
    "    torch.cuda.current_stream().synchronize()\n"
    "    return first, rows, host, ok\n"
)


def _traced(tmp_path, source: str) -> list:
    _layout(tmp_path, {f"{PORT}/engine.py": source})
    return tracing.check_traced_leak(Project(tmp_path))


def test_device_sync_fires_inside_async_def(tmp_path):
    found = _traced(tmp_path, _SYNCS.format(kw="async "))
    assert {f.code for f in found} == {"DPOW1002"}
    assert sorted(f.line for f in found) == [6, 7, 8, 9, 11, 13, 14, 15, 16, 18, 19]


def test_device_sync_quiet_in_a_plain_def(tmp_path):
    assert _traced(tmp_path, _SYNCS.format(kw="")) == []


def test_device_sync_quiet_on_host_values_and_off_loop_helpers(tmp_path):
    source = (
        "import asyncio\n"
        "import numpy as np\n"
        "import torch\n\n"
        "async def serve(loop, params, count: int):\n"
        "    hits = torch.nonzero(params)\n"
        "    if torch.cuda.is_available() and torch.cuda.device_count() > 1:\n"
        "        pass\n"
        "    if hits.numel() and hits.shape[0] > 2:\n"
        "        pass\n"
        "    n = 3\n"
        "    if n:\n"
        "        n = int(n)\n"
        "    assert bool(count)\n"
        "    while count > 0:\n"
        "        count -= 1\n"
        "    total = np.zeros(4).sum().item()\n"
        "    t = torch.zeros(4)\n"
        "    t = 5\n"
        "    if t:\n"
        "        pass\n"
        "    first = await loop.run_in_executor(None, lambda: hits[0].item())\n"
        "    def drain():\n"
        "        torch.cuda.synchronize()\n"
        "    await loop.run_in_executor(None, drain)\n"
        "    return total, first\n"
    )
    assert _traced(tmp_path, source) == []


def test_device_sync_waiver_silences_one_site(tmp_path):
    source = (
        "import torch\n\n"
        "async def close():\n"
        "    # dpowlint: disable=DPOW1002 — shutdown: nothing else runs on the loop\n"
        "    torch.cuda.synchronize()\n"
    )
    _layout(tmp_path, {f"{PORT}/engine.py": source})
    assert run_all(Project(tmp_path), [tracing.check]) == []


# ---------------------------------------------------------------------------
# DPOW101: the allowlist is package-relative
# ---------------------------------------------------------------------------


def test_clock_allowlist_is_package_relative(tmp_path):
    wall = "import time\n\ndef now():\n    return time.time()\n"
    _layout(tmp_path, {
        f"{PORT}/store/sqlite_store.py": wall,
        f"{PORT}/scripts/probe.py": wall,
        f"{PORT}/server/app.py": wall,
        # the reference's literal prefix means nothing inside the port
        f"{PORT}/tpu_dpow/store/sqlite_store.py": wall,
    })
    found = clock.check(Project(tmp_path))
    assert sorted((f.path, f.line, f.code) for f in found) == [
        (f"{PORT}/server/app.py", 4, "DPOW101"),
        (f"{PORT}/tpu_dpow/store/sqlite_store.py", 4, "DPOW101"),
    ]
    # the same table serves the reference tree
    _layout(tmp_path / "ref", {f"{REF}/store/sqlite_store.py": wall, f"{REF}/x.py": wall})
    found = clock.check(Project(tmp_path / "ref", package_dir=REF))
    assert [(f.path, f.code) for f in found] == [(f"{REF}/x.py", "DPOW101")]


# ---------------------------------------------------------------------------
# dpowsan
# ---------------------------------------------------------------------------


@pytest.fixture
def quiet_logs():
    logging.disable(logging.CRITICAL)
    yield
    logging.disable(logging.NOTSET)


def test_same_seed_same_trace_in_the_port(quiet_logs):
    a = sanitizer.run_seed("coalesce", 3, "cpu")
    b = sanitizer.run_seed("coalesce", 3, "cpu")
    assert a.ok and b.ok
    assert a.trace_digest == b.trace_digest and a.ledger_digest == b.ledger_digest
    assert sanitizer.run_seed("coalesce", 4, "cpu").trace_digest != a.trace_digest


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("scenario", HUB_SCENARIOS)
def test_hub_scenario_traces_match_the_reference(quiet_logs, scenario, seed):
    ref = ref_sanitizer.run_seed(scenario, seed)
    port = sanitizer.run_seed(scenario, seed, "cpu")
    assert ref.ok and port.ok, (ref.error, port.error)
    assert port.trace_digest == ref.trace_digest
    assert port.ledger_digest == ref.ledger_digest
    assert port.outstanding == ref.outstanding == 0


@pytest.mark.parametrize("seed", range(5))
def test_devfault_scenario_is_clean_on_the_cpu(quiet_logs, seed):
    run = sanitizer.run_seed("devfault", seed, "cpu")
    assert run.ok, run.error
    assert run.outcome in ("served", "cancelled", "exhausted")
    assert run.outstanding == 0


def test_report_counts_the_devfault_outcomes():
    report = sanitizer.SanitizerReport([
        sanitizer.SeedRun("devfault", 0, True, "d0", outcome="served"),
        sanitizer.SeedRun("devfault", 1, True, "d1", outcome="cancelled"),
        sanitizer.SeedRun("devfault", 2, True, "d2", outcome="served"),
        sanitizer.SeedRun("coalesce", 0, True, "c0"),
    ])
    lines = report.render().splitlines()
    assert "dpowsan: scenario=devfault seeds=3 ok=3 cancelled=1 served=2" in lines
    assert "dpowsan: scenario=coalesce seeds=1 ok=1" in lines
    assert "dpowsan: clean (4 runs, 3 seeds per scenario)" in lines


def test_failing_run_names_the_port_frames(monkeypatch):
    async def broken(perturber):
        from tpu_dpow_torch.resilience.clock import FakeClock

        await FakeClock().sleep("not a number")

    monkeypatch.setitem(sanitizer.SCENARIOS, "coalesce", broken)
    run = sanitizer.run_seed("coalesce", 0, "cpu")
    assert not run.ok
    assert f"{PORT}/resilience/clock.py" in run.tb_paths
    assert all(p.startswith(f"{PORT}/") for p in run.tb_paths)
    findings = [
        Finding(f"{PORT}/{rel}", 1, "DPOW801", rel)
        for rel in ("resilience/clock.py", "server/app.py", "client/app.py")
    ]
    verdicts = sanitizer.annotate(findings, sanitizer.SanitizerReport([run]))
    assert [verdicts[f.key()] for f in findings] == [
        "confirmed", "not-reproduced", "unexercised"
    ]


def test_cli_san_on_the_cpu_is_clean():
    proc = _cli("--san", "--san_seeds", "1", "--device", "cpu", timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-4000:]
    assert "dpowsan: clean (6 runs, 1 seeds per scenario)" in proc.stderr
    assert "dpowsan: ledger clean (0 outstanding)" in proc.stderr
    assert "families=17" in proc.stderr


def test_cli_san_without_a_card_fails_and_names_it():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: --san runs the devfault scenario on it")
    proc = _cli("--san", "--san_seeds", "1", timeout=300)
    assert proc.returncode == 1, proc.stdout + proc.stderr[-4000:]
    assert "FAIL scenario=devfault seed=0" in proc.stderr
    assert "no CUDA device" in proc.stderr
    assert "dpowsan: clean" not in proc.stderr


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(2))
def test_devfault_scenario_on_the_card(seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the persistent run kernel has no CPU mode")
    before = cuda_kernel.run_launches
    run = sanitizer.run_seed("devfault", seed, "cuda")
    assert run.ok, run.error
    assert cuda_kernel.run_launches > before
    torch.cuda.synchronize()
