"""CLI: ``python -m tpu_dpow_torch.analysis [--root DIR] [--write-baseline]
[--json] [--changed_only] [--san [--device cuda|cpu]]``.

The port's own copy of ``python -m tpu_dpow.analysis``: the same checkers,
codes, flags and output lines, run over ``tpu_dpow_torch``. ``--device``
picks the device of the sanitizer's devfault scenario engine (default
``cuda``; without a card the engine refuses with its own WorkError).

Exit 0 when every finding is inline-waived or baselined, 1 otherwise.
Output format (one per line): ``path:line  CODE  message``; ``--json``
emits the same findings as a machine-readable array on stdout instead.
``--changed_only`` scopes the REPORT to files the git working tree
changed against HEAD (full parse either way — the contract checkers are
whole-repo by nature): scripts/lint.sh uses it for fast iteration while
run_tier1.sh keeps the full run. ``--san`` additionally replays the
sanitizer scenarios (analysis/sanitizer.py) under ``--san_seeds`` seeded
interleavings and fails on any scenario invariant breach. The run prints
its own wall time and its active family count (``families=N`` — a
silently-skipped checker family is a changed N, not an invisible gap):
the whole static pass must stay cheap enough to sit in every lint
invocation (one parsed AST per file, shared across all checker families
— core.SourceFile).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

from . import CHECKERS, FAMILIES, sanitizer
from .core import DEFAULT_BASELINE, Baseline, Project, run_all

_CATALOGUE = """\
DPOW002  stale-waiver        inline waiver suppresses zero findings / names an unknown code
DPOW101  clock-discipline    timers must ride the injectable resilience.Clock
DPOW201  async-blocking      no blocking calls lexically inside async def
DPOW301  task-leak           create_task/ensure_future results must be retained
DPOW401  lock-across-await   no await while holding a threading lock
DPOW501  metrics-contract    dpow_* metric registered but not catalogued in docs
DPOW502  metrics-contract    catalogued metric registered nowhere in code
DPOW503  metrics-contract    label sets disagree between code and catalogue
DPOW504  metrics-contract    metric kind disagrees between code and catalogue
DPOW601  topic-contract      topic used in code but absent from the spec table
DPOW602  topic-contract      spec topic exercised nowhere in code
DPOW603  topic-contract      publish/subscribe not permitted by users.json ACLs
DPOW604  topic-contract      ACL drift between spec / users.json / code defaults
DPOW605  payload-grammar     binary frame in code missing/drifted in the spec table
DPOW606  payload-grammar     spec binary-frame row no code declares
DPOW701  flag-drift          config flag missing from docs/flags.md
DPOW702  flag-drift          documented flag no config declares
DPOW703  flag-drift          documented default != declared default
DPOW801  await-interference  shared state checked, then mutated after an await
DPOW802  lock-order          acquisition cycles / reentrant lock acquisition
DPOW803  untrusted-input     raw transport payload consumed before the decode boundary
DPOW901  replica-key-fence   replica:* store write outside replica/fence.py (unfenced)
DPOW1001 epoch-fence         apply-path frontier write with no dominating epoch comparison
DPOW1002 traced-leak         device value synced to the host inside async def (.item/.cpu/if/synchronize)
DPOW1003 warm-ladder         unhashable/varying jit static args; launch shapes bypassing _warm (no site in the port)
DPOW1004 slot-lifetime       control-slot release outside the thread's finally; fut-based liveness
DPOW1005 store-atomicity     load-then-save RMW on shared replica:/quota:/fleet: keys
DPOW1101 lifetime            acquired resource (ticket/slot/claim) not released on all paths
DPOW1102 lifetime            ownership transfer unrecorded, or local not neutralized after
DPOW1103 lifetime            double-release / use-after-release of a tracked handle
DPOW1104 lifetime            RESOURCE_TABLE out of sync with docs/resilience.md ownership table

Waive inline with `# dpowlint: disable=CODE — justification` (applies to
that line and the next); park intentional debt in the baseline file.
A waiver that suppresses nothing is itself a finding (DPOW002).
The DPOW801/1001/1101 families have a runtime confirmer: --san replays the
coalescing, fleet re-cover, takeover, device-fault and autoscale-drain
scenarios under seeded interleaving perturbation (--san_seeds N, env
DPOW_SAN_SEEDS; --device picks the device-fault engine's device).
Details: tpu_dpow_torch/docs/analysis.md."""


def _changed_paths(root: Path):
    """Root-relative paths the working tree changed against HEAD (staged
    + unstaged + untracked) — the --changed_only report scope.
    ``--relative`` keeps diff paths root-relative even when root sits
    below the git toplevel (ls-files is cwd-relative already). Returns
    None when git itself fails (missing/hung/not a repo): the caller
    must fall back to the FULL report — a git failure must never read
    as a clean tree."""
    out = set()
    for args in (
        ["git", "diff", "--relative", "--name-only", "HEAD"],
        ["git", "ls-files", "--others", "--exclude-standard"],
    ):
        try:
            proc = subprocess.run(
                args, cwd=root, capture_output=True, text=True, timeout=30
            )
        except (OSError, subprocess.TimeoutExpired):
            return None
        if proc.returncode != 0:
            return None
        out.update(p.strip() for p in proc.stdout.splitlines() if p.strip())
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        "python -m tpu_dpow_torch.analysis",
        description="dpowlint: AST-based invariant checkers for the "
        "async/Clock/metrics/topic/flag/concurrency/engine-discipline "
        "contracts (tpu_dpow_torch/docs/analysis.md), plus the dpowsan interleaving "
        "sanitizer",
    )
    parser.add_argument(
        "--root",
        default=None,
        help="project root (default: two levels above this package)",
    )
    parser.add_argument(
        "--baseline",
        default=None,
        help="baseline file (default: tpu_dpow_torch/analysis/baseline.txt)",
    )
    parser.add_argument(
        "--write-baseline",
        action="store_true",
        help="accept every current finding into the baseline and exit 0",
    )
    parser.add_argument(
        "--no-baseline",
        action="store_true",
        help="report baselined findings too (the full debt view)",
    )
    parser.add_argument(
        "--json",
        action="store_true",
        help="machine-readable output: a JSON object with the fresh "
        "findings, counts and timing on stdout (exit code unchanged)",
    )
    parser.add_argument(
        "--changed_only",
        action="store_true",
        help="report only findings in files the git working tree changed "
        "against HEAD (full parse — contract checkers are whole-repo); "
        "if git itself fails, falls back to the full report",
    )
    parser.add_argument(
        "--list", action="store_true", help="print the checker catalogue"
    )
    sanitizer.add_flags(parser)
    args = parser.parse_args(argv)

    if args.list:
        print(_CATALOGUE)
        return 0

    t0 = time.perf_counter()
    root = Path(args.root) if args.root else Path(__file__).resolve().parents[2]
    baseline_path = (
        Path(args.baseline) if args.baseline else Path(__file__).parent / DEFAULT_BASELINE
    )
    project = Project(root)
    findings = run_all(project, CHECKERS)
    static_elapsed = time.perf_counter() - t0

    if args.write_baseline:
        Baseline().save(baseline_path, findings)
        print(
            f"dpowlint: wrote {len(findings)} finding(s) to {baseline_path}",
            file=sys.stderr,
        )
        return 0

    baseline = Baseline() if args.no_baseline else Baseline.load(baseline_path)
    fresh = [f for f in findings if not baseline.covers(f)]
    # baselined is counted BEFORE any report scoping: a fresh finding a
    # --changed_only run scopes out is still live un-baselined debt, and
    # must never be reported as parked in baseline.txt.
    baselined = len(findings) - len(fresh)
    changed_scope = args.changed_only
    if args.changed_only:
        changed = _changed_paths(root)
        if changed is None:
            print(
                "dpowlint: git unavailable for --changed_only — "
                "falling back to the full report",
                file=sys.stderr,
            )
            changed_scope = False
        elif any(p.startswith("tpu_dpow_torch/analysis/") for p in changed):
            # The checkers themselves changed: their new findings anchor
            # in UNCHANGED files by construction (analysis/ is excluded
            # from its own scan), so a scoped report would always read
            # clean — run the full report instead.
            print(
                "dpowlint: analysis/ itself changed — --changed_only "
                "widened to the full report",
                file=sys.stderr,
            )
            changed_scope = False
        elif any(p.endswith("docs/resilience.md") for p in changed):
            # The Resource-ownership table (DPOW1104) lives there: its
            # findings anchor at the doc, but a rename/removal also
            # re-judges every RESOURCE_TABLE kind — widen so a doc edit
            # cannot silently orphan the declaration.
            print(
                "dpowlint: docs/resilience.md changed — --changed_only "
                "widened to the full report",
                file=sys.stderr,
            )
            changed_scope = False
        else:
            # Waiver-budget drift (DPOW002 anchored at analysis/
            # waivers.txt) must survive scoping: the waiver that caused
            # it lives in a changed file, but the finding anchors at the
            # budget record the author did NOT touch.
            fresh = [
                f for f in fresh
                if f.path in changed or f.path.endswith("/waivers.txt")
            ]
    if args.json:
        print(
            json.dumps(
                {
                    "findings": [
                        {
                            "path": f.path,
                            "line": f.line,
                            "code": f.code,
                            "message": f.message,
                        }
                        for f in fresh
                    ],
                    "baselined": baselined,
                    "families": len(FAMILIES),
                    "changed_only": changed_scope,
                    "elapsed_s": round(static_elapsed, 3),
                },
                indent=2,
            )
        )
    else:
        for f in fresh:
            print(f.render())
    scope = " (changed files only)" if changed_scope else ""
    rc = 0
    if fresh:
        print(
            f"dpowlint: {len(fresh)} finding(s)"
            + (f" ({baselined} baselined)" if baselined else "")
            + f"{scope} in {static_elapsed:.2f}s"
            + f" families={len(FAMILIES)}",
            file=sys.stderr,
        )
        rc = 1
    else:
        print(
            "dpowlint: clean"
            + (f" ({baselined} baselined finding(s) remain)" if baselined else "")
            + f"{scope} in {static_elapsed:.2f}s"
            + f" families={len(FAMILIES)}",
            file=sys.stderr,
        )

    if args.san:
        t1 = time.perf_counter()
        report = sanitizer.run_seeds(
            args.san_seeds, args.san_base_seed, device=args.device
        )
        print(report.render(), file=sys.stderr)
        verdicts = sanitizer.annotate(fresh, report)
        for f in fresh:
            verdict = verdicts.get(f.key())
            if verdict is not None:
                print(f"dpowsan: {verdict}  {f.render()}", file=sys.stderr)
        print(
            f"dpowsan: {len(report.runs)} runs in "
            f"{time.perf_counter() - t1:.2f}s",
            file=sys.stderr,
        )
        if report.failures:
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
