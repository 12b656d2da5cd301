"""dpowlint: AST-based invariant checkers for the port's own contracts.

The port's own copy of ``tpu_dpow/analysis/``, run over ``tpu_dpow_torch``:
the same twelve checker modules, seventeen families and 32 codes, the same
waiver syntax, baseline and waiver budget, and the dpowsan runtime half
(``sanitizer.py``). The contracts it holds the port to:

  * every timer must run on the injectable ``resilience.Clock`` (DPOW101);
  * async paths must never block the event loop (DPOW201);
  * ``asyncio.create_task`` results must be retained (DPOW301), and no
    ``await`` may sit inside a held ``threading.Lock`` (DPOW401);
  * the ``dpow_*`` metric catalogue, the MQTT topic grammar + ACL matrix,
    and the ``--flag`` tables must match the code (DPOW5xx/6xx/7xx) — the
    port shares ``tpu_dpow``'s metric and topic contracts and keeps its
    own flag table, ``tpu_dpow_torch/docs/flags.md``;
  * the engine's discipline — epoch-fenced frontier writes, no device
    value synchronised to the host on the event loop, thread-scoped
    control-slot lifetime (DPOW10xx, analysis/tracing.py) and no
    load-then-save RMW on shared store keys (DPOW1005);
  * every revocable resource is released on ALL paths, transfers are
    recorded, nothing releases twice (DPOW11xx, analysis/lifetime.py;
    runtime-confirmed by the obs.LeakLedger under dpowsan);
  * an inline waiver that suppresses nothing is itself a finding (DPOW002).

The static checkers are stdlib only (ast + tokenize): they import neither
torch nor anything of ``tpu_dpow``. Run as ``python -m
tpu_dpow_torch.analysis``. Catalogue, allowlists, blind spots and where
the port differs from ``tpu_dpow`` (DPOW1002, DPOW1003, ``--device``):
tpu_dpow_torch/docs/analysis.md.
"""

from .core import (  # noqa: F401
    CODE_STALE_WAIVER,
    Baseline,
    Finding,
    Project,
    run_all,
)
from . import (  # noqa: F401
    atomicity,
    blocking,
    clock,
    concurrency,
    flags,
    lifetime,
    locks,
    metrics,
    replica_keys,
    tasks,
    topics,
    tracing,
)

#: checker modules, in catalogue order (tpu_dpow_torch/docs/analysis.md) — the single
#: registration point: CHECKERS, FAMILIES and KNOWN_CODES all derive
#: from this tuple, so dropping a module here (or losing one in a merge)
#: changes the ``families=N`` headline instead of leaving an invisible
#: gap.
_CHECKER_MODULES = (
    clock,
    blocking,
    tasks,
    locks,
    metrics,
    topics,
    flags,
    concurrency,
    replica_keys,
    tracing,
    atomicity,
    lifetime,
)

#: checker registry (one ``check(project)`` per module)
CHECKERS = tuple(m.check for m in _CHECKER_MODULES)

#: checker families and the codes each can emit, DERIVED from the
#: registered modules' own FAMILIES declarations. This is the headline
#: denominator (``DPOWLINT=clean families=N`` in run_tier1.sh). The
#: DPOW002 meta-family is emitted by core.run_all itself and always
#: present.
FAMILIES = (("stale-waiver", (CODE_STALE_WAIVER,)),) + tuple(
    entry for m in _CHECKER_MODULES for entry in m.FAMILIES
)

#: every code a registered checker (or the meta-pass) can emit; the
#: DPOW002 unknown-code judgment is made against this set, and "ALL" is
#: the documented waive-everything escape hatch.
KNOWN_CODES = frozenset(c for _name, cs in FAMILIES for c in cs) | {"ALL"}
