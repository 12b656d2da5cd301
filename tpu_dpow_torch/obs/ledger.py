"""LeakLedger: runtime acquire/release accounting for revocable resources.

The port's own copy of ``tpu_dpow/obs/ledger.py``. The recurring bug class
it watches is "acquire → await → exception/cancel path leaks it"; in the
port the tracked resource is the persistent run mode's control slot
(ops/control.py ``register``/``release``): every acquire registers here,
every release discharges, and the tests assert the ledger reads zero
outstanding at teardown.

Design constraints:

  * callable from ANY thread — control-slot registration happens on the
    engine's event loop and release on its launch threads, so every
    mutation takes one plain ``threading.Lock`` (dict ops only, never
    awaits);
  * deterministic traces — raw keys are process-global (control slot ids
    from an ``itertools.count``), so the trace never records them: each
    (kind, key) gets a per-reset alias ``kind#N`` in first-use order, and
    the digest depends only on the event ORDER;
  * non-fatal mismatch accounting — an unmatched discharge (double
    release, or a release of something acquired before the last reset)
    is recorded as an ``unmatched`` trace event and never raises: the
    ledger observes, the tests judge. Outstanding counts never go
    negative;
  * bounded memory — the trace ring keeps the most recent MAX_TRACE
    events (with a dropped counter folded into the digest), so a long
    pytest session cannot grow it without bound.

The per-kind outstanding count is mirrored to the
``dpow_resource_outstanding{kind}`` gauge (docs/observability.md) on
every mutation, so a live process leaks visibly long before teardown.
"""

from __future__ import annotations

import hashlib
import threading
from typing import Dict, List, Tuple

from .registry import get_registry

#: trace ring capacity; beyond it the oldest events are dropped (counted).
MAX_TRACE = 200_000

GAUGE_NAME = "dpow_resource_outstanding"
GAUGE_HELP = (
    "Revocable resources currently acquired and not yet released/"
    "transferred, per kind (ticket/lease/slot/claim/gate/future/"
    "origin/bgtask) — nonzero at rest is a leak"
)


def _gauge():
    # get-or-create on every mutation: survives registry resets between
    # tests without holding a stale family handle.
    return get_registry().gauge(GAUGE_NAME, GAUGE_HELP, ("kind",))


class LeakLedger:
    """Process-wide acquire/discharge ledger for revocable resources."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        #: (kind, key) → live acquire count (keys must be hashable;
        #: identity-hashed objects like Ticket are fine — the trace
        #: aliases them).
        self._live: Dict[Tuple[str, object], int] = {}
        #: per-reset alias map: (kind, key) → "kind#N" in first-use order.
        self._alias: Dict[Tuple[str, object], str] = {}
        self._alias_seq: Dict[str, int] = {}
        self._trace: List[str] = []
        self._dropped = 0

    # -- internals (caller holds self._lock) ---------------------------

    def _alias_for(self, kind: str, key: object) -> str:
        k = (kind, key)
        alias = self._alias.get(k)
        if alias is None:
            n = self._alias_seq.get(kind, 0) + 1
            self._alias_seq[kind] = n
            alias = f"{kind}#{n}"
            self._alias[k] = alias
        return alias

    def _record(self, op: str, kind: str, key: object) -> None:
        self._trace.append(f"{op} {self._alias_for(kind, key)}")
        if len(self._trace) > MAX_TRACE:
            del self._trace[0]
            self._dropped += 1

    def _set_gauge(self, kind: str) -> None:
        count = sum(
            c for (k, _key), c in self._live.items() if k == kind
        )
        _gauge().set(float(count), kind)

    # -- mutation API --------------------------------------------------

    def acquire(self, kind: str, key: object) -> None:
        """Register one acquisition of ``key`` under ``kind``."""
        with self._lock:
            self._live[(kind, key)] = self._live.get((kind, key), 0) + 1
            self._record("acquire", kind, key)
            self._set_gauge(kind)

    def discharge(self, kind: str, key: object, op: str = "release") -> bool:
        """Discharge one acquisition (``op``: release / lapse / transfer).

        Returns False — and records an ``unmatched`` event — when nothing
        is live under (kind, key): a double release, or a release of a
        resource acquired before the last reset. Never raises.
        """
        with self._lock:
            count = self._live.get((kind, key), 0)
            if count <= 0:
                self._record(f"unmatched-{op}", kind, key)
                return False
            if count == 1:
                del self._live[(kind, key)]
            else:
                self._live[(kind, key)] = count - 1
            self._record(op, kind, key)
            self._set_gauge(kind)
            return True

    def transfer(self, kind: str, key: object, note: str = "") -> None:
        """Document an ownership transfer of a STILL-LIVE resource (the
        handle moved to another owner; the count does not change — the
        new owner's release path discharges it). Trace-only."""
        with self._lock:
            suffix = f" {note}" if note else ""
            self._trace.append(
                f"transfer {self._alias_for(kind, key)}{suffix}"
            )
            if len(self._trace) > MAX_TRACE:
                del self._trace[0]
                self._dropped += 1

    def reset(self) -> None:
        """Clear all state (test/scenario isolation). Gauges for every
        kind seen since process start are zeroed, not deleted."""
        with self._lock:
            kinds = set(self._alias_seq)
            self._live.clear()
            self._alias.clear()
            self._alias_seq.clear()
            self._trace.clear()
            self._dropped = 0
        g = _gauge()
        for kind in kinds:
            g.set(0.0, kind)

    # -- read API ------------------------------------------------------

    def outstanding(self) -> Dict[str, int]:
        """kind → live acquire count, omitting zero kinds."""
        with self._lock:
            out: Dict[str, int] = {}
            for (kind, _key), count in self._live.items():
                out[kind] = out.get(kind, 0) + count
            return out

    def outstanding_keys(self) -> Tuple[str, ...]:
        """Sorted aliases of every live resource (for failure messages)."""
        with self._lock:
            return tuple(
                sorted(self._alias[k] for k in self._live)
            )

    def trace(self) -> Tuple[str, ...]:
        with self._lock:
            return tuple(self._trace)

    def trace_digest(self) -> str:
        """Order-sensitive digest of the event trace (+ drop count)."""
        with self._lock:
            h = hashlib.sha256()
            for event in self._trace:
                h.update(event.encode())
                h.update(b"\n")
            if self._dropped:
                h.update(f"dropped={self._dropped}".encode())
            return h.hexdigest()[:16]


#: the process-wide ledger every layer writes into.
LEDGER = LeakLedger()


def get_ledger() -> LeakLedger:
    return LEDGER
