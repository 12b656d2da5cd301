"""Per-request latency tracing: one WorkRequest stamped through the pipeline.

A trace follows one block hash from service accept to winner election:

    accept -> queue -> publish -> dispatch -> pack -> device -> result
                                                    -> winner | cancel

The server begins the trace and rides its id inside the existing MQTT
payloads (transport/mqtt_codec.py encode_work_payload appends it as an
optional trailing field, so pre-trace peers parse unchanged); the client
echoes it back in the result payload. Each ``mark`` observes the delta since
the trace's previous mark into the shared per-stage histogram
(``dpow_request_stage_seconds{stage=...}``), so /metrics carries the full
stage decomposition without any consumer having to correlate raw spans.

Stamps use time.time() (wall clock), not perf_counter: a trace can cross
process boundaries (server and worker on different hosts), where only wall
clock deltas mean anything. Within one process the extra jitter is ns-scale
against the ms-scale stages being measured.

Components that know only a block hash (the engines, the work handler) mark
through the hash alias (``mark_hash``) — the id→stages store and the
hash→id alias table are both bounded LRU so an abandoned trace can never
leak (the reference has nothing to leak: it measures nothing).
"""

from __future__ import annotations

import secrets
import threading
import time
from collections import OrderedDict
from typing import List, Optional, Tuple

from .registry import Histogram, Registry, get_registry

MAX_TRACES = 2048

STAGE_HISTOGRAM = "dpow_request_stage_seconds"

# Canonical stage order, for readers that want to sort a span chain the way
# the pipeline runs it. Marks outside this list are legal (forward compat);
# they simply sort last.
STAGES = (
    "accept",    # service request validated, trace born (server)
    "queue",     # dispatcher picked it up / store writes started (server)
    "publish",   # work/ondemand (or precache) publish landed (server)
    "dispatch",  # worker received the work message (client)
    "pack",      # engine included the job in its first device launch
    "device",    # device launch solved it (result applied host-side)
    "result",    # worker published result/<type> (client)
    "winner",    # server elected this result the winner
    "cancel",    # server fanned out cancel/<type> to the losers
)


def new_trace_id() -> str:
    return secrets.token_hex(8)


def is_trace_id(value: str) -> bool:
    """Cheap wire-side validation: 16 lowercase hex chars."""
    return (
        len(value) == 16
        and all(c in "0123456789abcdef" for c in value)
    )


class Tracer:
    def __init__(self, registry: Optional[Registry] = None):
        self._lock = threading.Lock()
        self._traces: "OrderedDict[str, List[Tuple[str, float]]]" = OrderedDict()
        self._aliases: "OrderedDict[str, str]" = OrderedDict()
        self._registry = registry

    def _histogram(self) -> Histogram:
        return (self._registry or get_registry()).histogram(
            STAGE_HISTOGRAM,
            "Per-stage latency of one work request (delta since the "
            "previous stage mark)",
            labelnames=("stage",),
        )

    def begin(self, key: Optional[str] = None, stage: str = "accept") -> str:
        """Start a trace (stamping ``stage``), optionally aliased to a key
        (the block hash) so hash-keyed components can mark it."""
        trace_id = new_trace_id()
        now = time.time()
        with self._lock:
            self._traces[trace_id] = [(stage, now)]
            self._traces.move_to_end(trace_id)
            while len(self._traces) > MAX_TRACES:
                self._traces.popitem(last=False)
            if key is not None:
                self._alias_locked(key, trace_id)
        return trace_id

    def _alias_locked(self, key: str, trace_id: str) -> None:
        self._aliases[key] = trace_id
        self._aliases.move_to_end(key)
        while len(self._aliases) > MAX_TRACES:
            self._aliases.popitem(last=False)

    def alias(self, key: str, trace_id: str) -> None:
        """Bind a block hash to a trace id received off the wire. Unknown
        ids get an empty trace created (a worker's marks are still useful
        even when the server restarted mid-flight) — under the same LRU
        bound as begin(): wire-supplied ids are untrusted input, and an
        unbounded insert here would let any peer grow the store forever."""
        with self._lock:
            if trace_id not in self._traces:
                self._traces[trace_id] = []
                self._traces.move_to_end(trace_id)
                while len(self._traces) > MAX_TRACES:
                    self._traces.popitem(last=False)
            self._alias_locked(key, trace_id)

    def mark(self, trace_id: Optional[str], stage: str) -> None:
        """Stamp ``stage`` on the trace and observe the delta since its
        previous mark. Unknown/None ids are a silent no-op: tracing must
        never be able to break the data path."""
        if not trace_id:
            return
        now = time.time()
        with self._lock:
            stages = self._traces.get(trace_id)
            if stages is None:
                return
            prev = stages[-1][1] if stages else None
            stages.append((stage, now))
            self._traces.move_to_end(trace_id)
        if prev is not None:
            self._histogram().observe(max(0.0, now - prev), stage)

    def mark_hash(self, key: str, stage: str) -> None:
        with self._lock:
            trace_id = self._aliases.get(key)
        self.mark(trace_id, stage)

    def id_for(self, key: str) -> Optional[str]:
        with self._lock:
            return self._aliases.get(key)

    def get(self, trace_id: str) -> List[Tuple[str, float]]:
        with self._lock:
            return list(self._traces.get(trace_id, ()))

    def spans(self, trace_id: str) -> List[Tuple[str, float]]:
        """[(stage, seconds-since-previous-stage), ...] — the first mark's
        delta is 0.0 by definition."""
        stages = self.get(trace_id)
        out = []
        prev = None
        for stage, t in stages:
            out.append((stage, 0.0 if prev is None else max(0.0, t - prev)))
            prev = t
        return out

    def reset(self) -> None:
        with self._lock:
            self._traces.clear()
            self._aliases.clear()


# Process-wide tracer, same rationale as the default registry: an in-process
# stack (server + client + engine) assembles one coherent span chain.
TRACER = Tracer()


def get_tracer() -> Tracer:
    return TRACER
