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

Beside the request chains the tracer keeps a bounded ring of host spans,
always on: one per engine launch (dispatch, launch-thread start, done and
apply, batch, steps, and the trace ids of the jobs it carried), one per
start-up phase, one per long or full collection (obs/gcwatch.py). Their
stamps are ``perf_counter`` seconds, taken where the work happens; this
module converts them to Unix time with one anchor pair read when the
tracer is made. ``chrome_trace()`` writes the ring and the request chains
as one Chrome-trace object on the Unix clock (served at ``GET /spans``,
obs/prom.py), so a worker's page, its hub's page and a ``torch.profiler``
trace shifted by its ``baseTimeNanoseconds`` share one time axis.

Start-up phases (``startup_begin`` / ``startup_mark`` / ``startup_done``)
are contiguous: each runs from the end of the one before it, a phase a
process never marks reads 0, and the first one starts at the process's
start as the OS records it (``process_start``). They feed
``dpow_client_startup_seconds{phase}``.
"""

from __future__ import annotations

import os
import secrets
import threading
import time
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Tuple

from .registry import Histogram, Registry, get_registry

MAX_TRACES = 2048
# Host spans the ring keeps (launches, start-up phases, collections): at a
# few hundred launches a second, the last several seconds of a busy worker.
MAX_SPANS = 8192
# What a persistent launch's span adds: windows it ran, its job rows' live
# row-windows, and why it returned.
PERSISTENT_ARGS = ("windows_ran", "live_row_windows", "cause")

STARTUP_GAUGE = "dpow_client_startup_seconds"
# A worker's set-up, in the order it runs (client/app.py DpowClient.setup,
# the engine's setup() inside it).
STARTUP_PHASES = (
    "interpreter",     # process start -> the entry point (imports included)
    "broker_connect",  # flags, the engine object, the broker connection
    "heartbeat_wait",  # the heartbeat subscription and the first heartbeat
    "subscribe",       # work, cancel and payout subscriptions
    "cuda_context",    # the engine's CUDA context, created on its own
    "kernels",         # kernel libraries built (nvcc) or loaded
    "self_test",       # the engine's planted-solution launch
    "announce",        # the fleet announce
    "metrics_app",     # the /metrics and /spans listener
)

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


def process_start() -> Optional[float]:
    """This process's start as the OS records it, on the ``perf_counter``
    clock, or None where the OS does not say. Linux: ``starttime`` in
    /proc/self/stat, in clock ticks since boot, against the boot clock now
    (10 ms steps; /proc/stat's ``btime`` would add its whole-second
    truncation)."""
    try:
        with open("/proc/self/stat") as f:
            # the command name may hold spaces: fields resume after ')'
            fields = f.read().rsplit(")", 1)[1].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        age = time.clock_gettime(time.CLOCK_BOOTTIME) - started
    except (OSError, ValueError, IndexError, AttributeError):
        return None
    return time.perf_counter() - max(0.0, age)


class Tracer:
    def __init__(self, registry: Optional[Registry] = None, max_spans: int = MAX_SPANS):
        self._lock = threading.Lock()
        self._traces: "OrderedDict[str, List[Tuple[str, float]]]" = OrderedDict()
        self._aliases: "OrderedDict[str, str]" = OrderedDict()
        self._registry = registry
        # (name, cat, thread, t0, t1, stamps, args), perf_counter seconds.
        # deque.append is atomic: a collector callback (obs/gcwatch.py) can
        # record without a lock that the thread it interrupted may hold.
        self._ring: "deque[tuple]" = deque(maxlen=max_spans)
        # The one anchor pair: perf_counter -> Unix nanoseconds.
        self._anchor_unix_ns = time.time_ns()
        self._anchor_perf_ns = time.perf_counter_ns()
        self._startup_t: Optional[float] = None  # end of the last phase
        self._startup_last: Optional[str] = None
        self._startup_open = False
        self._startup_closed = False
        self._startup: Dict[str, Tuple[float, float]] = {}  # phase: (start, end)

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

    # -- the span ring -----------------------------------------------------

    def record(self, name: str, t0: float, t1: float, *, cat: str = "span",
               thread: str = "", stamps: Optional[dict] = None,
               args: Optional[dict] = None) -> None:
        """One host span [t0, t1] (perf_counter seconds). ``stamps`` are
        further perf_counter instants, written out on the Unix clock."""
        self._ring.append((name, cat, thread, t0, t1, stamps, args))

    def launch(self, timing: dict, trace_ids: list) -> None:
        """One applied engine launch: the span its thread ran, [t_thread,
        t_done], with the dispatch and apply stamps around it, its shape,
        the rows stopped in it mid-launch, a persistent launch's windows,
        live row-windows and why it returned, and the trace ids of the jobs
        it carried (the requests that caused it)."""
        t0 = timing.get("t_thread", timing["t_dispatch"])
        t1 = timing.get("t_done", t0)
        args = {"batch": timing.get("batch"), "steps": timing.get("steps"),
                "stopped": timing.get("stopped", 0)}
        args.update((k, timing[k]) for k in PERSISTENT_ARGS if k in timing)
        args["trace_ids"] = trace_ids
        self.record(
            "launch", t0, t1, cat="engine", thread=timing.get("thread", ""),
            stamps={k: timing[k] for k in ("t_dispatch", "t_thread", "t_done", "t_apply")
                    if k in timing},
            args=args,
        )

    def ring(self) -> List[tuple]:
        """The ring's records, oldest first."""
        while True:
            try:
                return list(self._ring)
            except RuntimeError:  # appended to while copied: copy again
                continue

    def unix_ns(self, t: float) -> int:
        """A perf_counter stamp on the Unix clock, in nanoseconds."""
        return self._anchor_unix_ns + round(t * 1e9) - self._anchor_perf_ns

    # -- start-up phases ------------------------------------------------------

    def _startup_gauge(self):
        return (self._registry or get_registry()).gauge(
            STARTUP_GAUGE,
            "Seconds each start-up phase of this worker took, contiguous "
            "from the process's start to the end of its set-up",
            ("phase",),
        )

    def startup_begin(self, process_t0: Optional[float] = None) -> None:
        """Open the start-up clock once per process: with the process's
        start (``process_start()``) the ``interpreter`` phase ends now;
        without one the phases start now and ``interpreter`` reads 0."""
        with self._lock:
            if self._startup_open or self._startup_closed:
                return
            self._startup_open = True
            self._startup_t = time.perf_counter() if process_t0 is None else process_t0
        if process_t0 is not None:
            self.startup_mark("interpreter")

    def startup_mark(self, phase: str) -> None:
        """End ``phase`` now. Phases skipped since the last mark read 0; a
        second mark of the last phase extends it. A no-op while the clock
        is not open, so an engine set up outside a worker records nothing,
        and for a phase that set-up has already passed (a second engine of
        a failover chain): tracing never breaks the data path."""
        now = time.perf_counter()
        with self._lock:
            if not self._startup_open:
                return
            i = STARTUP_PHASES.index(phase)
            last = -1 if self._startup_last is None else STARTUP_PHASES.index(self._startup_last)
            if i < last:
                return
            t0 = self._startup.get(phase, (self._startup_t, now))[0]
            self._startup[phase] = (t0, now)
            self._startup_t, self._startup_last = now, phase

    def startup_done(self) -> Optional[Dict[str, float]]:
        """Close the start-up clock and return every phase in order, 0 where
        unmarked, also set on ``dpow_client_startup_seconds``; None where
        the clock was not open. Later calls and marks change nothing (a
        reconnect's set-up is not a start-up)."""
        with self._lock:
            if not self._startup_open:
                return None
            self._startup_open, self._startup_closed = False, True
            bounds = dict(self._startup)
        gauge = self._startup_gauge()
        phases = {}
        for phase in STARTUP_PHASES:
            t0, t1 = bounds.get(phase, (0.0, 0.0))
            phases[phase] = t1 - t0
            gauge.set(phases[phase], phase)
            if phase in bounds:
                self.record(phase, t0, t1, cat="startup", thread="startup")
        return phases

    # -- export ---------------------------------------------------------------

    def chrome_trace(self, process: str = "") -> dict:
        """The ring and the request chains as a Chrome-trace object on the
        Unix clock (``ts``/``dur`` in µs): launches on their launch
        thread's row, start-up phases and collections on rows of their
        own, each request mark an instant carrying its trace id. The
        ``requests`` key holds the chains as [stage, Unix ns] lists by
        trace id, for joining two processes' pages."""
        pid = os.getpid()
        rows: Dict[str, int] = {}
        events: list = []

        def row(name: str) -> int:
            if name not in rows:
                rows[name] = len(rows) + 1
                events.append({"name": "thread_name", "ph": "M", "pid": pid,
                               "tid": rows[name], "args": {"name": name}})
            return rows[name]

        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "args": {"name": process or f"pid {pid}"}})
        for name, cat, thread, t0, t1, stamps, args in self.ring():
            ev = {"name": name, "cat": cat, "ph": "X", "pid": pid,
                  "tid": row(thread or cat), "ts": self.unix_ns(t0) / 1e3,
                  "dur": max(0.0, t1 - t0) * 1e6}
            out = dict(args or {})
            for k, v in (stamps or {}).items():
                out[k + "_us"] = self.unix_ns(v) / 1e3
            if out:
                ev["args"] = out
            events.append(ev)
        with self._lock:
            chains = [(tid, list(marks)) for tid, marks in self._traces.items() if marks]
        requests = {}
        for trace_id, marks in chains:
            requests[trace_id] = [[stage, round(t * 1e9)] for stage, t in marks]
            for stage, t in marks:
                events.append({"name": stage, "cat": "request", "ph": "i", "s": "t",
                               "pid": pid, "tid": row("requests"), "ts": t * 1e6,
                               "args": {"trace_id": trace_id}})
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": {"clock": "unix", "ts_unit": "us", "pid": pid,
                              "process": process},
                "requests": requests}

    def reset(self) -> None:
        with self._lock:
            self._traces.clear()
            self._aliases.clear()
            self._ring.clear()
            self._startup.clear()
            self._startup_t = self._startup_last = None
            self._startup_open = self._startup_closed = False


# Process-wide tracer, same rationale as the default registry: an in-process
# stack (server + client + engine) assembles one coherent span chain.
TRACER = Tracer()


def get_tracer() -> Tracer:
    return TRACER
