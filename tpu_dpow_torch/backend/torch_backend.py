"""In-process PyTorch/CUDA work engine: batched, cancellable nonce search.

Counterpart of ``tpu_dpow/backend/jax_backend.py`` in both of its run
modes, on one device or fanned over several, built on the scanners in ops/
and the fan in parallel/:

  * Every request gets a decorrelating random 64-bit start base (or the
    start of its ``nonce_range``), then advances deterministically launch by
    launch.
  * All active requests are packed into one batched launch per engine step,
    padded to a power of two with difficulty-0 rows that hit at offset 0 and
    drain after one stride. Concurrent requests for one hash share one job.
  * Cancels are lane masking: a cancelled job is dropped from the next pack;
    a launch already in flight finishes and its result is discarded. A
    plain chunked launch on the card is the exception: the rows of a job
    answered (solved by an earlier launch, or cancelled) while it runs are
    stopped mid-launch (``_stop_rows``), and counted by what they ran.
  * Run length adapts to difficulty: a launch covers up to ``run_steps``
    consecutive windows (the kernel's span is ``nblocks * steps`` windows),
    quantized on a x4 ladder (x2 with ``step_ladder="x2"``). Jobs are
    grouped into difficulty rungs served round-robin, each launch as wide
    as its rung wants; launches queued behind another one are capped at
    ``shared_steps_cap`` windows.
  * Launch pipelining (``pipeline``, default 2) keeps a second launch in
    flight while the first's results are read back. Jobs advance their base
    speculatively at dispatch, so consecutive launches scan disjoint spans,
    and a successor launch prefers jobs that in-flight spans are unlikely to
    solve (coverage accounting).
  * ``run_mode="persistent"``: every launch is one steerable span of
    ``persistent_steps`` windows (ops/runloop.py) that polls a per-launch
    control block (ops/control.py) every ``control_poll_steps`` windows, so
    cancel, raise_difficulty and cover_range land MID-LAUNCH and a launch
    returns on win, cancel or span end. Stale launches are epoch-fenced
    (``LaunchControl.kill``); results are read against what the device
    actually ran (``effective_*``).
  * ``devices=N`` (the device FAN, parallel/fan_search.py): each job's
    nonce range is sub-partitioned over N devices (``device_shard``:
    'split' macro-ranges, or 'interleave' windows dealt round-robin); every
    launch runs one member launch per device, and the host elects the
    winner and attributes it to the device whose sub-range produced it
    (per-device scan clocks, EMA, the ``dpow_backend_device_*`` families).
  * ``mesh_devices=N`` (the mesh GANG, parallel/mesh_search.py): every
    launch is one ganged launch over a (batch, nonce) mesh of N devices —
    each member scans its sub-range of every row's window, the host elects
    the lowest global offset — with ONE logical frontier per job (no
    per-device bases or attribution; one fault domain for the gang).
    Chunked mode only, as in the JAX engine.
  * Device fault domains (resilience/devfault.py): a watchdog on the
    injectable clock reads each device's progress from the control
    channel's poll bookkeeping; a device that misses its deadline is
    suspected, its launches are ejected and its uncovered range evacuated
    onto the healthy devices, and it is quarantined until a single probe
    launch re-admits it. At zero healthy devices the engine raises
    ``DevicesExhausted``. The watchdog runs for every persistent engine
    (fan or not) and for chunked launches when ``device_suspect_after`` is
    set.

On a CUDA device every launch goes through a hand-written kernel
(ops/cuda_kernel.py: the chunk search kernel, or the persistent run kernel);
with ``device="cpu"`` the same engine runs their plain PyTorch versions,
and a fan of N runs N logical CPU members. Every found nonce is
re-validated on the host against hashlib before it is returned.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import contextlib
import math
import secrets
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch

from .. import obs
from ..models import WorkRequest
from ..ops import control as ctl
from ..ops import cuda_kernel, runloop, search
from ..parallel import fan_search, mesh_search
from ..resilience.clock import Clock, SystemClock
from ..resilience.devfault import (
    DEADLINE_SLACK,
    HEALTHY,
    DeviceFaultDomains,
    launch_deadline,
)
from ..utils import nanocrypto as nc
from ..utils.logging import get_logger
from . import DevicesExhausted, WorkBackend, WorkCancelled, WorkError, await_shared_job

_MASK64 = (1 << 64) - 1

logger = get_logger("tpu_dpow_torch.backend")

# Coverage-aware dispatch (see _dispatch_next): a job is worth another span
# while P(no in-flight span solves it) is at least this. Below it the job is
# only dispatched speculatively, and only when NO uncovered demand exists.
SPEC_MISS_THRESHOLD = 0.5
# Even idle-device speculation stops once a job is this likely already
# solved in flight.
SPEC_MISS_FLOOR = 0.02
# A purely speculative launch may carry at most this many EXPECTED-WASTED
# rows (sum of per-job solve probability).
SPEC_WASTE_ROWS = 2.0

# Default geometry per device type: (sublanes, iters, nblocks, group). On the
# GPU one window is 32*128*1024*8 = 2^25 nonces, the size of the TPU
# default's; on the CPU the plain version scans small 8192-nonce windows.
_GEOMETRY = {"cuda": (32, 1024, 8, 8), "cpu": (8, 8, 1, 1)}
_RUN_STEPS = {"cuda": 16, "cpu": 1}
# Persistent mode's default poll cadence, in windows. A poll stalls the
# launch for a host round trip (~0.1 ms on the H100 host, chip_smoke.py) and
# bounds cancel / raise / rebase latency at one interval; one 2^25 window of
# one row takes ~3.5 ms on an H100, so 2 windows keep the poll cost near
# 1-2 % while a cancel lands within ~7 ms. The CPU polls every window, as the JAX
# engine's CPU default does (test windows are tiny, local polls cheap).
_POLL_STEPS = {"cuda": 2, "cpu": 1}
# Why a persistent launch returned: a job row still live at its span's end,
# the host's cancel or kill stopping its last live rows at a poll, or its last
# rows' hits.
PERSISTENT_RETURNS = ("all_done", "span_end", "killed")
# Automatic launch_timeout: a launch on the card that has not returned in
# this many seconds fails the engine with a WorkError instead of hanging it
# (the JAX engine's TPU rule); none on the CPU.
_LAUNCH_TIMEOUT = {"cuda": 300.0, "cpu": None}


def _consume_abandoned(fut) -> None:
    """Done-callback tail for an abandoned launch future: consume its
    outcome so an exception never logs as never-retrieved."""
    if not fut.cancelled():
        fut.exception()


@dataclass
class _Job:
    block_hash: str
    difficulty: int  # current target; can only be raised by a later request
    params: np.ndarray  # cached uint32[12] row; base/diff words updated in place
    future: asyncio.Future
    base: int
    cancelled: bool = False
    waiters: int = 0  # refcount: last cancelled waiter drops the job
    # Bumped on every re-aim (cover_range, fan re-partition, evacuation): a
    # launch dispatched against the old region must not rewind the frontier
    # back out of the new one, nor feed the new partition's counters.
    epoch: int = 0
    # P(no launch currently in flight solves this job); 1.0 = uncovered.
    inflight_miss: float = 1.0
    # Stage stamps (perf_counter): submission and first dispatch — the
    # queue-wait histogram; a job's first dispatch is also the trace's
    # 'pack' mark.
    t_submit: float = 0.0
    t_first_dispatch: float = 0.0
    trace_id: Optional[str] = None  # the request's, named by launch spans
    applied_launches: int = 0  # launches applied that carried this job
    # Device fan: per-device shard state, by PHYSICAL device index.
    dev_bases: "Optional[list]" = None  # split policy: per-device next base
    dev_scanned: "Optional[list]" = None  # nonces scanned per device (this job)
    dev_t0: "Optional[list]" = None  # per-device scan-clock first-dispatch stamps
    # The partition's recorded range (fan mode): evacuation computes a dead
    # device's uncovered remainder against this end (length 0 = full span).
    part_start: int = 0
    part_len: int = 0

    def set_base(self, base: int) -> None:
        self.base = base & _MASK64
        self.params[search.BASE_LO] = self.base & 0xFFFFFFFF
        self.params[search.BASE_HI] = self.base >> 32

    def set_difficulty(self, difficulty: int) -> None:
        self.difficulty = difficulty
        self.params[search.DIFF_LO] = difficulty & 0xFFFFFFFF
        self.params[search.DIFF_HI] = difficulty >> 32
        # In-flight spans scan the OLD (easier) target and are far less
        # likely to solve this job: make it eligible again right away.
        self.inflight_miss = 1.0


class _RowStops:
    """The stop channel of one plain chunked launch on the card, made at
    dispatch. The launch thread opens it with a RowStopper once the
    launch's out words are filled on the card, and closes it after their
    readback, handing over the kernel's per-row ``scanned`` counts. Rows
    are stopped only while it is open, and closing waits for every stop
    written, so no write outlives the launch's buffer."""

    def __init__(self):
        self._lock = threading.Lock()
        self._stopper = None  # a RowStopper while open
        self.rows: set = set()  # rows stopped while open
        self.scanned: Optional[np.ndarray] = None  # uint32[B] once closed

    def open(self, stopper) -> None:
        with self._lock:
            self._stopper = stopper

    def stop(self, row: int) -> bool:
        """Stop ``row``; False where the handle is not open or the row
        was stopped already."""
        with self._lock:
            if self._stopper is None or row in self.rows:
                return False
            self._stopper.stop(row)
            self.rows.add(row)
            return True

    def close(self, scanned: Optional[np.ndarray]) -> None:
        with self._lock:
            stopper, self._stopper = self._stopper, None
            self.scanned = scanned
        if stopper is not None:
            stopper.drain()


@dataclass
class _Launch:
    """One in-flight device launch and the per-job state it was packed with."""

    fut: asyncio.Future  # executor future → (lo, hi) result arrays
    jobs: list  # the _Jobs occupying the first len(jobs) batch rows
    launched_difficulty: list  # per-job target snapshot at dispatch
    bases: list  # per-job scan base at dispatch (pre-speculation)
    epochs: list  # per-job re-aim epoch at dispatch
    span: int  # nonces scanned per row this launch (all devices summed)
    miss_factors: list  # per-job P(this span misses), undone when applied
    steps: int = 1  # windows this launch may scan per row (per device)
    batch: int = 1  # padded batch rows
    # Persistent mode: the launch's live control block and its slot id in
    # ops/control.py's table. None on chunked launches — they cannot be
    # steered mid-flight.
    control: "Optional[ctl.LaunchControl]" = None
    slot: int = 0
    # Fan mode: per-job per-slice base snapshot [len(jobs)][n_slices], and
    # launch slice index -> PHYSICAL device index (a launch dispatched at
    # degraded width runs on a subset of the fan).
    dev_bases: "Optional[list]" = None
    fan_map: "Optional[list]" = None
    # Stage stamps, perf_counter and injectable clock: t_dispatch and the
    # inflight depth at dispatch, t_thread, t_done, t_thread_clock,
    # t_done_clock (engine families, window-time EMA, per-device rates),
    # the launch thread's name, t_apply/batch/steps once applied (the
    # launch span on the tracer's ring).
    timing: dict = field(default_factory=dict)
    # Dispatch stamp on the injectable clock: the watchdog's deadline anchor
    # for a launch that has not polled yet.
    t_clock: float = 0.0
    # Set by the launch THREAD when it actually returns: ``fut`` reads done
    # once its waiter is cancelled while the thread may still be wedged.
    thread_done: "Optional[threading.Event]" = None
    # Readback-await task (launch_timeout bound), made when the launch
    # reaches the head of the FIFO.
    waiter: "Optional[asyncio.Task]" = None
    # Set when the watchdog ejects the launch (a suspect device pins it):
    # its results are discarded and its control rows kill-fenced.
    abandoned: bool = False
    # Plain chunked launches on the card: the channel that stops its rows
    # mid-launch (_stop_rows). None elsewhere.
    stops: "Optional[_RowStops]" = None


class TorchWorkBackend(WorkBackend):
    """Batched nonce search on one GPU, fanned over several (``devices=``)
    or ganged over a mesh of them (``mesh_devices=``), or, if asked, on the
    CPU."""

    def __init__(
        self,
        *,
        device=None,  # None = "cuda"; "cpu" runs the plain PyTorch version
        sublanes: Optional[int] = None,
        iters: Optional[int] = None,
        nblocks: Optional[int] = None,
        group: Optional[int] = None,
        max_batch: int = 16,
        run_steps: Optional[int] = None,  # cap on windows per chunked launch
        pipeline: int = 2,  # launches in flight at once (1 = no overlap)
        run_mode: str = "chunked",  # 'chunked' | 'persistent' (mid-launch control)
        control_poll_steps: int = 0,  # persistent: windows between polls (0 = auto)
        persistent_steps: Optional[int] = None,  # persistent: windows per launch
        clock: Optional[Clock] = None,  # control stamps, scan clocks, watchdog
        mesh_devices: int = 0,  # >=1: gang this many devices per hash (the mesh)
        devices: int = 0,  # fan: 0 = one device, -1 = every visible, N = first N
        device_shard: str = "split",  # fan partition policy: 'split' | 'interleave'
        launch_timeout: Optional[float] = None,  # s; None = auto (300 on the card)
        device_suspect_after: float = 0.0,  # s without device progress (0 = auto)
        device_probe_interval: float = 30.0,  # s between re-admission probes
        close_join_timeout: float = 5.0,  # s close() waits for launch threads
        step_ladder: str = "x4",  # run-length quantization: 'x4' | 'x2'
        shared_steps_cap: Optional[int] = None,  # windows/launch under contention
    ):
        dev = torch.device("cuda" if device is None else device)
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise WorkError(
                    "no CUDA device: TorchWorkBackend runs on the GPU unless "
                    "device='cpu' is asked for"
                )
            if dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
        elif dev.type != "cpu":
            raise WorkError(f"device must be cuda or cpu, not {dev}")
        if devices and mesh_devices >= 1:
            raise WorkError(
                "devices (device fan) and mesh_devices (mesh gang) are "
                "mutually exclusive — pick one multi-device path"
            )
        if device_shard not in ("split", "interleave"):
            raise WorkError(
                f"device_shard must be 'split' or 'interleave', not {device_shard!r}"
            )
        self.device_shard = device_shard
        # The mesh gang (mesh_devices >= 1), INCLUDING 1: a one-device mesh
        # runs the exact gang code, the A/B configuration that prices the
        # gang machinery against the plain path.
        self.mesh: "Optional[mesh_search.Mesh]" = None
        if mesh_devices >= 1:
            local = fan_search.fan_devices(-1, dev.type)
            if len(local) < mesh_devices:
                raise WorkError(
                    f"mesh_devices={mesh_devices} but only {len(local)} "
                    "local devices visible"
                )
            self.mesh = mesh_search.make_mesh(local[:mesh_devices])
            dev = local[0]
        # The fan (devices != 0): -1 takes every visible device of the
        # type, N the first N, 1 included (the A/B that prices the fan's
        # machinery against the plain path). More than are visible raises.
        self.fan: "Optional[list]" = None
        if devices:
            try:
                self.fan = fan_search.fan_devices(devices, dev.type)
            except ValueError as e:
                raise WorkError(str(e)) from e
            dev = self.fan[0]
        self.device = dev
        geometry = _GEOMETRY[dev.type]
        self.sublanes = sublanes or geometry[0]
        self.iters = iters or geometry[1]
        self.nblocks = nblocks or geometry[2]
        self.group = group or geometry[3]
        try:
            # Fail at construction with the kernel's own geometry checks.
            self.chunk_per_shard = cuda_kernel.window(
                self.sublanes, self.iters, self.nblocks, self.group
            )
        except ValueError as e:
            raise WorkError(str(e)) from e
        # Global per-step window: every gang flavor (mesh, fan) multiplies
        # the per-device window by its width; one logical frontier advances
        # by the global chunk.
        gang_width = mesh_devices if self.mesh else (len(self.fan) if self.fan else 1)
        self.chunk = self.chunk_per_shard * gang_width
        if self.chunk >= 1 << 31:
            raise WorkError(
                f"per-dispatch window {self.chunk} nonces (sublanes*128*iters"
                f"*nblocks*mesh_devices) must stay below 2^31"
            )
        # One launch may widen to run_steps consecutive windows; the cap
        # bounds cancel latency (a launch cannot be interrupted) and keeps
        # the span below the kernel's 2^31-offset limit.
        if run_steps is None:
            run_steps = _RUN_STEPS[dev.type]
        max_by_window = ((1 << 31) - 1) // self.chunk
        self.run_steps = max(1, min(run_steps, max_by_window))
        # Persistent run mode: a launch is one device-resident loop of
        # windows polling a host control block every control_poll_steps
        # windows (ops/runloop.py), so cancel/raise/cover_range land
        # MID-LAUNCH and launch length no longer caps cancel latency. The
        # 2^31 limit applies per window (the device advances the 64-bit base
        # between windows), not per launch.
        if run_mode not in ("chunked", "persistent"):
            raise WorkError(
                f"run_mode must be 'chunked' or 'persistent', not {run_mode!r}"
            )
        if run_mode == "persistent" and self.mesh is not None:
            # Refused as the JAX engine refuses it: there the gang is one
            # SPMD program whose replicated control poll can diverge across
            # devices. Persistent multi-device search is the fan's.
            raise WorkError(
                "run_mode=persistent cannot drive the mesh gang: use "
                "devices=N (the device fan) for persistent multi-device search"
            )
        self.run_mode = run_mode
        if control_poll_steps < 0:
            raise WorkError("control_poll_steps must be >= 0 (0 = auto)")
        self.control_poll_steps = control_poll_steps or _POLL_STEPS[dev.type]
        if persistent_steps is None:
            # 16x the chunked window cap, as the JAX engine: one launch per
            # request (2^33 nonces per row at the GPU geometry, 16x the
            # expected work at fffffff800000000), with cancel still bounded
            # by one poll interval.
            persistent_steps = self.run_steps * 16
        self.persistent_steps = max(persistent_steps, 1)
        self._clock = clock or SystemClock()
        self.max_batch = max_batch
        self.pipeline = max(1, pipeline)
        if step_ladder not in ("x4", "x2"):
            raise WorkError(f"step_ladder must be 'x4' or 'x2', not {step_ladder!r}")
        self.step_ladder = step_ladder
        # Launches that run behind another one (pipelined successors,
        # speculation, or any launch while another rung has demand) buy no
        # latency with width; capping them bounds how long fresh arrivals
        # and cancels wait behind someone else's scan.
        if shared_steps_cap is None:
            shared_steps_cap = max(1, self.run_steps // 4)
        self.shared_steps_cap = max(1, min(shared_steps_cap, self.run_steps))
        # A launch that never returns (a wedged card) fails the engine with a
        # WorkError after launch_timeout instead of hanging its waiters.
        if launch_timeout is None:
            launch_timeout = _LAUNCH_TIMEOUT[dev.type]
        self.launch_timeout = launch_timeout
        # A plain chunked launch on the card can have rows stopped while it
        # runs: the search kernel re-reads each row's out word every
        # stride. Persistent launches have the control channel instead; the
        # fan and the mesh have neither.
        self._row_stops = (
            run_mode == "chunked" and self.fan is None and self.mesh is None
            and dev.type == "cuda"
        )
        self._executor: Optional[concurrent.futures.ThreadPoolExecutor] = None
        self._tls = threading.local()  # per launch thread: its CUDA streams
        # Persistent launches share ONE stream PER DEVICE: each is a
        # cooperative grid holding every SM of its card with grid-wide
        # barriers, and two of them on two streams of one card could each
        # hold part of it and wait forever. A pipelined successor queues
        # behind the running launch instead.
        self._persistent_streams: Dict[int, "torch.cuda.Stream"] = {}
        self._lock = threading.Lock()  # guards the shared streams' creation
        self._jobs: Dict[str, _Job] = {}
        self._inflight: deque = deque()
        self._last_rung = -1  # round-robin cursor over difficulty rungs
        self._engine_task: Optional[asyncio.Task] = None
        self._wakeup = asyncio.Event()
        self._closed = False
        self.total_hashes = 0
        self.total_solutions = 0
        # Every applied launch is a span on the tracer's ring (its stamps,
        # shape and jobs' trace ids); the set-up marks its start-up phases.
        self._tracer = obs.get_tracer()
        # The engine families, named, bucketed and labelled as the JAX
        # engine's (engine="torch" where it writes "jax"): batch occupancy,
        # executor-queue vs device time from the launch stamps, scan rate.
        reg = obs.get_registry()
        self._m_hashes = reg.counter(
            "dpow_engine_hashes_total", "Nonces scanned on device", ("engine",))
        self._m_solutions = reg.counter(
            "dpow_engine_solutions_total", "Nonces found and host-validated",
            ("engine",))
        # The part of dpow_engine_hashes_total scanned in rows whose job was
        # already answered when their launch was applied: 'solved' by an
        # earlier launch, or 'cancelled' (cancelled, closed or failed).
        self._m_wasted = reg.counter(
            "dpow_engine_wasted_hashes_total",
            "Nonces scanned for jobs already answered when the launch was "
            "applied, by cause", ("engine", "cause"))
        self._m_rows_stopped = reg.counter(
            "dpow_engine_rows_stopped_total",
            "Rows of in-flight chunked launches stopped mid-launch because "
            "their job was answered, by cause", ("engine", "cause"))
        for cause in ("solved", "cancelled"):
            self._m_wasted.inc(0, "torch", cause)
            self._m_rows_stopped.inc(0, "torch", cause)
        self._m_batch_rows = reg.histogram(
            "dpow_engine_batch_occupancy",
            "Live jobs packed per device launch (padding excluded)",
            buckets=(1, 2, 4, 8, 16, 32, 64, 128))
        self._m_exec_queue = reg.histogram(
            "dpow_engine_executor_queue_seconds",
            "Launch wait between executor submit and the launch thread "
            "starting", ("engine",))
        self._m_device_seconds = reg.histogram(
            "dpow_engine_device_seconds",
            "Blocking device launch time (dispatch + scan + readback)",
            ("engine",))
        self._m_queue_wait = reg.histogram(
            "dpow_engine_queue_wait_seconds",
            "Job wait from submission to its first device dispatch",
            ("engine",))
        self._m_jobs = reg.gauge(
            "dpow_engine_jobs", "Jobs currently tracked by the engine",
            ("engine",))
        self._m_rungs = reg.gauge(
            "dpow_engine_rungs", "Distinct difficulty rungs with live demand")
        self._m_hash_rate = reg.gauge(
            "dpow_engine_hash_rate_hs",
            "Scan rate of the most recently applied launch (H/s)", ("engine",))
        # Persistent-mode families, named as the JAX engine's: launch
        # length, control-channel traffic and poll-to-effect latency.
        self._m_p_windows = reg.histogram(
            "dpow_backend_persistent_launch_windows",
            "Windows a persistent launch actually ran before win/cancel/"
            "span end",
            buckets=(1, 4, 16, 64, 256, 1024, 4096))
        self._m_p_polls = reg.counter(
            "dpow_backend_persistent_polls_total",
            "Mid-launch control polls served to devices (mailbox reads)")
        self._m_p_control = reg.counter(
            "dpow_backend_persistent_control_total",
            "Mid-launch control commands delivered on device", ("action",))
        self._m_p_effect = reg.histogram(
            "dpow_backend_persistent_effect_seconds",
            "Control command issue -> device delivery latency on the "
            "engine's injectable clock")
        # Where a persistent launch's time goes: a row the device has seen
        # done waits for the launch to return with its slowest row, while
        # the run kernel deals its grid over the rows still live.
        self._m_p_row_windows = reg.counter(
            "dpow_backend_persistent_row_windows_total",
            "Windows of persistent launches' job rows: live until the poll "
            "that saw the row done, done from then until the launch returned",
            ("state",))
        self._m_p_returns = reg.counter(
            "dpow_backend_persistent_returns_total",
            "Persistent launches applied, by why they returned", ("cause",))
        self._m_p_grid_windows = reg.counter(
            "dpow_backend_persistent_grid_windows_total",
            "Windows persistent launches' run kernels ran with their grid dealt "
            "over every row (even) or over fewer, done rows' blocks re-granted "
            "to the live ones (regranted)", ("grid",))
        for state in ("live", "done"):
            self._m_p_row_windows.inc(0, state)
        for grid in ("even", "regranted"):
            self._m_p_grid_windows.inc(0, grid)
        for cause in PERSISTENT_RETURNS:
            self._m_p_returns.inc(0, cause)
        # Per-device families (fan mode), named as the JAX engine's. Label
        # cardinality is the fan width.
        self._m_dev_rate = reg.gauge(
            "dpow_backend_device_hash_rate_hs",
            "Per-device scan rate of the most recently applied fanned "
            "launch (H/s)", ("device",))
        self._m_dev_launches = reg.counter(
            "dpow_backend_device_launches_total",
            "Fanned launches applied, per device", ("device",))
        self._m_dev_hashes = reg.counter(
            "dpow_backend_device_hashes_total",
            "Nonces scanned per device across fanned launches", ("device",))
        self._m_dev_busy = reg.gauge(
            "dpow_backend_device_busy_fraction",
            "Fraction of wall time the device spent executing fanned "
            "launches (occupancy)", ("device",))
        self._m_dev_wins = reg.counter(
            "dpow_backend_device_wins_total",
            "Wins attributed to the device whose sub-range produced the "
            "nonce", ("device",))
        self._m_dev_ema = reg.gauge(
            "dpow_backend_device_ema_hs",
            "EMA of win-attributed scan rate on the device's own scan "
            "clock (H/s)", ("device",))
        self._m_threads_leaked = reg.counter(
            "dpow_backend_launch_threads_leaked_total",
            "Launch threads abandoned still running (watchdog ejection, "
            "launch timeout, or wedged past the close() join bound), "
            "detached and counted instead of awaited forever")
        # Fan bookkeeping: per-device busy seconds + EMA folds, the wall
        # anchor for busy-fraction, and the last win's attribution record.
        n_fan = len(self.fan) if self.fan else 0
        self._fan_wall_t0 = self._clock.time()
        self._dev_busy = [0.0] * n_fan
        self.device_ema = [0.0] * n_fan
        self.fan_ema_alpha = 0.3
        self.last_win: Optional[dict] = None
        # -- device fault domains (resilience/devfault.py) ---------------
        # The watchdog runs wherever the progress signal exists (persistent
        # launches, any width); chunked launches have no mid-launch
        # bookkeeping, so their whole-launch backstop only arms when
        # device_suspect_after is set explicitly.
        if device_suspect_after < 0:
            raise WorkError("device_suspect_after must be >= 0 (0 = auto)")
        self._watchdog_enabled = run_mode == "persistent" or device_suspect_after > 0
        self.device_suspect_after = device_suspect_after or 30.0
        self.device_probe_interval = device_probe_interval
        self.close_join_timeout = close_join_timeout
        self._dfd = DeviceFaultDomains(
            n_fan or 1,
            suspect_after=self.device_suspect_after,
            probe_interval=device_probe_interval,
            clock=self._clock,
        )
        self._watchdog_task: Optional[asyncio.Task] = None
        self._probe_tasks: Dict[int, asyncio.Task] = {}
        self._devices_exhausted = False
        # EMA of wall seconds per launch window (applied launches): the
        # poll-cadence → seconds conversion of the progress deadlines.
        self._window_seconds = 0.0
        # EMA of dispatch → first-poll latency: a launch that has not polled
        # yet (queued behind another, or building) gets this much grace.
        self._first_poll_seconds = 0.0

    # -- WorkBackend interface -------------------------------------------

    async def setup(self) -> None:
        self._closed = False  # setup() after close() reopens the engine
        if self.device.type == "cuda":
            try:
                await asyncio.to_thread(self._create_contexts)
                self._tracer.startup_mark("cuda_context")
                await asyncio.to_thread(self._load_kernels)
                self._tracer.startup_mark("kernels")
            except RuntimeError as e:
                raise WorkError(f"CUDA kernel setup failed: {e}") from e
        # Self-test: the engine must find a planted easy solution. Fan
        # launches return per-device arrays; flat[0] is device 0 / row 0,
        # and device 0's sub-range starts at the probe base.
        probe = search.pack_params(bytes(32), 1, base=0)
        lo, hi = await self._await_launch(
            self._submit_launch(np.stack([probe]), 1), "setup self-test"
        )
        if int(lo.flat[0]) != 0 or int(hi.flat[0]) != 0:
            raise WorkError(
                f"backend self-test failed "
                f"(nonce {int(hi.flat[0]):08x}{int(lo.flat[0]):08x})"
            )
        self._tracer.startup_mark("self_test")

    def _create_contexts(self) -> None:
        """Create the CUDA context of every card the engine launches on, on
        its own: the first device call creates it lazily otherwise, inside
        whichever step comes first."""
        if self.mesh is not None:
            cards = list(self.mesh.devices.flat)
        else:
            cards = self.fan or [self.device]
        for card in cards:
            torch.cuda.synchronize(card)

    def _load_kernels(self) -> None:
        """Build and load the kernel libraries; a persistent engine also
        pools its controlled launches' mailboxes, on its own cards only."""
        cuda_kernel.load_libraries()
        if self.run_mode == "persistent":
            cuda_kernel.prepare_mailboxes(self.fan or [self.device])

    async def generate(self, request: WorkRequest) -> str:
        if self._closed:
            raise WorkError("backend closed")
        if self._devices_exhausted:
            # The fault domains already declared every device quarantined:
            # fail fast instead of queueing work behind re-admission probes.
            raise DevicesExhausted(
                f"all {self._dfd.n} device(s) quarantined; awaiting a "
                "successful re-admission probe"
            )
        key = request.block_hash
        existing = self._jobs.get(key)
        if existing is not None and not existing.cancelled and not existing.future.done():
            # Dedup concurrent generates for the same hash. A stronger
            # difficulty raises the shared job's target: the eventual nonce
            # then satisfies every waiter; a weaker/equal one just shares.
            if request.difficulty > existing.difficulty:
                self._raise_job_target(existing, request.difficulty)
            return await self._await_job(existing)
        job = _Job(
            block_hash=key,
            difficulty=request.difficulty,
            params=search.pack_params(request.hash_bytes, request.difficulty, 0),
            future=asyncio.get_running_loop().create_future(),
            base=0,
            t_submit=time.perf_counter(),
            trace_id=self._tracer.id_for(key),
        )
        # An assigned nonce range pins the scan base to its start (a soft
        # hint: the scan runs on past its end). Without one, a random base
        # decorrelates this engine from every other searcher.
        if request.nonce_range is not None:
            start, length = request.nonce_range
        else:
            start, length = secrets.randbits(64), 0
        if self.fan is not None:
            self._fan_partition(job, start, length)
        else:
            job.set_base(start)
        self._jobs[key] = job
        self._ensure_engine()
        self._wakeup.set()
        return await self._await_job(job)

    async def _await_job(self, job: _Job) -> str:
        def abort():  # engine drops cancelled jobs from the next pack
            job.cancelled = True
            # ...and a persistent launch frees the rows within one poll.
            self._control_cancel_job(job)

        return await await_shared_job(job, abort)

    async def cancel(self, block_hash: str) -> None:
        job = self._jobs.get(nc.validate_block_hash(block_hash))
        if job is not None and not job.future.done():
            job.cancelled = True
            job.future.set_exception(WorkCancelled(job.block_hash))
            # Persistent launches are steerable: the device frees the
            # cancelled rows within one poll interval instead of grinding
            # them to span end.
            self._control_cancel_job(job)

    async def raise_difficulty(self, block_hash: str, difficulty: int) -> bool:
        """Retarget a running job in place; the per-launch difficulty
        snapshot keeps an in-flight launch's weaker hit searching on past it
        at the new target. Persistent launches are retargeted MID-FLIGHT
        through the control channel at their next poll, on every device."""
        job = self._jobs.get(nc.validate_block_hash(block_hash))
        if job is None or job.cancelled or job.future.done():
            return False
        if difficulty > job.difficulty:
            self._raise_job_target(job, difficulty)
        return True

    def _raise_job_target(self, job: _Job, difficulty: int) -> None:
        """Raise a job's target AND steer any running persistent launch
        (shared by raise_difficulty and the dedup-upgrade path)."""
        prev_miss = job.inflight_miss
        job.set_difficulty(difficulty)
        covered, span = self._control_raise_job(job, difficulty)
        if covered:
            # A live launch carries the raised target in place: the job
            # stays covered (set_difficulty reset it to uncovered for the
            # chunked case, where in-flight spans scan the OLD target).
            job.inflight_miss = min(prev_miss, self._miss_factor(difficulty, span))

    # -- persistent mid-launch control ------------------------------------

    def _live_controls(self, job: _Job) -> list:
        """(rec, row) for each in-flight persistent launch carrying ``job``,
        oldest first."""
        out = []
        for rec in self._inflight:
            if rec.control is None:
                continue
            for i, j in enumerate(rec.jobs):
                if j is job:
                    out.append((rec, i))
        return out

    def _control_cancel_job(self, job: _Job, cause: str = "cancelled") -> None:
        """Free the job's device rows: deliver CANCEL to every in-flight
        persistent launch still scanning it (no epoch check: stopping a row
        is valid whatever it was aimed at), and stop its rows in running
        chunked launches (``cause``: why the job needs no more nonces)."""
        for rec, row in self._live_controls(job):
            rec.control.cancel(row)
        self._stop_rows(job, cause)

    def _stop_rows(self, job: _Job, cause: str) -> None:
        """Stop the job's rows in every in-flight launch that can stop
        them (``_Launch.stops``, open while its thread holds the launch).
        A job is answered while the launch that solved it is applied, after
        it left the FIFO, so every launch stopped here is a later one: the
        answer stays the FIFO-first hit. The job's future is done by the
        time these launches are applied, so their rows were waste anyway."""
        stopped = 0
        for rec in self._inflight:
            if rec.stops is None:
                continue
            for i, j in enumerate(rec.jobs):
                if j is job and rec.stops.stop(i):
                    stopped += 1
        if stopped:
            self._m_rows_stopped.inc(stopped, "torch", cause)

    def _control_raise_job(self, job: _Job, difficulty: int) -> tuple:
        """Deliver a raised target to running launches; (covered, span)
        where covered means at least one CURRENT-epoch launch now scans the
        job at the new difficulty. Stale-epoch launches are skipped: their
        control word is dead."""
        covered, span = False, 0
        for rec, row in self._live_controls(job):
            if rec.epochs[row] != job.epoch:
                continue
            if rec.control.raise_difficulty(row, difficulty, epoch=job.epoch):
                covered, span = True, max(span, rec.span)
        return covered, span

    def _control_rebase_job(self, job: _Job) -> tuple:
        """Re-aim the NEWEST in-flight persistent launch at the job's new
        partition (the caller already moved the job and bumped its epoch);
        the job's rows in OLDER launches are stale under the new epoch, so
        they are KILLED — stopped at their next poll, their control word
        dead to any later write. Returns (covered, span) of the rebased
        launch."""
        covered, span = False, 0
        for rec, row in reversed(self._live_controls(job)):
            if not covered:
                if self.fan is not None:
                    bases = self._rebase_bases_for(
                        rec, job, self.chunk_per_shard * rec.steps
                    )
                else:
                    bases = [job.base]
                if rec.control.rebase(row, bases, epoch=job.epoch):
                    covered, span = True, rec.span
                    continue
            rec.control.kill(row)
        return covered, span

    async def cover_range(self, block_hash: str, nonce_range: tuple) -> bool:
        """Jump a running job's scan to ``nonce_range``.

        The next pack dispatches from the new base (every device shard of a
        fan re-partitions into the range); chunked launches already in
        flight finish their old span and apply normally (a hit there is
        still a valid nonce). A running persistent launch is re-aimed
        mid-flight instead. Coverage accounting resets.
        """
        job = self._jobs.get(nc.validate_block_hash(block_hash))
        if job is None or job.cancelled or job.future.done():
            return False
        self._re_cover(job, nonce_range[0], nonce_range[1])
        return True

    def _re_cover(self, job: _Job, start: int, length: int) -> None:
        """Re-aim a running job at ``[start, start+length)``, epoch-fenced —
        the shared core of cover_range and the watchdog's evacuation: a
        launch already on the wire was aimed at the OLD region, and its
        weak hit (raised-target race) must not rewind the frontier out of
        the new one."""
        if self.fan is not None:
            # EVERY active device shard re-partitions into the range (the
            # epoch bump inside _fan_partition fences old launches).
            self._fan_partition(job, start, length)
        else:
            job.set_base(start)
            job.epoch += 1
        job.inflight_miss = 1.0
        covered, span = self._control_rebase_job(job)
        if covered:
            # A running persistent launch was re-aimed at the new range: it
            # is the covering launch. Its divide-back at apply restores the
            # miss to ~1.0, so any tail it did not reach re-dispatches from
            # the new frontier — bounded overlap, never a gap.
            job.inflight_miss = self._miss_factor(job.difficulty, span)
            if self.fan is not None:
                # The re-aimed launch starts the new partition's scan
                # clocks: its win may land before any later dispatch would
                # stamp them (none at all at pipeline 1; else a successor's,
                # just before the win, which inflates the EMA sample).
                job.dev_t0 = [self._clock.time()] * len(self.fan)
        self._wakeup.set()

    async def close(self) -> None:
        self._closed = True
        # Detach-then-await: a concurrent close() finds the slots empty.
        watchdog_task, self._watchdog_task = self._watchdog_task, None
        if watchdog_task is not None:
            watchdog_task.cancel()
            await asyncio.gather(watchdog_task, return_exceptions=True)
        probe_tasks, self._probe_tasks = list(self._probe_tasks.values()), {}
        for t in probe_tasks:
            t.cancel()
        if probe_tasks:
            await asyncio.gather(*probe_tasks, return_exceptions=True)
        for job in list(self._jobs.values()):
            if not job.future.done():
                job.future.set_exception(WorkCancelled("backend closed"))
        self._jobs.clear()
        # Persistent launches would otherwise grind their span out after
        # close: cancel every row so their threads return within one poll.
        for rec in self._inflight:
            if rec.control is not None:
                for i in range(len(rec.jobs)):
                    rec.control.cancel(i)
        self._wakeup.set()
        engine_task, self._engine_task = self._engine_task, None
        if engine_task is not None:
            try:
                await engine_task
            except Exception:
                # The engine already failed its waiters before dying.
                pass
        # Bounded join on the injectable clock: every launch thread still
        # out gets close_join_timeout to come back (persistent rows are
        # cancelled, so a healthy thread returns within one poll; a chunked
        # launch within its span). A thread still out past the bound is
        # wedged: its control rows are kill-fenced (a zombie wake-up stops
        # at its first poll and steers nothing), it is detached from the
        # interpreter-exit join and counted, instead of blocking shutdown.
        joinable = [rec for rec in list(self._inflight) if not self._launch_returned(rec)]
        if joinable:
            step = max(self.close_join_timeout / 20.0, 0.005)
            deadline = self._clock.time() + self.close_join_timeout
            while (
                any(not self._launch_returned(rec) for rec in joinable)
                and self._clock.time() < deadline
            ):
                # thread_done is set from launch threads in REAL time: the
                # real-time poll gives liveness under a frozen FakeClock,
                # while the bound itself rides the injectable clock.
                timer = asyncio.ensure_future(self._clock.sleep(step))
                # dpowlint: disable=DPOW101 — liveness poll for real launch threads; the deadline above is what rides the Clock
                poll = asyncio.ensure_future(asyncio.sleep(0.01))
                await asyncio.wait({timer, poll}, return_when=asyncio.FIRST_COMPLETED)
                timer.cancel()
                poll.cancel()
            for rec in joinable:
                if self._launch_returned(rec):
                    continue
                if rec.control is not None:
                    rec.control.kill_all()
                self._m_threads_leaked.inc(1)
                logger.error(
                    "launch thread (batch=%d, steps=%d) wedged past the %.1fs "
                    "close bound; detached and counted",
                    rec.batch, rec.steps, self.close_join_timeout,
                )
        self._inflight.clear()
        executor, self._executor = self._executor, None
        if executor is not None:
            self._detach_executor(executor)

    # -- device fault domains (resilience/devfault.py) ---------------------

    def _ensure_watchdog(self) -> None:
        if not self._watchdog_enabled or self._closed:
            return
        if self._watchdog_task is None or self._watchdog_task.done():
            self._watchdog_task = asyncio.ensure_future(self._watchdog_loop())

    async def _watchdog_loop(self) -> None:
        """Periodic health sweep on the injectable clock: declare devices
        that missed their progress deadline suspect (→ evacuate →
        quarantine) and launch re-admission probes when due."""
        interval = max(self.device_suspect_after / 4.0, 0.01)
        while not self._closed:
            await self._clock.sleep(interval)
            if self._closed:
                return
            try:
                self._watchdog_pass()
            except Exception:
                # A watchdog bug must degrade to "no fault handling", not
                # take the engine down with it.
                logger.warning("device watchdog pass failed", exc_info=True)
            self._spawn_due_probes()
            if (
                (self._engine_task is None or self._engine_task.done())
                and not self._inflight
                and len(self._dfd.healthy_devices()) == self._dfd.n
            ):
                return  # idle and fully healthy; _ensure_engine revives us

    def _expected_poll_seconds(self) -> float:
        """Expected wall seconds between a device's control polls, from the
        window-time EMA of applied launches (0.0 until one applies — the
        deadline then floors at device_suspect_after)."""
        return self._window_seconds * max(1, self.control_poll_steps)

    @staticmethod
    def _launch_returned(rec: _Launch) -> bool:
        """Has the launch THREAD actually come back? Judged by thread_done
        (set in the thread's own finally), because the asyncio wrapper reads
        done once its waiter is cancelled while the thread may be wedged.
        ``fut`` stands in only for records made without the event."""
        if rec.thread_done is not None:
            return rec.thread_done.is_set()
        return rec.fut.done()

    def _watchdog_pass(self) -> None:
        """One sweep over the in-flight launches: a device is EXPECTED to
        poll every control_poll_steps windows until all its rows are done
        or it clears its final poll block."""
        now = self._clock.time()
        suspects: list = []
        hung_chunked: list = []
        for rec in list(self._inflight):
            if self._launch_returned(rec) or rec.abandoned:
                continue
            if rec.control is not None:
                deadline = launch_deadline(
                    self._expected_poll_seconds(), self.device_suspect_after
                )
                if rec.control.first_poll_t is None:
                    # The launch has not polled at all yet (queued behind
                    # another on its device's stream, or building): grant a
                    # grace window so that does not read as a dead device.
                    deadline += max(deadline, self._first_poll_seconds * DEADLINE_SLACK)
                for s, d in enumerate(rec.fan_map or [0]):
                    if self._dfd.state(d) != HEALTHY or d in suspects:
                        continue
                    if rec.control.device_accounted(s, rec.steps, self.control_poll_steps):
                        continue
                    t, _k = rec.control.last_poll(s)
                    last = t if t is not None else rec.t_clock
                    if now - last > deadline:
                        suspects.append(d)
            else:
                # Chunked launches have no mid-launch bookkeeping: the whole
                # launch is the unit, its deadline steps-scaled, and with no
                # per-device evidence it is evacuated without quarantine.
                deadline = launch_deadline(
                    self._window_seconds * rec.steps, self.device_suspect_after
                )
                if self._window_seconds <= 0.0:
                    deadline *= 2.0  # no timing history yet: a first launch's grace
                if now - rec.t_clock > deadline:
                    hung_chunked.append(rec)
        for d in suspects:
            self._declare_suspect(d)
        for rec in hung_chunked:
            if rec in self._inflight:
                self._evacuate_launch(rec, reason="launch_hang")

    def _declare_suspect(self, d: int) -> None:
        """healthy → suspect → (evacuate) → quarantined, exactly once.

        Every launch pinned by the suspect device is ejected (a fanned
        launch cannot return while one member hangs) with its control rows
        kill-fenced, then each affected job's uncovered remainder — the
        suspect device's effective base plus its provably-dry windows — is
        re-covered onto the remaining healthy devices through the
        epoch-fenced re-cover path. Later launches run at degraded fan
        width until a probe re-admits the device."""
        if not self._dfd.mark_suspect(d):
            return
        wrecked = [
            rec for rec in list(self._inflight)
            if not self._launch_returned(rec) and not rec.abandoned
            and d in (rec.fan_map or [0])
        ]
        evacuations: Dict[int, tuple] = {}
        for rec in wrecked:
            for i, job in enumerate(rec.jobs):
                if job.cancelled or job.future.done():
                    continue
                start, length = self._dead_remainder(rec, i, job, d)
                prev = evacuations.get(id(job))
                # Several wrecked launches: keep the least-advanced
                # remainder (re-covering a superset is overlap, not a gap).
                if prev is None or ((start - job.part_start) & _MASK64) < (
                    (prev[1] - job.part_start) & _MASK64
                ):
                    evacuations[id(job)] = (job, start, length)
            self._eject_launch(rec)
        for job, start, length in evacuations.values():
            self._re_cover(job, start, length)
        if evacuations:
            # "A range was re-covered": a suspect device whose launches
            # carried only done/cancelled jobs evacuates nothing.
            self._dfd.record_evacuation("stalled_poll")
        self._dfd.quarantine(d)
        if self._dfd.exhausted():
            self._fail_devices_exhausted()
        self._wakeup.set()

    def _dead_remainder(self, rec: _Launch, i: int, job: _Job, d: int) -> tuple:
        """The suspect device's uncovered remainder of row ``i``: its
        effective base (a delivered mid-launch rebase counts) advanced by
        the windows its own polls PROVED dry, out to the end of the job's
        recorded partition range (length 0 = soft / full span)."""
        fan_map = rec.fan_map or [0]
        s = fan_map.index(d)
        base = rec.dev_bases[i][s] if rec.dev_bases is not None else rec.bases[i]
        windows = 0
        if rec.control is not None:
            eb = rec.control.effective_base(i, s)
            windows = rec.control.confirmed_no_hit_windows(i, s, self.control_poll_steps)
            if eb is not None:
                # A delivered rebase re-aimed the device at eb AT window
                # applied_at_k: only the windows after that boundary were
                # scanned from the new base.
                base = eb
                windows = max(0, windows - rec.control.applied_at_k(i, s))
        start = (base + windows * self.chunk_per_shard) & _MASK64
        if job.part_len:
            end = (job.part_start + job.part_len) & _MASK64
            length = (end - start) & _MASK64
            if length > job.part_len:
                length = 0  # frontier already past the range end: soft
            return start, length
        return start, 0

    def _eject_launch(self, rec: _Launch) -> None:
        """Pull a wrecked launch out of the pipeline: its results are
        discarded, its control rows kill-fenced (the zombie thread stops at
        its first wake-up poll and cannot be steered; the thread releases
        its slot when it returns), and the executor is replaced so the
        wedged worker cannot starve later launches."""
        rec.abandoned = True
        try:
            self._inflight.remove(rec)
        except ValueError:
            pass
        if rec.waiter is not None:
            rec.waiter.cancel()
        for job, f in zip(rec.jobs, rec.miss_factors):
            if not job.future.done() and not job.cancelled:
                # Its span will never be applied: undo the coverage factor.
                job.inflight_miss = min(1.0, job.inflight_miss / f)
        if rec.control is not None:
            rec.control.kill_all()
        rec.fut.add_done_callback(_consume_abandoned)
        if rec.thread_done is not None and not rec.thread_done.is_set():
            self._m_threads_leaked.inc(1)
        if self._executor is not None:
            self._detach_executor(self._executor)
            self._executor = None
        self._wakeup.set()

    def _evacuate_launch(self, rec: _Launch, reason: str) -> None:
        """Whole-launch evacuation (chunked backstop): eject the launch and
        re-cover each live job from the launch's own dispatch frontier
        (fan: the whole recorded partition range — chunked launches carry
        no per-device progress evidence to narrow it)."""
        jobs = [(i, j) for i, j in enumerate(rec.jobs) if not j.cancelled and not j.future.done()]
        self._eject_launch(rec)
        for i, job in jobs:
            if self.fan is not None:
                self._re_cover(job, job.part_start, job.part_len)
            else:
                self._re_cover(job, rec.bases[i], 0)
        if jobs:
            self._dfd.record_evacuation(reason)

    def _fail_devices_exhausted(self) -> None:
        """Zero healthy devices: every live waiter fails NOW with
        DevicesExhausted, and new generates refuse until a probe re-admits
        a device. The engine never carries on on another device."""
        self._devices_exhausted = True
        err_msg = (
            f"all {self._dfd.n} device(s) quarantined; awaiting a "
            "successful re-admission probe"
        )
        for job in list(self._jobs.values()):
            if not job.future.done():
                job.cancelled = True
                self._control_cancel_job(job)
                job.future.set_exception(DevicesExhausted(err_msg))
        self._wakeup.set()

    def _spawn_due_probes(self) -> None:
        for d in range(self._dfd.n):
            if not self._dfd.probe_due(d):
                continue
            task = self._probe_tasks.get(d)
            if task is not None and not task.done():
                continue
            self._probe_tasks[d] = asyncio.ensure_future(self._probe_device(d))

    async def _probe_device(self, d: int) -> None:
        """The single re-admission launch for quarantined device ``d``: a
        difficulty-1 probe row must come back (hitting at offset 0, the
        setup self-test contract) within device_suspect_after on the
        injectable clock. Success re-admits the device and re-balances live
        jobs over the restored fan; failure re-opens the probe interval. On
        the card a probe of a still-wedged device queues behind its grid on
        the device's persistent stream and times out with it."""
        probe = search.pack_params(bytes(32), 1, base=0)
        devs = (d,) if self.fan is not None else None
        ok = False
        fut = None
        try:
            fut = self._submit_launch(np.stack([probe]), 1, devices=devs)
            timer = asyncio.ensure_future(self._clock.sleep(self.device_suspect_after))
            await asyncio.wait({fut, timer}, return_when=asyncio.FIRST_COMPLETED)
            if fut.done():
                timer.cancel()
                lo, hi = fut.result()
                ok = int(lo.flat[0]) == 0 and int(hi.flat[0]) == 0
            else:
                # The probe itself hung: abandon its thread (counted) and
                # hand later launches a fresh executor.
                timer.cancel()
                fut.add_done_callback(_consume_abandoned)
                self._m_threads_leaked.inc(1)
                if self._executor is not None:
                    self._detach_executor(self._executor)
                    self._executor = None
        except asyncio.CancelledError:
            if fut is not None and not fut.done():
                fut.add_done_callback(_consume_abandoned)
            raise
        except Exception:
            ok = False  # a crashing probe is a failed probe
        prev_active = self._fan_active if self.fan is not None else None
        self._dfd.probe_result(d, ok)
        if not ok:
            return
        self._devices_exhausted = False
        if self.fan is not None:
            # Re-balance live jobs over the restored fan: re-partition each
            # from its least-advanced healthy frontier — overlap over gaps
            # (soft ranges), and the epoch bump fences degraded launches
            # still on the wire.
            for job in list(self._jobs.values()):
                if job.cancelled or job.future.done():
                    continue
                if job.dev_bases is not None and prev_active:
                    # Least-advanced RELATIVE to the partition start
                    # (wrap-aware).
                    start = min(
                        (job.dev_bases[dd] for dd in prev_active),
                        key=lambda bs: (bs - job.part_start) & _MASK64,
                    )
                else:
                    start = job.base
                length = 0
                if job.part_len:
                    length = (job.part_start + job.part_len - start) & _MASK64
                    if length > job.part_len:
                        length = 0
                self._re_cover(job, start, length)
        self._wakeup.set()

    @staticmethod
    def _detach_executor(executor) -> None:
        """shutdown(wait=False) AND waive the pool's threads from the
        interpreter-exit join: concurrent.futures joins every worker at
        shutdown, so one wedged launch thread would otherwise hang process
        exit forever. Healthy threads still complete and resolve their
        futures (private API, stable since 3.9)."""
        import concurrent.futures.thread as cft

        executor.shutdown(wait=False)
        for t in list(getattr(executor, "_threads", ()) or ()):
            cft._threads_queues.pop(t, None)

    # -- launches ---------------------------------------------------------

    def _batch_sizes(self) -> list:
        """The padded batch sizes the engine emits (ascending): powers of
        two up to max_batch."""
        sizes, b = [], 1
        while b < self.max_batch:
            sizes.append(b)
            b *= 2
        sizes.append(self.max_batch)
        return sizes

    def _step_counts(self) -> list:
        """The quantized run lengths the engine may emit (ascending):
        powers of four up to run_steps (of two with ``step_ladder="x2"``:
        base difficulty then launches 2 windows instead of 4, less span to
        drain past the hit). Persistent mode has one steerable
        span-sized rung (plus the singleton the self-test uses): the loop's
        early exit makes run-length quantization pointless."""
        if self.run_mode == "persistent":
            return [1, self.persistent_steps] if self.persistent_steps > 1 else [1]
        factor = 2 if self.step_ladder == "x2" else 4
        counts, steps = [1], 1
        while steps < self.run_steps:
            steps = min(steps * factor, self.run_steps)
            counts.append(steps)
        return counts

    @staticmethod
    def _solve_p(difficulty: int) -> float:
        """Per-nonce solve probability, floored away from 0.0."""
        return max((2**64 - difficulty) / 2**64, 1e-30)

    def _steps_for(self, difficulty: int) -> int:
        """Windows one launch should cover for this difficulty: enough that
        the median solve finishes in a single launch (2x the median window
        count), clamped to the run_steps cancel-latency cap. Persistent mode
        has no such cap (the control channel bounds cancel at one poll
        interval), so every difficulty gets the span-sized launch."""
        if self.run_mode == "persistent":
            return self.persistent_steps
        median = math.log(2) / self._solve_p(difficulty)
        windows = 2 * median / self.chunk
        for steps in self._step_counts():
            if steps >= windows:
                return steps
        return self.run_steps

    @classmethod
    def _miss_factor(cls, difficulty: int, span: int) -> float:
        """P(a span of ``span`` nonces holds no solution at ``difficulty``),
        floored away from 0.0 for the divide-back in _apply_results."""
        return max(math.exp(-span * cls._solve_p(difficulty)), 1e-12)

    def _stream(self, device: torch.device) -> "torch.cuda.Stream":
        """This launch thread's own CUDA stream on ``device``: a pipelined
        launch's readback does not wait behind its successor's scan.
        Persistent launches take the device's one shared stream (see
        __init__)."""
        if self.run_mode == "persistent":
            with self._lock:
                stream = self._persistent_streams.get(device.index)
                if stream is None:
                    stream = self._persistent_streams[device.index] = torch.cuda.Stream(
                        device=device
                    )
                return stream
        streams = getattr(self._tls, "streams", None)
        if streams is None:
            streams = self._tls.streams = {}
        stream = streams.get(device.index)
        if stream is None:
            stream = streams[device.index] = torch.cuda.Stream(device=device)
        return stream

    def _members(self, devices: Optional[tuple]) -> list:
        """The torch devices of a fan launch: every member, or the PHYSICAL
        indices ``devices`` (degraded width, probes)."""
        idx = range(len(self.fan)) if devices is None else devices
        return [self.fan[d] for d in idx]

    def _member_streams(self, members: list) -> Optional[list]:
        if self.device.type != "cuda":
            return None
        return [self._stream(d) for d in members]

    def _launch(
        self, params_batch: np.ndarray, steps: int, slot: int = 0,
        devices: Optional[tuple] = None, stops: Optional[_RowStops] = None,
    ) -> tuple:
        """One blocking batched launch (called on a worker thread).

        Returns (lo, hi) uint32[B] — absolute winning nonces per row,
        all-ones where the span held no solution; a fan launch returns
        them per device, [n_dev, B]. ``steps`` widens the span to ``steps``
        consecutive windows per device in the same launch. In persistent
        mode the span runs as one steerable launch polling control slot
        ``slot`` (0: no control block, the polls read dead zeros).
        ``devices`` pins a fan launch to those PHYSICAL member indices
        (degraded width after quarantine, single-device probes). ``stops``
        (a plain chunked launch on the card) is open while the kernel runs
        and closed with its rows' scanned counts.
        """
        ctl.launch_hook(self._launch_hook_indices(devices))
        if self.run_mode == "persistent":
            return self._launch_persistent(params_batch, steps, slot, devices)
        if self.fan is not None:
            members = self._members(devices)
            span_dev = self.chunk_per_shard * steps
            if params_batch.ndim == 2:
                # Bare rows (setup self-test, probes): stagger from each
                # row's own base so the fan covers a contiguous window.
                params_batch = fan_search.stagger(params_batch, len(members), span_dev)
            offs = fan_search.fan_search_devices(
                params_batch, devices=members, chunk_per_shard=span_dev,
                sublanes=self.sublanes, iters=self.iters, nblocks=self.nblocks * steps,
                group=self.group, streams=self._member_streams(members),
            )
            flat_p = params_batch.reshape(-1, search.PARAMS_LEN)
            lo, hi = self._offsets_to_nonces(flat_p, offs.reshape(-1))
            # Per-device absolute nonces [n_dev, B]; the host elects the
            # winner against the launch's base snapshot and attributes it.
            return lo.reshape(offs.shape), hi.reshape(offs.shape)
        kwargs = dict(
            sublanes=self.sublanes, iters=self.iters,
            nblocks=self.nblocks * steps, group=self.group,
        )
        if self.mesh is not None:
            # One ganged launch: every member scans chunk_per_shard * steps
            # nonces of each row, the host elects the lowest global offset.
            offs = mesh_search.sharded_search_chunk_batch(
                params_batch, mesh=self.mesh, chunk_per_shard=self.chunk_per_shard * steps,
                streams=self._member_streams(list(self.mesh.devices.flat)), **kwargs,
            )
            return self._offsets_to_nonces(params_batch, offs)
        if self.device.type == "cuda":
            # The self-test and probes come without a channel: nothing stops them.
            offs = self._launch_stoppable(params_batch, stops or _RowStops(), kwargs)
        else:
            params = search.params_from_numpy(params_batch, self.device)
            offs = search.offsets_to_numpy(
                cuda_kernel.cuda_search_chunk_batch(params, **kwargs)
            )
        return self._offsets_to_nonces(params_batch, offs)

    def _launch_stoppable(self, params_batch: np.ndarray, stops: _RowStops,
                          kwargs: dict) -> np.ndarray:
        """The plain chunked launch on the card with its rows stoppable
        while it runs: ``out`` and ``scanned`` share one buffer, so one
        stream-ordered copy reads both back (without a blocking wait, which
        would hold up the event loop's stops); ``stops`` is open from the
        fill until after that copy. Returns the offsets."""
        rows = params_batch.shape[0]
        scanned = None
        with torch.cuda.stream(self._stream(self.device)):
            params = search.params_from_numpy(params_batch, self.device)
            words = torch.empty(2 * rows, dtype=torch.int32, device=self.device)
            words[:rows].fill_(-1)  # SENTINEL
            words[rows:].zero_()
            stops.open(cuda_kernel.RowStopper(words[:rows]))
            try:
                cuda_kernel.cuda_search_chunk_batch(
                    params, out=words[:rows], scanned=words[rows:], **kwargs
                )
                host = cuda_kernel.read_back(words)
                scanned = host[rows:]
            finally:
                stops.close(scanned)
        return host[:rows]

    def _launch_hook_indices(self, devices: Optional[tuple]) -> tuple:
        """PHYSICAL fan indices this launch touches — the chaos seam's
        device identities (ops/control.py launch_hook)."""
        if self.fan is None:
            return (0,)
        if devices is None:
            return tuple(range(len(self.fan)))
        return tuple(devices)

    def _launch_persistent(
        self, params_batch: np.ndarray, steps: int, slot: int,
        devices: Optional[tuple] = None,
    ) -> tuple:
        """One blocking PERSISTENT launch: ``steps`` windows of
        ``chunk_per_shard`` nonces per row and device, polling control slot
        ``slot`` every ``control_poll_steps`` windows, returning on win,
        cancel or span end. Same (lo, hi) contract as the chunked launch."""
        geo = dict(sublanes=self.sublanes, iters=self.iters, nblocks=self.nblocks,
                   group=self.group)
        if self.fan is not None:
            members = self._members(devices)
            if params_batch.ndim == 2:
                # Bare rows (setup self-test, probes): block-interleave from
                # each row's own base, as the fan scans contiguously per
                # device.
                params_batch = fan_search.stagger(
                    params_batch, len(members), self.chunk_per_shard * steps
                )
            return fan_search.fan_search_run_controlled(
                params_batch, slot, devices=members, chunk_per_shard=self.chunk_per_shard,
                max_steps=steps, poll_steps=self.control_poll_steps,
                streams=self._member_streams(members), **geo,
            )
        # Nothing here may wait on the device's shared stream: a successor
        # kernel queued on it needs its own thread to serve its polls
        # (ops/cuda_kernel.py). The rows go up without a host wait and the
        # results come back on the host.
        on_card = self.device.type == "cuda"
        with torch.cuda.stream(self._stream(self.device)) if on_card else contextlib.nullcontext():
            params = search.params_from_numpy(params_batch, self.device, non_blocking=True)
            lo, hi = runloop.search_run_batch_controlled(
                params, None, slot, max_steps=steps, poll_steps=self.control_poll_steps, **geo
            )
            return search.offsets_to_numpy(lo), search.offsets_to_numpy(hi)

    def _submit_launch(
        self, params_batch: np.ndarray, steps: int, slot: int = 0,
        devices: Optional[tuple] = None, timing: Optional[dict] = None,
        thread_done: Optional[threading.Event] = None, stops: Optional[_RowStops] = None,
    ) -> asyncio.Future:
        """Hand a launch to the executor; device work starts immediately.
        ``slot`` routes a persistent launch's control polls (0: none);
        ``devices`` pins a fan launch to a subset; ``timing`` receives the
        thread's stage stamps; ``thread_done`` is set when the thread
        returns; ``stops`` is the launch's stop channel."""
        if self._executor is None:
            # pipeline launch threads + one for a re-admission probe.
            self._executor = concurrent.futures.ThreadPoolExecutor(
                max_workers=self.pipeline + 1
            )

        def call_launch():
            try:
                if timing is not None:
                    timing["t_thread"] = time.perf_counter()
                    timing["t_thread_clock"] = self._clock.time()
                    timing["thread"] = threading.current_thread().name
                kw = {} if stops is None else {"stops": stops}
                out = self._launch(params_batch, steps, slot, devices, **kw)
                if timing is not None:
                    timing["t_done"] = time.perf_counter()
                    timing["t_done_clock"] = self._clock.time()
                return out
            finally:
                # The control slot lives exactly as long as the launch:
                # releasing it earlier would feed a still-running kernel
                # dead zeros and undo its cancel flags. release() is
                # idempotent; the apply path's release stays as a backstop.
                if slot:
                    ctl.release(slot)
                if thread_done is not None:
                    thread_done.set()

        cf = self._executor.submit(call_launch)
        if slot or thread_done is not None:
            # A launch cancelled before its thread took it up never runs
            # call_launch, so its finally cannot release the slot or mark
            # the thread done.
            def release_unstarted(f: concurrent.futures.Future) -> None:
                if f.cancelled():
                    if slot:
                        # dpowlint: disable=DPOW1004 — the launch was cancelled before a thread took it up: call_launch and its finally-release never run, so no launch thread exists to outlive the slot; release() is idempotent
                        ctl.release(slot)
                    if thread_done is not None:
                        thread_done.set()

            cf.add_done_callback(release_unstarted)
        return asyncio.wrap_future(cf)

    async def _await_launch(self, fut: asyncio.Future, what: str) -> tuple:
        """``fut``'s result, bounded by launch_timeout: a launch that never
        returns fails the engine with a WorkError (its thread is detached
        and counted), instead of hanging every waiter."""
        if self.launch_timeout is None:
            return await fut
        try:
            return await asyncio.wait_for(asyncio.shield(fut), self.launch_timeout)
        except asyncio.TimeoutError:
            fut.add_done_callback(_consume_abandoned)
            if self._executor is not None:
                self._detach_executor(self._executor)
                self._executor = None
            self._m_threads_leaked.inc(1)
            raise WorkError(
                f"device launch exceeded {self.launch_timeout:.0f}s ({what})"
            ) from None

    @staticmethod
    def _offsets_to_nonces(params_batch: np.ndarray, offs: np.ndarray) -> tuple:
        """Window offsets → (lo, hi) uint32 nonces, all-ones where unsolved."""
        base_lo = params_batch[:, search.BASE_LO]
        win_lo = (base_lo + offs).astype(np.uint32)  # uint32 wrap
        carry = (win_lo < base_lo).astype(np.uint32)
        win_hi = (params_batch[:, search.BASE_HI] + carry).astype(np.uint32)
        unsolved = offs == search.SENTINEL
        ones = np.uint32(0xFFFFFFFF)
        return np.where(unsolved, ones, win_lo), np.where(unsolved, ones, win_hi)

    _PAD_ROW = search.pack_params(bytes(32), 0, 0)

    def _pack(self, jobs: list, b: int) -> np.ndarray:
        """Fixed-shape batch: active jobs + difficulty-0 padding.

        Difficulty 0 makes a padding row hit at offset 0, so the kernel's
        early exit drains it after one stride. Pad results are discarded.
        """
        out = np.empty((b, search.PARAMS_LEN), dtype=np.uint32)
        for i in range(b):
            out[i] = jobs[i].params if i < len(jobs) else self._PAD_ROW
        return out

    # -- device fan (devices != 0) ------------------------------------------

    @property
    def _fan_active(self) -> list:
        """PHYSICAL indices of the devices currently in the fan: the healthy
        set of the fault domains. Quarantined devices are excluded from
        partitions and launches until a probe re-admits them."""
        return self._dfd.healthy_devices()

    def _fan_partition(self, job: _Job, start: int, length: int) -> None:
        """Sub-partition ``[start, start+length)`` (length 0 = full 2^64
        span) across the HEALTHY fan.

        'split' gives each device a contiguous macro-range (its own shard:
        per-device frontier, scan counter and scan clock). 'interleave'
        keeps ONE frontier and deals consecutive per-launch windows
        round-robin (device d takes the d-th window of every launch). Ends
        are soft either way: a device may overrun into its neighbor's
        sub-range rather than strand a dispatch whose shard holds no
        solution.
        """
        n_total = len(self.fan)
        active = self._fan_active
        n = max(len(active), 1)
        job.set_base(start)
        job.part_start, job.part_len = start & _MASK64, length
        if self.device_shard == "split":
            stride = max((length or (1 << 64)) // n, 1)
            # Full-length table (stale entries for quarantined devices are
            # never packed); strides go to the healthy set in order.
            if job.dev_bases is None or len(job.dev_bases) != n_total:
                job.dev_bases = [start & _MASK64] * n_total
            for i, d in enumerate(active):
                job.dev_bases[d] = (start + i * stride) & _MASK64
        else:
            job.dev_bases = None  # derived from the frontier at pack time
        job.dev_scanned = [0] * n_total
        job.dev_t0 = None  # stamped at the first dispatch of this partition
        job.epoch += 1

    def _fan_launch_bases(self, job: _Job, span_dev: int) -> list:
        """This launch's per-slice bases for one job (pre-advance),
        parallel to the current healthy set."""
        active = self._fan_active
        if job.dev_bases is not None:  # split: each device's own frontier
            return [job.dev_bases[d] for d in active]
        # interleave: consecutive windows of the single frontier
        return [(job.base + i * span_dev) & _MASK64 for i in range(len(active))]

    def _rebase_bases_for(self, rec: _Launch, job: _Job, span_dev: int) -> list:
        """Per-slice rebase bases for a RUNNING launch — keyed by the
        launch's own fan_map, which may differ from the current healthy set
        (a pre-quarantine launch still on the wire)."""
        fan_map = rec.fan_map or list(range(len(self.fan)))
        if job.dev_bases is not None:
            return [job.dev_bases[d] for d in fan_map]
        return [(job.base + s * span_dev) & _MASK64 for s in range(len(fan_map))]

    def _fan_advance(self, job: _Job, span_dev: int) -> None:
        """Speculative frontier advance at dispatch (active device shards)."""
        active = self._fan_active
        if job.dev_bases is not None:
            for d in active:
                job.dev_bases[d] = (job.dev_bases[d] + span_dev) & _MASK64
        else:
            job.set_base(job.base + span_dev * max(len(active), 1))

    def _fan_stack(self, jobs: list, b: int, steps: int) -> tuple:
        """Fan batch: uint32[n_dev, b, 12] plus the per-job base snapshot.
        Row content matches _pack; each device's slice carries that
        device's base words. Width is the HEALTHY fan."""
        n = len(self._fan_active)
        span_dev = self.chunk_per_shard * steps
        rows = self._pack(jobs, b)
        stacked = np.repeat(rows[None], n, axis=0)
        snap = []
        for i, job in enumerate(jobs):
            bases = self._fan_launch_bases(job, span_dev)
            snap.append(bases)
            for d, base in enumerate(bases):
                stacked[d, i, search.BASE_LO] = base & 0xFFFFFFFF
                stacked[d, i, search.BASE_HI] = base >> 32
        return stacked, snap

    # -- engine -----------------------------------------------------------

    def _ensure_engine(self) -> None:
        if self._engine_task is None or self._engine_task.done():
            self._engine_task = asyncio.ensure_future(self._engine_loop())
        self._ensure_watchdog()

    def _next_rung(self, rungs: Dict[int, list]) -> int:
        """Next difficulty rung to serve, round-robin by run length."""
        keys = sorted(rungs)
        for k in keys:
            if k > self._last_rung:
                self._last_rung = k
                return k
        self._last_rung = keys[0]
        return keys[0]

    def _dispatch_next(self, inflight: int = 0) -> "Optional[_Launch]":
        """Pack and submit one launch for the next difficulty rung, or None
        when nothing is worth dispatching.

        Jobs are grouped into rungs by the run length their difficulty
        wants; each launch serves ONE rung (round-robin). Within a rung,
        jobs that in-flight spans are unlikely to solve go first; only when
        every alive job is covered does the engine speculate (down to
        SPEC_MISS_FLOOR). Each included job's base advances speculatively
        here, so a successor launch scans the NEXT span.
        """
        self._gc_jobs()
        if self._devices_exhausted or (self.fan is not None and not self._fan_active):
            return None  # zero healthy devices: nothing can be dispatched
        alive = [j for j in self._jobs.values() if not j.cancelled]
        if not alive:
            return None
        rungs: Dict[int, list] = {}
        for j in alive:
            rungs.setdefault(self._steps_for(j.difficulty), []).append(j)
        for cutoff in (SPEC_MISS_THRESHOLD, SPEC_MISS_FLOOR):
            cands = {
                k: eligible
                for k, js in rungs.items()
                if (eligible := [j for j in js if j.inflight_miss >= cutoff])
            }
            if cands:
                break
        else:
            return None  # everything in flight is near-certain to solve
        speculative = cutoff == SPEC_MISS_FLOOR
        rung_key = self._next_rung(cands)
        steps = rung_key
        # Only the head of the device queue needs full width. Persistent
        # launches are exempt: the cap bounds how long queued work and
        # cancels wait behind one launch, and the control channel bounds
        # that at one poll interval.
        if (
            (speculative or inflight > 0 or len(rungs) > 1)
            and steps > self.shared_steps_cap
            and self.run_mode != "persistent"
        ):
            steps = max(s for s in self._step_counts() if s <= self.shared_steps_cap)
        # Least-covered first (ties keep insertion order: oldest job wins).
        pool = sorted(cands[rung_key], key=lambda j: -j.inflight_miss)
        if speculative:
            active, waste = [], 0.0
            for j in pool:
                waste += 1.0 - j.inflight_miss
                if active and waste > SPEC_WASTE_ROWS:
                    break
                active.append(j)
                if len(active) == self.max_batch:
                    break
        else:
            active = pool[: self.max_batch]
        b = next(s for s in self._batch_sizes() if s >= len(active))
        dev_snap, fan_map, launch_devs = None, None, None
        if self.fan is not None:
            # Snapshot the healthy set: the launch runs on exactly these
            # devices, and every apply/attribution path maps its slices
            # through this list — the watchdog may shrink the fan while
            # this launch is still on the wire.
            fan_map = list(self._fan_active)
            params, dev_snap = self._fan_stack(active, b, steps)
            if fan_map != list(range(len(self.fan))):
                launch_devs = tuple(fan_map)
            span = self.chunk_per_shard * steps * len(fan_map)
            for j in active:
                if j.dev_t0 is None:
                    # Per-device scan clocks start at the partition's first
                    # dispatch (all devices launch together in one pack).
                    j.dev_t0 = [self._clock.time()] * len(self.fan)
        else:
            params = self._pack(active, b)
            span = self.chunk * steps
        factors = [self._miss_factor(j.difficulty, span) for j in active]
        # Stamped before the submit: the executor-queue histogram measures
        # dispatch -> launch thread start.
        timing: dict = {"t_dispatch": time.perf_counter(), "inflight": inflight}
        self._m_batch_rows.observe(len(active))
        self._m_jobs.set(len(self._jobs), "torch")
        self._m_rungs.set(len(rungs))
        for job in active:
            if not job.t_first_dispatch:
                job.t_first_dispatch = timing["t_dispatch"]
                self._tracer.mark_hash(job.block_hash, "pack")
        slot, launch_control = 0, None
        if self.run_mode == "persistent":
            # One control block per launch, slot-registered so the launch
            # threads can route the kernels' polls; the launch thread
            # releases the slot once the launch has returned.
            launch_control = ctl.LaunchControl(
                b, clock=self._clock, n_dev=len(fan_map) if fan_map else 1,
                fan_map=fan_map,
            )
            slot = ctl.register(launch_control)
        thread_done = threading.Event()
        stops = _RowStops() if self._row_stops else None
        rec = _Launch(
            fut=self._submit_launch(
                params, steps, slot, devices=launch_devs, timing=timing,
                thread_done=thread_done, stops=stops,
            ),
            jobs=active,
            # Snapshot targets and bases at launch: a concurrent dedup may
            # raise job.difficulty, and a pipelined successor dispatch will
            # advance job.base, while this launch is in flight.
            launched_difficulty=[j.difficulty for j in active],
            bases=[j.base for j in active],
            epochs=[j.epoch for j in active],
            span=span,
            miss_factors=factors,
            steps=steps,
            batch=b,
            control=launch_control,
            slot=slot,
            dev_bases=dev_snap,
            fan_map=fan_map,
            timing=timing,
            t_clock=self._clock.time(),
            thread_done=thread_done,
            stops=stops,
        )
        span_dev = self.chunk_per_shard * steps
        for job, f in zip(active, factors):
            if self.fan is not None:
                self._fan_advance(job, span_dev)
            else:
                job.set_base(job.base + span)
            job.inflight_miss *= f
        return rec

    def _apply_results(self, rec: _Launch, lo_arr, hi_arr) -> None:
        """Apply one launch's results: once per launch in every run mode (a
        fanned or ganged launch is one record however many members ran it),
        so the engine families count launches, not members."""
        timing = rec.timing
        timing["t_apply"] = time.perf_counter()
        timing["batch"], timing["steps"] = rec.batch, rec.steps
        timing["stopped"] = len(rec.stops.rows) if rec.stops is not None else 0
        if "t_thread" in timing and "t_done" in timing:
            self._m_exec_queue.observe(
                max(0.0, timing["t_thread"] - timing["t_dispatch"]), "torch"
            )
            self._m_device_seconds.observe(
                max(0.0, timing["t_done"] - timing["t_thread"]), "torch"
            )
        c = rec.control
        windows_ran = rec.steps
        if c is not None:
            # The launch is off the device: retire its slot (idempotent; the
            # launch thread released it already) and export what the channel
            # saw — launch length, polls, commands delivered and their
            # issue->delivery latency on the injectable clock.
            # dpowlint: disable=DPOW1004 — apply path: the thread already returned its results (we hold them), so its finally-release landed first; this is the idempotent belt-and-suspenders release
            ctl.release(rec.slot)
            windows_ran = min(c.last_k + self.control_poll_steps, rec.steps)
            self._m_p_polls.inc(c.polls)
            self._m_p_windows.observe(windows_ran)
            for _row, action, latency, _token in c.delivered:
                self._m_p_control.inc(1, action)
                self._m_p_effect.observe(latency)
            self._count_persistent_rows(rec, windows_ran, lo_arr, hi_arr)
        self._tracer.launch(timing, [j.trace_id for j in rec.jobs if j.trace_id])
        if "t_done" in timing and "t_thread" in timing:
            # Wall seconds per launch window (EMA): the poll-cadence →
            # seconds conversion behind the watchdog's progress deadlines.
            dev_s = timing["t_done"] - timing["t_thread"]
            if dev_s > 0.0 and windows_ran > 0:
                w = dev_s / windows_ran
                self._window_seconds = (
                    w if self._window_seconds <= 0.0 else 0.3 * w + 0.7 * self._window_seconds
                )
        if c is not None and c.first_poll_t is not None:
            # Dispatch → first-poll latency on the engine clock: the
            # never-polled-yet grace window's scale.
            fp = max(0.0, c.first_poll_t - rec.t_clock)
            self._first_poll_seconds = (
                fp if self._first_poll_seconds <= 0.0 else 0.3 * fp + 0.7 * self._first_poll_seconds
            )
        for job, f in zip(rec.jobs, rec.miss_factors):
            # This launch is no longer in flight: undo its coverage factor
            # (clamped — repeated multiply/divide may drift past 1.0).
            job.inflight_miss = min(1.0, job.inflight_miss / f)
            job.applied_launches += 1
        if rec.dev_bases is not None:
            applied_hashes, wasted = self._apply_fan_rows(rec, lo_arr, hi_arr)
        else:
            applied_hashes, wasted = self._apply_plain_rows(rec, lo_arr, hi_arr)
        self.total_hashes += applied_hashes
        self._m_hashes.inc(applied_hashes, "torch")
        for cause, n in wasted.items():
            if n:
                self._m_wasted.inc(n, "torch", cause)
        if timing.get("t_done", 0.0) > timing.get("t_thread", 0.0):
            self._m_hash_rate.set(
                applied_hashes / (timing["t_done"] - timing["t_thread"]), "torch"
            )

    def _count_persistent_rows(self, rec: _Launch, windows_ran: int, lo_arr, hi_arr) -> None:
        """Count a persistent launch's job rows (pad rows excluded) on every
        device it ran on: a row is live from the launch's first window until
        the poll that saw it done (``done_at_k``), and done from then until
        the launch returned. The launch returned at its span's end when a
        job row was still live there without a hit (``span_end``), at a poll
        when every row had been seen done there, the last ones stopped by
        the host's cancel or kill (``killed``: the loop ends at that poll,
        not one block later), else when its last rows hit (``all_done``).
        The launch span carries the windows, live row-windows and cause.
        The windows each device's run kernel reported, dealt over every row
        or re-granted to fewer (``c.grid_windows``), count as they are."""
        c = rec.control
        grid = list(c.grid_windows.values())
        self._m_p_grid_windows.inc(sum(even for even, _ in grid), "even")
        self._m_p_grid_windows.inc(sum(regranted for _, regranted in grid), "regranted")
        ones = np.uint32(0xFFFFFFFF)
        unsolved = ((np.asarray(lo_arr) == ones) & (np.asarray(hi_arr) == ones)).reshape(
            c.n_dev, -1)
        seen = c.done_at_k
        rows = range(len(rec.jobs))
        if any(unsolved[d, i] and (i, d) not in seen
               for d in range(c.n_dev) for i in rows):
            cause = "span_end"
        elif all((i, d) in seen for d in range(c.n_dev) for i in range(rec.batch)):
            cause, windows_ran = "killed", c.last_k
        else:
            cause = "all_done"
        live = sum(c.windows_run(i, windows_ran, d) for d in range(c.n_dev) for i in rows)
        self._m_p_row_windows.inc(live, "live")
        self._m_p_row_windows.inc(windows_ran * len(rec.jobs) * c.n_dev - live, "done")
        self._m_p_returns.inc(1, cause)
        rec.timing.update(windows_ran=windows_ran, live_row_windows=live, cause=cause)

    def _record_solve(self, job: _Job, work: str) -> None:
        """Shared per-solve bookkeeping (plain and fan apply paths)."""
        self.total_solutions += 1
        self._m_solutions.inc(1, "torch")
        self._tracer.mark_hash(job.block_hash, "device")
        if job.t_submit:
            self._m_queue_wait.observe(
                max(0.0, job.t_first_dispatch - job.t_submit), "torch"
            )
        # Successors still scanning the solved job stop: persistent ones
        # within one poll interval, chunked ones on the card within a stride.
        self._control_cancel_job(job, "solved")
        job.future.set_result(work)

    @staticmethod
    def _answered(job: _Job) -> Optional[str]:
        """Why ``job`` needs no more nonces, as a launch carrying it is
        applied: 'solved' (its future holds work from an earlier launch),
        'cancelled' (cancelled, closed or failed), or None: it still needs
        them."""
        fut = job.future
        if not fut.done():
            return None
        if fut.cancelled() or fut.exception() is not None:
            return "cancelled"
        return "solved"

    def _invalid_work(self, job: _Job, work: str, value: int, launched: int) -> None:
        """Device/host disagreement: a real bug, surfaced to the waiter."""
        job.future.set_exception(
            WorkError(
                f"device produced invalid work {work} for "
                f"{job.block_hash} (value {value:016x} < {launched:016x})"
            )
        )

    def _apply_plain_rows(self, rec: _Launch, lo_arr, hi_arr) -> tuple:
        """Apply a plain or ganged launch's rows; returns the nonces they
        scanned, and of those the ones scanned for jobs already answered, by
        cause."""
        applied_hashes = 0
        wasted = {"solved": 0, "cancelled": 0}
        c = rec.control
        stopped = rec.stops.rows if rec.stops is not None else ()
        for i, (job, launched, base, epoch, lo, hi) in enumerate(zip(
            rec.jobs, rec.launched_difficulty, rec.bases, rec.epochs,
            lo_arr[: len(rec.jobs)], hi_arr[: len(rec.jobs)],
        )):
            if c is not None:
                # Mid-launch control may have moved what the dispatch
                # snapshot says: a DELIVERED rebase moved the row's base and
                # epoch, a delivered raise the target it was judged by.
                eb, ed = c.effective_base(i), c.effective_difficulty(i)
                base = base if eb is None else eb
                launched = launched if ed is None else ed
                epoch = c.effective_epoch(i, epoch)
            answered = self._answered(job)
            if i in stopped:
                # Stopped mid-launch: its out word was lowered to stop it,
                # so only the kernel's count says what the row ran.
                scanned = min(int(rec.stops.scanned[i]), rec.span)
                applied_hashes += scanned
                if answered is not None:
                    wasted[answered] += scanned
                continue
            nonce = (int(hi) << 32) | int(lo)
            if nonce == _MASK64:  # span dry: base already advanced at dispatch
                span_i = rec.span
                if c is not None:
                    # A cancelled row exited early: count the windows the
                    # device actually ran, not the full span.
                    span_i = min(rec.span, c.windows_run(i, rec.steps) * self.chunk)
                applied_hashes += span_i
                if answered is not None:
                    wasted[answered] += span_i
                continue
            scanned = ((nonce - base) & _MASK64) + 1
            applied_hashes += scanned
            if answered is not None:
                wasted[answered] += scanned
                continue  # cancelled/solved while the launch was in flight
            work = search.work_hex_from_nonce(nonce)
            value = nc.work_value(job.block_hash, work)
            if value >= job.difficulty:
                self._record_solve(job, work)
            elif value >= launched:
                # Valid for the target this launch ran at, but the target
                # was raised mid-flight: search on past this nonce — unless
                # the job was re-aimed while the launch was on the wire.
                if epoch == job.epoch:
                    job.set_base(nonce + 1)
            else:
                self._invalid_work(job, work, value, launched)
        return applied_hashes, wasted

    def _apply_fan_rows(self, rec: _Launch, lo_arr, hi_arr) -> tuple:
        """Apply one fanned launch: winner election + device attribution.

        ``lo_arr``/``hi_arr`` are per-device absolute nonces [n_dev, B].
        Per row, the hit scanned in the fewest nonces from its device's
        launch base wins (deterministic, the mesh election's order); the
        win is attributed to that device: its scan counter and scan clock
        produce the EMA sample. Returns the nonces every member scanned, and
        of those the ones scanned for jobs already answered, by cause.
        """
        fan_map = rec.fan_map or list(range(len(self.fan)))
        n = len(fan_map)  # launch slices; fan_map[s] is the physical device
        span_dev = rec.span // n
        per_slice_scanned = [0] * n
        wasted = {"solved": 0, "cancelled": 0}
        c = rec.control
        for i, (job, launched, bases, epoch) in enumerate(zip(
            rec.jobs, rec.launched_difficulty, rec.dev_bases, rec.epochs
        )):
            # Mid-launch control is applied PER DEVICE: each member polls
            # (and exits) independently, so a command counts only on the
            # devices that actually observed it.
            launched_dev = [launched] * n
            epoch_dev = [epoch] * n
            dry_scan = [span_dev] * n
            if c is not None:
                bases = list(bases)
                for s in range(n):
                    eb = c.effective_base(i, s)
                    if eb is not None:
                        bases[s] = eb
                    ed = c.effective_difficulty(i, s)
                    if ed is not None:
                        launched_dev[s] = ed
                    epoch_dev[s] = c.effective_epoch(i, epoch, s)
                    dry_scan[s] = min(
                        span_dev, c.windows_run(i, rec.steps, s) * self.chunk_per_shard
                    )
            # Per-slice results for this row: (local offset, slice, nonce).
            cands = []
            row_scanned = list(dry_scan)
            for s in range(n):
                nonce = (int(hi_arr[s, i]) << 32) | int(lo_arr[s, i])
                if nonce == _MASK64:
                    continue  # this device's sub-span was dry
                local = (nonce - bases[s]) & _MASK64
                row_scanned[s] = local + 1
                cands.append((local, s, nonce))
            hit_slices = {s for _l, s, _n in cands}
            answered = self._answered(job)
            if answered is not None:
                wasted[answered] += sum(row_scanned)
            for s in range(n):
                d = fan_map[s]
                per_slice_scanned[s] += row_scanned[s]
                if job.dev_scanned is not None and epoch_dev[s] == job.epoch:
                    # Same-partition results only; a device that ADOPTED a
                    # rebase mid-launch and then ran dry scanned its pre-
                    # rebase windows in the OLD partition.
                    credit = row_scanned[s]
                    if c is not None and s not in hit_slices:
                        credit = max(0, credit - c.applied_at_k(i, s) * self.chunk_per_shard)
                    job.dev_scanned[d] += credit
            if answered is not None or not cands:
                continue
            cands.sort()  # fewest-nonces-scanned first, slice as tiebreak
            for local, s, nonce in cands:
                d = fan_map[s]
                work = search.work_hex_from_nonce(nonce)
                value = nc.work_value(job.block_hash, work)
                if value >= job.difficulty:
                    self._record_solve(job, work)
                    self._attribute_win(job, d, epoch_dev[s])
                    break
                elif value >= launched_dev[s]:
                    # Valid at the target device d ran at, raised past it
                    # meanwhile: ONLY that device resumes past it — unless
                    # the job was re-partitioned while this launch was on
                    # the wire.
                    if epoch_dev[s] == job.epoch:
                        if job.dev_bases is not None:
                            job.dev_bases[d] = (nonce + 1) & _MASK64
                        else:
                            job.set_base(nonce + 1)
                else:
                    self._invalid_work(job, work, value, launched_dev[s])
                    break
        self._fan_update_device_metrics(rec, per_slice_scanned)
        return sum(per_slice_scanned), wasted

    def _attribute_win(self, job: _Job, d: int, epoch: int) -> None:
        """Fold one win into device d's EMA on ITS scan clock."""
        if job.dev_scanned is None or job.dev_t0 is None or epoch != job.epoch:
            return
        self._m_dev_wins.inc(1, str(d))
        elapsed = self._clock.time() - job.dev_t0[d]
        hashes = job.dev_scanned[d]
        if elapsed <= 0.0 or hashes <= 0:
            return
        sample = hashes / elapsed
        if self.device_ema[d] <= 0.0:
            self.device_ema[d] = sample
        else:
            a = self.fan_ema_alpha
            self.device_ema[d] = a * sample + (1.0 - a) * self.device_ema[d]
        self._m_dev_ema.set(self.device_ema[d], str(d))
        self.last_win = {
            "device": d,
            "hashes": hashes,
            "elapsed": elapsed,
            "sample_hs": sample,
            "ema_hs": self.device_ema[d],
        }

    def _fan_update_device_metrics(self, rec: _Launch, per_slice_scanned: list) -> None:
        fan_map = rec.fan_map or list(range(len(self.fan)))
        timing = rec.timing
        # Device time (perf_counter) feeds the H/s rate, a hardware measure;
        # busy-vs-wall rides the injectable clock on both sides.
        dev_seconds = max(0.0, timing.get("t_done", 0.0) - timing.get("t_thread", 0.0))
        busy_clock = max(
            0.0, timing.get("t_done_clock", 0.0) - timing.get("t_thread_clock", 0.0)
        )
        wall = self._clock.time() - self._fan_wall_t0
        for d, scanned in zip(fan_map, per_slice_scanned):
            label = str(d)
            self._m_dev_launches.inc(1, label)
            self._m_dev_hashes.inc(scanned, label)
            if dev_seconds > 0.0:
                self._m_dev_rate.set(scanned / dev_seconds, label)
            self._dev_busy[d] += busy_clock
            if wall > 0.0:
                self._m_dev_busy.set(min(1.0, self._dev_busy[d] / wall), label)

    async def _engine_loop(self) -> None:
        inflight = self._inflight
        inflight.clear()
        try:
            await self._engine_loop_body(inflight)
        except Exception as e:
            # A dead engine must never strand waiters on unresolved futures.
            for job in self._jobs.values():
                if not job.future.done():
                    job.future.set_exception(WorkError(f"engine failed: {e!r}"))
            self._jobs.clear()
            raise
        finally:
            for r in inflight:
                if r.waiter is not None:
                    r.waiter.cancel()
                if r.control is not None:
                    # Never applied: cancel every row so the orphan thread
                    # exits at its next poll — a launch whose thread has not
                    # started yet at its first — and releases its slot.
                    for i in range(len(r.jobs)):
                        r.control.cancel(i)
                    r.fut.add_done_callback(_consume_abandoned)
                else:
                    r.fut.cancel()

    async def _engine_loop_body(self, inflight: deque) -> None:
        while not self._closed:
            if not inflight:
                self._gc_jobs()
                for j in self._jobs.values():
                    j.inflight_miss = 1.0  # nothing in flight by definition
                if not self._jobs:
                    self._wakeup.clear()
                    try:
                        await asyncio.wait_for(self._wakeup.wait(), timeout=5.0)
                    except asyncio.TimeoutError:
                        if not self._jobs:
                            return  # idle: generate() restarts the engine
                    continue
            # Clear BEFORE filling: a submit landing after the fill re-sets
            # the event and the wait below returns immediately.
            self._wakeup.clear()
            while len(inflight) < self.pipeline:
                # Width policy counts only launches still serving a live job.
                live = sum(
                    1 for r in inflight
                    if any(not (j.cancelled or j.future.done()) for j in r.jobs)
                )
                rec = self._dispatch_next(live)
                if rec is None:
                    break
                inflight.append(rec)
            if not inflight:
                if self._devices_exhausted or (self.fan is not None and not self._fan_active):
                    # Nothing can dispatch until a probe re-admits a device.
                    self._wakeup.clear()
                    await self._wakeup.wait()
                else:
                    await asyncio.sleep(0)  # cancelled stragglers gc'd next pass
                continue
            # Wait on the OLDEST launch's readback, interruptibly: a fresh
            # request is dispatched into a free pipeline slot right away.
            # Results still apply strictly in FIFO order.
            rec = inflight[0]
            if rec.waiter is None:
                rec.waiter = asyncio.ensure_future(self._await_launch(
                    rec.fut, f"batch={rec.batch}, steps={rec.steps}"
                ))
            wake = asyncio.ensure_future(self._wakeup.wait())
            try:
                await asyncio.wait({rec.waiter, wake}, return_when=asyncio.FIRST_COMPLETED)
            finally:
                wake.cancel()
            if rec.abandoned:
                # The watchdog ejected the head launch mid-wait: it is out
                # of the deque, and its results must never be applied.
                continue
            if not rec.waiter.done():
                continue  # new demand: refill free slots, then keep waiting
            lo_arr, hi_arr = rec.waiter.result()
            inflight.popleft()
            self._apply_results(rec, lo_arr, hi_arr)

    def _gc_jobs(self) -> None:
        for key in [k for k, j in self._jobs.items() if j.future.done()]:
            del self._jobs[key]
        # A drained engine must read 0, not the last batch's values: the
        # pack path only runs while there is demand to pack.
        self._m_jobs.set(len(self._jobs), "torch")
        if not self._jobs:
            self._m_rungs.set(0)
