"""In-process PyTorch/CUDA work engine: batched, cancellable nonce search.

Counterpart of the single-device path of ``tpu_dpow/backend/jax_backend.py``
in both of its run modes, built on the scanners in ops/:

  * Every request gets a decorrelating random 64-bit start base (or the
    start of its ``nonce_range``), then advances deterministically launch by
    launch.
  * All active requests are packed into one batched launch per engine step,
    padded to a power of two with difficulty-0 rows that hit at offset 0 and
    drain after one stride. Concurrent requests for one hash share one job.
  * Cancels are lane masking: a cancelled job is dropped from the next pack;
    a launch already in flight finishes and its result is discarded.
  * Run length adapts to difficulty: a launch covers up to ``run_steps``
    consecutive windows (the kernel's span is ``nblocks * steps`` windows),
    quantized on a x4 ladder. Jobs are grouped into difficulty rungs served
    round-robin, each launch as wide as its rung wants; launches queued
    behind another one are capped at ``shared_steps_cap`` windows.
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

On a CUDA device every launch goes through a hand-written kernel
(ops/cuda_kernel.py: the chunk search kernel, or the persistent run kernel);
with ``device="cpu"`` the same engine runs their plain PyTorch versions.
Every found nonce is re-validated on the host against hashlib before it is
returned.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import contextlib
import math
import secrets
import threading
from collections import deque
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from .. import obs
from ..models import WorkRequest
from ..ops import control as ctl
from ..ops import cuda_kernel, runloop, search
from ..resilience.clock import Clock, SystemClock
from ..utils import nanocrypto as nc
from . import WorkBackend, WorkCancelled, WorkError, await_shared_job

_MASK64 = (1 << 64) - 1

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


@dataclass
class _Job:
    block_hash: str
    difficulty: int  # current target; can only be raised by a later request
    params: np.ndarray  # cached uint32[12] row; base/diff words updated in place
    future: asyncio.Future
    base: int
    cancelled: bool = False
    waiters: int = 0  # refcount: last cancelled waiter drops the job
    # Bumped on every re-aim (cover_range): a launch dispatched against the
    # old region must not rewind the frontier back out of the new one.
    epoch: int = 0
    # P(no launch currently in flight solves this job); 1.0 = uncovered.
    inflight_miss: float = 1.0

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


@dataclass
class _Launch:
    """One in-flight device launch and the per-job state it was packed with."""

    fut: asyncio.Future  # executor future → (lo, hi) result arrays
    jobs: list  # the _Jobs occupying the first len(jobs) batch rows
    launched_difficulty: list  # per-job target snapshot at dispatch
    bases: list  # per-job scan base at dispatch (pre-speculation)
    epochs: list  # per-job re-aim epoch at dispatch
    span: int  # nonces scanned per row this launch
    miss_factors: list  # per-job P(this span misses), undone when applied
    steps: int = 1  # windows this launch may scan per row
    # Persistent mode: the launch's live control block and its slot id in
    # ops/control.py's table. None on chunked launches — they cannot be
    # steered mid-flight.
    control: "Optional[ctl.LaunchControl]" = None
    slot: int = 0


class TorchWorkBackend(WorkBackend):
    """Batched chunked nonce search on one GPU (or, if asked, the CPU)."""

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
        clock: Optional[Clock] = None,  # control poll / delivery stamps
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
        self.device = dev
        geometry = _GEOMETRY[dev.type]
        self.sublanes = sublanes or geometry[0]
        self.iters = iters or geometry[1]
        self.nblocks = nblocks or geometry[2]
        self.group = group or geometry[3]
        try:
            # Fail at construction with the kernel's own geometry checks.
            self.chunk = cuda_kernel.window(
                self.sublanes, self.iters, self.nblocks, self.group
            )
        except ValueError as e:
            raise WorkError(str(e)) from e
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
        # Launches that run behind another one (pipelined successors,
        # speculation, or any launch while another rung has demand) buy no
        # latency with width; capping them bounds how long fresh arrivals
        # and cancels wait behind someone else's scan.
        self.shared_steps_cap = max(1, self.run_steps // 4)
        self._executor: Optional[concurrent.futures.ThreadPoolExecutor] = None
        self._tls = threading.local()  # per launch thread: its CUDA stream
        # Persistent launches all share ONE stream: each is a cooperative
        # grid holding every SM with grid-wide barriers, and two of them on
        # two streams could each hold part of the card and wait forever. A
        # pipelined successor queues behind the running launch instead.
        self._persistent_stream: "Optional[torch.cuda.Stream]" = None
        self._lock = threading.Lock()  # guards the shared stream's creation
        self._jobs: Dict[str, _Job] = {}
        self._inflight: deque = deque()
        self._last_rung = -1  # round-robin cursor over difficulty rungs
        self._engine_task: Optional[asyncio.Task] = None
        self._wakeup = asyncio.Event()
        self._closed = False
        self.total_hashes = 0
        self.total_solutions = 0
        # Persistent-mode families, named as the JAX engine's: launch
        # length, control-channel traffic and poll-to-effect latency.
        reg = obs.get_registry()
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

    # -- WorkBackend interface -------------------------------------------

    async def setup(self) -> None:
        self._closed = False  # setup() after close() reopens the engine
        if self.device.type == "cuda":
            try:
                await asyncio.to_thread(cuda_kernel.load_libraries)
            except RuntimeError as e:
                raise WorkError(f"CUDA kernel build failed: {e}") from e
        # Self-test: the engine must find a planted easy solution.
        probe = search.pack_params(bytes(32), 1, base=0)
        lo, hi = await self._submit_launch(np.stack([probe]), 1)
        if int(lo[0]) != 0 or int(hi[0]) != 0:
            raise WorkError(
                f"backend self-test failed (nonce {int(hi[0]):08x}{int(lo[0]):08x})"
            )

    async def generate(self, request: WorkRequest) -> str:
        if self._closed:
            raise WorkError("backend closed")
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
        )
        # An assigned nonce range pins the scan base to its start (a soft
        # hint: the scan runs on past its end). Without one, a random base
        # decorrelates this engine from every other searcher.
        if request.nonce_range is not None:
            start = request.nonce_range[0]
        else:
            start = secrets.randbits(64)
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
        through the control channel at their next poll."""
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

    def _control_cancel_job(self, job: _Job) -> None:
        """Free the job's device rows: deliver CANCEL to every in-flight
        persistent launch still scanning it (no epoch check: stopping a row
        is valid whatever it was aimed at)."""
        for rec, row in self._live_controls(job):
            rec.control.cancel(row)

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
        base (cover_range already moved the job and bumped its epoch); the
        job's rows in OLDER launches are stale under the new epoch, so they
        are KILLED — stopped at their next poll, their control word dead to
        any later write. Returns (covered, span) of the rebased launch."""
        covered, span = False, 0
        for rec, row in reversed(self._live_controls(job)):
            if not covered and rec.control.rebase(row, [job.base], epoch=job.epoch):
                covered, span = True, rec.span
                continue
            rec.control.kill(row)
        return covered, span

    async def cover_range(self, block_hash: str, nonce_range: tuple) -> bool:
        """Jump a running job's scan to ``nonce_range``'s start.

        The next pack dispatches from the new base; chunked launches already
        in flight finish their old span and apply normally (a hit there is
        still a valid nonce). A running persistent launch is re-aimed
        mid-flight instead. Coverage accounting resets.
        """
        job = self._jobs.get(nc.validate_block_hash(block_hash))
        if job is None or job.cancelled or job.future.done():
            return False
        self._re_cover(job, nonce_range[0])
        return True

    def _re_cover(self, job: _Job, start: int) -> None:
        """Re-aim a running job at ``start``, epoch-fenced: a launch already
        on the wire was aimed at the OLD region, and its weak hit (raised-
        target race) must not rewind the frontier out of the new one."""
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
        self._wakeup.set()

    async def close(self) -> None:
        self._closed = True
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
        # Detach-then-await: a concurrent close() finds the slot empty.
        engine_task, self._engine_task = self._engine_task, None
        if engine_task is not None:
            try:
                await engine_task
            except Exception:
                # The engine already failed its waiters before dying.
                pass
        self._inflight.clear()
        executor, self._executor = self._executor, None
        if executor is not None:
            # A launch still on the device finishes off the event loop.
            await asyncio.to_thread(executor.shutdown, wait=True)

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
        powers of four up to run_steps. Persistent mode has one steerable
        span-sized rung (plus the singleton the self-test uses): the loop's
        early exit makes run-length quantization pointless."""
        if self.run_mode == "persistent":
            return [1, self.persistent_steps] if self.persistent_steps > 1 else [1]
        counts, steps = [1], 1
        while steps < self.run_steps:
            steps = min(steps * 4, self.run_steps)
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

    def _stream(self) -> "torch.cuda.Stream":
        """This launch thread's own CUDA stream: a pipelined launch's
        readback does not wait behind its successor's scan. Persistent
        launches all take the engine's one shared stream (see __init__)."""
        if self.run_mode == "persistent":
            with self._lock:
                if self._persistent_stream is None:
                    self._persistent_stream = torch.cuda.Stream(device=self.device)
                return self._persistent_stream
        stream = getattr(self._tls, "stream", None)
        if stream is None:
            stream = self._tls.stream = torch.cuda.Stream(device=self.device)
        return stream

    def _launch(self, params_batch: np.ndarray, steps: int, slot: int = 0) -> tuple:
        """One blocking batched launch (called on a worker thread).

        Returns (lo, hi) uint32[B] — absolute winning nonces per row,
        all-ones where the span held no solution. ``steps`` widens the span
        to ``steps`` consecutive windows in the same launch. In persistent
        mode the span runs as one steerable launch polling control slot
        ``slot`` (0: no control block, the polls read dead zeros).
        """
        if self.run_mode == "persistent":
            return self._launch_persistent(params_batch, steps, slot)
        kwargs = dict(
            sublanes=self.sublanes, iters=self.iters,
            nblocks=self.nblocks * steps, group=self.group,
        )
        if self.device.type == "cuda":
            with torch.cuda.stream(self._stream()):
                params = search.params_from_numpy(params_batch, self.device)
                out = cuda_kernel.cuda_search_chunk_batch(params, **kwargs)
                offs = search.offsets_to_numpy(out)
        else:
            params = search.params_from_numpy(params_batch, self.device)
            offs = search.offsets_to_numpy(
                cuda_kernel.cuda_search_chunk_batch(params, **kwargs)
            )
        return self._offsets_to_nonces(params_batch, offs)

    def _launch_persistent(self, params_batch: np.ndarray, steps: int, slot: int) -> tuple:
        """One blocking PERSISTENT launch: ``steps`` windows of
        ``self.chunk`` nonces per row, polling control slot ``slot`` every
        ``control_poll_steps`` windows, returning on win, cancel or span
        end. Same (lo, hi) contract as the chunked launch."""
        kwargs = dict(
            max_steps=steps, poll_steps=self.control_poll_steps,
            sublanes=self.sublanes, iters=self.iters, nblocks=self.nblocks,
            group=self.group,
        )
        # Nothing here may wait on the shared stream: a successor kernel
        # queued on it needs its own thread to serve its polls
        # (ops/cuda_kernel.py). The rows go up without a host wait and the
        # results come back on the host.
        on_card = self.device.type == "cuda"
        with torch.cuda.stream(self._stream()) if on_card else contextlib.nullcontext():
            params = search.params_from_numpy(params_batch, self.device, non_blocking=True)
            lo, hi = runloop.search_run_batch_controlled(params, None, slot, **kwargs)
            return search.offsets_to_numpy(lo), search.offsets_to_numpy(hi)

    def _submit_launch(
        self, params_batch: np.ndarray, steps: int, slot: int = 0
    ) -> asyncio.Future:
        """Hand a launch to the executor; device work starts immediately.
        ``slot`` routes a persistent launch's control polls (0: none)."""
        if self._executor is None:
            self._executor = concurrent.futures.ThreadPoolExecutor(
                max_workers=self.pipeline
            )

        def call_launch():
            try:
                return self._launch(params_batch, steps, slot)
            finally:
                # The control slot lives exactly as long as the launch:
                # releasing it earlier would feed a still-running kernel
                # dead zeros and undo its cancel flags. release() is
                # idempotent; the apply path's release stays as a backstop.
                if slot:
                    ctl.release(slot)

        cf = self._executor.submit(call_launch)
        if slot:
            # A launch cancelled before its thread took it up never runs
            # call_launch, so its finally cannot release the slot.
            def release_unstarted(f: concurrent.futures.Future) -> None:
                if f.cancelled():
                    ctl.release(slot)

            cf.add_done_callback(release_unstarted)
        return asyncio.wrap_future(cf)

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

    # -- engine -----------------------------------------------------------

    def _ensure_engine(self) -> None:
        if self._engine_task is None or self._engine_task.done():
            self._engine_task = asyncio.ensure_future(self._engine_loop())

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
        span = self.chunk * steps
        factors = [self._miss_factor(j.difficulty, span) for j in active]
        slot, launch_control = 0, None
        if self.run_mode == "persistent":
            # One control block per launch, slot-registered so the launch
            # thread can route the kernel's polls; the thread releases the
            # slot once the launch has returned.
            launch_control = ctl.LaunchControl(b, clock=self._clock)
            slot = ctl.register(launch_control)
        rec = _Launch(
            fut=self._submit_launch(self._pack(active, b), steps, slot),
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
            control=launch_control,
            slot=slot,
        )
        for job, f in zip(active, factors):
            job.set_base(job.base + span)
            job.inflight_miss *= f
        return rec

    def _apply_results(self, rec: _Launch, lo_arr, hi_arr) -> None:
        c = rec.control
        if c is not None:
            # The launch is off the device: retire its slot (idempotent; the
            # launch thread released it already) and export what the channel
            # saw — launch length, polls, commands delivered and their
            # issue->delivery latency on the injectable clock.
            ctl.release(rec.slot)
            self._m_p_polls.inc(c.polls)
            self._m_p_windows.observe(min(c.last_k + self.control_poll_steps, rec.steps))
            for _row, action, latency, _token in c.delivered:
                self._m_p_control.inc(1, action)
                self._m_p_effect.observe(latency)
        for job, f in zip(rec.jobs, rec.miss_factors):
            # This launch is no longer in flight: undo its coverage factor
            # (clamped — repeated multiply/divide may drift past 1.0).
            job.inflight_miss = min(1.0, job.inflight_miss / f)
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
            nonce = (int(hi) << 32) | int(lo)
            if nonce == _MASK64:  # span dry: base already advanced at dispatch
                span_i = rec.span
                if c is not None:
                    # A cancelled row exited early: count the windows the
                    # device actually ran, not the full span.
                    span_i = min(rec.span, c.windows_run(i, rec.steps) * self.chunk)
                self.total_hashes += span_i
                continue
            self.total_hashes += ((nonce - base) & _MASK64) + 1
            if job.future.done():
                continue  # cancelled/solved while the launch was in flight
            work = search.work_hex_from_nonce(nonce)
            value = nc.work_value(job.block_hash, work)
            if value >= job.difficulty:
                self.total_solutions += 1
                # Persistent successors still scanning the solved job exit
                # within one poll interval instead of grinding on.
                self._control_cancel_job(job)
                job.future.set_result(work)
            elif value >= launched:
                # Valid for the target this launch ran at, but the target
                # was raised mid-flight: search on past this nonce — unless
                # the job was re-aimed while the launch was on the wire.
                if epoch == job.epoch:
                    job.set_base(nonce + 1)
            else:  # device/host disagreement: a real bug, surface it
                job.future.set_exception(
                    WorkError(
                        f"device produced invalid work {work} for "
                        f"{job.block_hash} (value {value:016x} < {launched:016x})"
                    )
                )

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
                await asyncio.sleep(0)  # cancelled stragglers gc'd next pass
                continue
            # Wait on the OLDEST launch's readback, interruptibly: a fresh
            # request is dispatched into a free pipeline slot right away.
            # Results still apply strictly in FIFO order.
            rec = inflight[0]
            wake = asyncio.ensure_future(self._wakeup.wait())
            try:
                await asyncio.wait({rec.fut, wake}, return_when=asyncio.FIRST_COMPLETED)
            finally:
                wake.cancel()
            if not rec.fut.done():
                continue  # new demand: refill free slots, then keep waiting
            lo_arr, hi_arr = rec.fut.result()
            inflight.popleft()
            self._apply_results(rec, lo_arr, hi_arr)

    def _gc_jobs(self) -> None:
        for key in [k for k, j in self._jobs.items() if j.future.done()]:
            del self._jobs[key]
