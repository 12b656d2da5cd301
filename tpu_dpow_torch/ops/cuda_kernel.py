"""The hand-written CUDA kernels of the port: build, load, call.

Counterpart of ``tpu_dpow/ops/pallas_kernel.py`` and of the device loop of
``tpu_dpow/ops/runloop.py``. Two kernels, each in its own library:

  * ``cuda_search_chunk`` and ``cuda_search_chunk_batch`` take the
    signatures, geometry checks and ``< 2^31`` window limit of
    ``pallas_search_chunk`` and ``pallas_search_chunk_batch``. The three
    Pallas kernels (single, batched, multi-window grid) are one CUDA kernel
    here (``csrc/blake2b_search.cu``); ``sublanes``, ``iters`` and
    ``nblocks`` only define the span one launch scans per row, and
    ``group`` (the TPU's early-exit cadence) is checked and otherwise
    unused: the kernel exits early per warp. A ``RowStopper`` stops a
    running row from another thread, and ``scanned`` counts the nonces
    each row really tested.
  * ``cuda_search_run_batch`` and ``cuda_search_run_batch_controlled`` run
    ``run_loop_core``'s multi-window loop as one persistent cooperative
    launch (``csrc/blake2b_run.cu``), with windows of ``window`` nonces
    whose bases advance by ``stride`` (the device fan's interleaved
    windows; ``stride == window`` is the contiguous scan). The controlled
    launch polls its control block through a mailbox in mapped pinned host
    memory: the calling thread serves each poll through
    ``control.poll_slot`` (as fan member ``dev``) until the kernel has
    returned, exactly the polls ``io_callback`` would make, and hands the
    slot the windows the kernel ran with its grid dealt over every row or
    re-granted to fewer (``take_out_stats``).

Each kernel is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface at first use (one ``nvcc`` per source, started
together), and loaded with ``ctypes``. A library's name carries a hash of its
sources and the compile command, so an edit rebuilds it and concurrent
builds never load a half-written file. ``dpow_engine_kernel_builds_total
{library}`` counts the builds this process ran (0 where it loaded the
libraries from the build directory).

A CUDA tensor goes to the kernel or raises. A CPU tensor goes to the plain
PyTorch version (``ops/search.py``, ``ops/runloop.py``); nothing else does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

from .. import obs
from . import control, search

DEFAULT_SUBLANES = 32
DEFAULT_ITERS = 256

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_HERE, "csrc")
# Where the libraries are built (listed in .gitignore).
BUILD_DIR = os.path.join(_HERE, "_build")
# Library name -> (file stem, sources; the first is the one compiled).
LIBRARIES = {
    "search": ("libb2search", ("blake2b_search.cu", "blake2b_search.cuh")),
    "run": ("libb2run", ("blake2b_run.cu", "blake2b_search.cuh")),
}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# Interface version of each library (``b2_abi_version``): the run kernel's
# launch took a stride in version 3 and deals its grid over the live rows,
# counting its windows in its out words, in version 4; the search kernel's
# took a ``scanned`` array in version 3.
_ABI_VERSIONS = {"search": 3, "run": 4}

# Kernel launches made through the wrappers below (the only place they move):
# ``launches`` for the search kernel, ``run_launches`` for the persistent one,
# and of those ``run_strided_launches`` for its strided mode (stride > window).
launches = 0
run_launches = 0
run_strided_launches = 0
# Control polls the persistent kernel made, and their round trip as the
# kernel's leader measured it (post of the request to sight of the answer),
# and the host time launch threads slept while their kernel queued behind
# another on the shared stream.
run_poll_stats = {"polls": 0, "round_trip_ns": 0, "round_trip_ns_max": 0,
                  "queued_ns": 0, "queued_ns_max": 0}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_lib_paths: Dict[str, str] = {}


def nvcc_path() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels cannot be built")


def _target(name: str) -> str:
    """Path of library ``name`` for the sources as they are now."""
    stem, sources = LIBRARIES[name]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        with open(os.path.join(_CSRC, src), "rb") as f:
            h.update(src.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"{stem}-{h.hexdigest()[:16]}.so")


def _builds_counter():
    return obs.get_registry().counter(
        "dpow_engine_kernel_builds_total",
        "Kernel libraries this process compiled with nvcc (0: loaded as "
        "built)", ("library",))


def build_libraries(names=tuple(LIBRARIES)) -> Dict[str, str]:
    """Compile every library in ``names`` that is not built yet, one
    ``nvcc`` per source, all started together; return name -> path.
    ``<lib>.log`` keeps nvcc's output (``-Xptxas -v``: registers, spills)."""
    outs = {name: _target(name) for name in names}
    todo = {name: out for name, out in outs.items() if not os.path.exists(out)}
    if not todo:
        return outs
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    try:
        for name, out in todo.items():
            tmp = os.path.join(BUILD_DIR, f".{os.path.basename(out)}.{os.getpid()}.tmp")
            src = os.path.join(_CSRC, LIBRARIES[name][1][0])
            procs[name] = (tmp, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", tmp, src],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            ))
        failed = []
        for name, (tmp, proc) in procs.items():
            stdout, stderr = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{LIBRARIES[name][1][0]}: nvcc failed ({proc.returncode}):\n{stderr}")
                continue
            with open(todo[name] + ".log", "w") as f:
                f.write(stdout + stderr)
            os.replace(tmp, todo[name])
            _builds_counter().inc(1, name)
        if failed:
            raise RuntimeError("\n".join(failed))
    finally:
        for tmp, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    return outs


def _bind_search(lib: ctypes.CDLL) -> None:
    lib.b2_blocks_per_row.argtypes = [ctypes.c_int, ctypes.c_uint]
    lib.b2_blocks_per_row.restype = ctypes.c_int
    lib.b2_search_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
        ctypes.c_void_p,
    ]
    lib.b2_search_launch.restype = ctypes.c_int


def _bind_run(lib: ctypes.CDLL) -> None:
    lib.b2_run_state_words.argtypes = [ctypes.c_int]
    lib.b2_run_state_words.restype = ctypes.c_int
    lib.b2_run_out_words.argtypes = [ctypes.c_int]
    lib.b2_run_out_words.restype = ctypes.c_int
    lib.b2_run_blocks_per_row.argtypes = [ctypes.c_int]
    lib.b2_run_blocks_per_row.restype = ctypes.c_int
    lib.b2_run_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_uint, ctypes.c_uint, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.b2_run_launch.restype = ctypes.c_int
    lib.b2_mailbox_alloc.argtypes = [
        ctypes.c_int, ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
    ]
    lib.b2_mailbox_alloc.restype = ctypes.c_int
    lib.b2_mailbox_reset.argtypes = [ctypes.c_void_p]
    lib.b2_mailbox_reset.restype = None
    lib.b2_mailbox_take.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint), ctypes.c_void_p,
    ]
    lib.b2_mailbox_take.restype = ctypes.c_uint
    lib.b2_mailbox_answer.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
    ]
    lib.b2_mailbox_answer.restype = None


_BINDERS = {"search": _bind_search, "run": _bind_run}


def load_libraries() -> Dict[str, ctypes.CDLL]:
    """Build (at first use, in parallel) and load every kernel library once
    per process."""
    with _lock:
        missing = [name for name in LIBRARIES if name not in _libs]
        if missing:
            for name in missing:
                _builds_counter().inc(0, name)  # the series reads 0, not absent
            paths = build_libraries(tuple(missing))
            for name in missing:
                lib = ctypes.CDLL(paths[name])
                lib.b2_abi_version.restype = ctypes.c_int
                if lib.b2_abi_version() != _ABI_VERSIONS[name]:
                    raise RuntimeError(
                        f"{paths[name]}: ABI {lib.b2_abi_version()} != {_ABI_VERSIONS[name]}"
                    )
                lib.b2_error_string.argtypes = [ctypes.c_int]
                lib.b2_error_string.restype = ctypes.c_char_p
                _BINDERS[name](lib)
                if name == "run" and lib.b2_run_out_words(1) != 2 + _OUT_STATS:
                    raise RuntimeError(f"{paths[name]}: out layout differs from the wrapper's")
                _libs[name], _lib_paths[name] = lib, paths[name]
        return dict(_libs)


def load_library() -> ctypes.CDLL:
    """The search kernel's library (every library is built and loaded)."""
    return load_libraries()["search"]


def load_run_library() -> ctypes.CDLL:
    """The persistent kernel's library (every library is built and loaded)."""
    return load_libraries()["run"]


def build_log(name: str = "search") -> str:
    """nvcc's output for a loaded library ('' before the first load)."""
    path = _lib_paths.get(name)
    if path is None or not os.path.exists(path + ".log"):
        return ""
    with open(path + ".log") as f:
        return f.read()


def library_path(name: str = "search") -> Optional[str]:
    return _lib_paths.get(name)


def reset_launches() -> None:
    """Zero both kernels' launch counts and the poll statistics."""
    global launches, run_launches, run_strided_launches
    with _lock:
        launches = run_launches = run_strided_launches = 0
        run_poll_stats.update(polls=0, round_trip_ns=0, round_trip_ns_max=0, queued_ns=0,
                              queued_ns_max=0)


def window(sublanes: int, iters: int, nblocks: int = 1, group: int = 1) -> int:
    """Offsets one launch scans per row, after the Pallas kernels' checks."""
    if min(sublanes, iters, nblocks, group) < 1:
        raise ValueError("sublanes, iters, nblocks and group must be >= 1")
    if iters % group != 0:
        raise ValueError("iters must be a multiple of group")
    if sublanes * 128 * iters >= 1 << 31:
        raise ValueError("launch window must stay below 2^31 nonces")
    span = nblocks * sublanes * 128 * iters
    if span >= 1 << 31:
        raise ValueError("total launch window must stay below 2^31 nonces")
    return span


def cuda_search_chunk_batch(
    params_batch: torch.Tensor,
    *,
    sublanes: int = DEFAULT_SUBLANES,
    iters: int = DEFAULT_ITERS,
    nblocks: int = 1,
    group: int = 1,
    out: Optional[torch.Tensor] = None,
    scanned: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Batched launch: int32[B, 12] bit view of the uint32 rows → int32[B]
    bit view of the lowest valid offset per row, or SENTINEL.

    The span per row is ``nblocks * sublanes * 128 * iters`` nonces, as in
    ``pallas_search_chunk_batch``. On a CPU tensor this is the plain version.

    On the card only: ``out`` (int32[B] on the params' card, filled with
    SENTINEL by the caller) takes the offsets in place of a new tensor, so
    that a :class:`RowStopper` can lower a row's word while the kernel runs;
    ``scanned`` (int32[B] there, zeroed by the caller) gets the nonces each
    row really tested added to it.
    """
    global launches
    span = window(sublanes, iters, nblocks, group)
    if params_batch.device.type == "cpu":
        if out is not None or scanned is not None:
            raise ValueError("out and scanned are the card's: the plain version takes neither")
        return search.search_chunk_batch(params_batch, chunk_size=span)
    if params_batch.device.type != "cuda":
        raise ValueError(f"params must be on cuda or cpu, not {params_batch.device}")
    if params_batch.dtype != torch.int32:
        raise TypeError(f"params must be the int32 bit view, got {params_batch.dtype}")
    if params_batch.dim() != 2 or params_batch.shape[1] != search.PARAMS_LEN:
        raise ValueError(
            f"params must be [B, {search.PARAMS_LEN}], got {tuple(params_batch.shape)}"
        )
    if not params_batch.is_contiguous():
        raise ValueError("params must be contiguous")
    rows = params_batch.shape[0]
    for name, t in (("out", out), ("scanned", scanned)):
        if t is not None and (t.device != params_batch.device or t.dtype != torch.int32
                              or t.shape != (rows,) or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous int32[{rows}] on {params_batch.device}")
    if out is None:
        out = torch.full((rows,), -1, dtype=torch.int32, device=params_batch.device)
    if rows == 0:
        return out
    lib = load_library()
    with torch.cuda.device(params_batch.device):
        stream = torch.cuda.current_stream(params_batch.device).cuda_stream
        err = lib.b2_search_launch(
            params_batch.data_ptr(), out.data_ptr(),
            None if scanned is None else scanned.data_ptr(), rows, span, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"blake2b search launch failed: {lib.b2_error_string(err).decode()} ({err})"
        )
    with _lock:
        launches += 1
    return out


def cuda_search_chunk(
    params: torch.Tensor,
    *,
    sublanes: int = DEFAULT_SUBLANES,
    iters: int = DEFAULT_ITERS,
    group: int = 1,
) -> torch.Tensor:
    """One row: int32[12] → int32 scalar bit view, as ``pallas_search_chunk``."""
    return cuda_search_chunk_batch(
        params.reshape(1, search.PARAMS_LEN).contiguous(),
        sublanes=sublanes, iters=iters, group=group,
    )[0]


# Per card: the stream row stops are written on, and the pinned zero they
# copy from. Allocating pinned memory keeps the card from running work
# issued before it beside work issued after it, so the first RowStopper
# makes them before its own launch (an engine's self-test), not at a stop.
_stop_streams: Dict[int, tuple] = {}
# Longest nap between looks while a thread waits for a readback or for its
# stops to land: a readback's result waits at most this long past its copy.
READBACK_NAP_MAX_S = 2e-4
# Per thread: pinned words a readback lands in (grown on demand).
_tls = threading.local()


def _stop_stream(device: torch.device) -> tuple:
    with _lock:
        got = _stop_streams.get(device.index)
        if got is None:
            got = _stop_streams[device.index] = (
                torch.cuda.Stream(device=device),
                torch.zeros(1, dtype=torch.int32).pin_memory(),
            )
        return got


def read_back(words: torch.Tensor) -> np.ndarray:
    """int32 ``words`` on the card → their uint32 values on the host, once
    the work queued before them on the current stream is done. The copy
    lands in pinned memory and this thread sleeps on an event: a blocking
    copy would wait inside the driver, where another thread's CUDA calls
    (a RowStopper's stop) queue behind it until the kernel ends."""
    n = words.numel()
    pinned = getattr(_tls, "pinned", None)
    if pinned is None or pinned.numel() < n:
        pinned = _tls.pinned = torch.empty(max(n, 64), dtype=torch.int32, pin_memory=True)
    host = pinned[:n]
    host.copy_(words, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(words.device))
    _sleep_until(done, READBACK_NAP_MAX_S)
    return host.numpy().view(np.uint32).copy()


class RowStopper:
    """Stops rows of one running search launch from another thread:
    :meth:`stop` writes 0 into the row's word of ``out`` (the launch's
    ``out`` tensor, made in the current stream and filled with SENTINEL
    there), and each warp of the row exits at its next stride.

    The write is a 4-byte copy from pinned memory on the card's own stop
    stream, which needs no SM while the card is full, ordered after the
    fill (an event recorded at construction, on the current stream). The
    launch's owner must call :meth:`drain` before it lets ``out`` go: a
    write landing in reused memory would plant a hit at offset 0 in some
    other row."""

    def __init__(self, out: torch.Tensor):
        self.out = out
        self.stream, self.zero = _stop_stream(out.device)
        self.filled = torch.cuda.Event()
        self.filled.record(torch.cuda.current_stream(out.device))
        self.written: Optional[torch.cuda.Event] = None

    def stop(self, row: int) -> None:
        with torch.cuda.device(self.out.device), torch.cuda.stream(self.stream):
            if self.written is None:
                self.stream.wait_event(self.filled)
                self.written = torch.cuda.Event()
            self.out[row:row + 1].copy_(self.zero, non_blocking=True)
            self.written.record(self.stream)

    def drain(self) -> None:
        """Wait until every stop written so far has landed."""
        if self.written is not None:
            _sleep_until(self.written, READBACK_NAP_MAX_S)



# -- the persistent run kernel -------------------------------------------------
#
# Persistent launches share one CUDA stream (backend/torch_backend.py), so a
# pipelined successor's kernel is queued behind the running one and needs its
# own launch thread to serve its polls once it starts. A launch thread must
# therefore never wait on that stream after its kernel is enqueued: a
# device-to-host copy of its results would queue behind the successor and,
# inside the CUDA driver, hold up the successor's thread (a deadlock seen on the
# card). A controlled launch writes its results and poll statistics into the
# mailbox, which the thread reads once the launch's event has completed.

# Mailbox words: req_seq, resp_seq, k, spare, done[rows], ctrl[rows, 6], then
# the launch's out words: lo[rows], hi[rows], polls, poll_ns (lo, hi),
# poll_ns_max (lo, hi), windows run, and of those the windows whose span the
# kernel dealt over fewer rows than the launch holds (csrc/blake2b_run.cu).
_MB_HEAD = 4
_OUT_STATS = 7
# Longest the poll-serving loop spins in C (without the GIL) for a request
# before it looks whether the kernel has returned.
POLL_SPIN_US = 200
# Longest sleep between looks while a launch waits behind its predecessor on
# the shared stream (up to a whole launch): the waiting thread sleeps with
# the GIL released instead of spinning, and the delay it adds to the
# launch's first poll stays under this bound.
QUEUED_SLEEP_MAX_S = 1e-3
# Mailboxes pooled on each of a persistent engine's cards when it sets up
# (prepare_mailboxes), of this many rows each: enough for the engine's
# launches (max_batch 16, pipeline 2, a probe) without a pinned allocation
# while a kernel runs.
_MAILBOX_ROWS, _MAILBOXES_PER_CARD = 16, 3


def _mailbox_words(rows: int) -> int:
    return _MB_HEAD + (1 + control.CTRL_WORDS) * rows + 2 * rows + _OUT_STATS


class _Mailbox:
    """One mapped pinned mailbox, for launches of up to ``rows`` rows on
    CUDA device ``device`` (its device pointer is that device's)."""

    def __init__(self, lib: ctypes.CDLL, rows: int, device: int):
        self.rows, self.device = rows, device
        host, dev = ctypes.c_void_p(), ctypes.c_void_p()
        words = _mailbox_words(rows)
        with torch.cuda.device(device):
            err = lib.b2_mailbox_alloc(words, ctypes.byref(host), ctypes.byref(dev))
        if err != 0:
            raise RuntimeError(
                f"mailbox allocation failed: {lib.b2_error_string(err).decode()} ({err})"
            )
        self.host, self.dev = host.value, dev.value
        self.words = np.ctypeslib.as_array((ctypes.c_uint32 * words).from_address(self.host))

    def out_offset(self, rows: int) -> int:
        """Word offset of a ``rows``-row launch's out words."""
        return _MB_HEAD + (1 + control.CTRL_WORDS) * rows


# Free mailboxes by (device, capacity): a mailbox's device pointer is handed
# only to kernels of the device it was made on. Freeing pinned memory
# synchronizes the device, which would stall a launch thread behind its
# successor's kernel, so mailboxes are kept for reuse instead.
_mailboxes: Dict[tuple, list] = {}


def prepare_mailboxes(devices) -> None:
    """Fill the free pool of each CUDA device in ``devices`` (torch.device
    or index) up to _MAILBOXES_PER_CARD mailboxes. Only these cards are
    touched: no other card gets a CUDA context. A launch on a card with an
    empty pool allocates its mailbox itself (_take_mailbox)."""
    lib = load_run_library()
    for d in devices:
        index = d if isinstance(d, int) else d.index
        if index is None:
            index = torch.cuda.current_device()
        with _lock:
            missing = _MAILBOXES_PER_CARD - len(_mailboxes.get((index, _MAILBOX_ROWS), ()))
        for _ in range(missing):
            _give_mailbox(_Mailbox(lib, _MAILBOX_ROWS, index))


def _take_mailbox(lib: ctypes.CDLL, rows: int, device: int) -> _Mailbox:
    cap = max(_MAILBOX_ROWS, 1 << max(0, rows - 1).bit_length())
    with _lock:
        free = _mailboxes.get((device, cap))
        if free:
            return free.pop()
    return _Mailbox(lib, cap, device)


def _give_mailbox(box: _Mailbox) -> None:
    with _lock:
        _mailboxes.setdefault((box.device, box.rows), []).append(box)


def _check_params(params_batch: torch.Tensor) -> None:
    if params_batch.device.type != "cuda":
        raise ValueError(f"params must be on cuda or cpu, not {params_batch.device}")
    if params_batch.dtype != torch.int32:
        raise TypeError(f"params must be the int32 bit view, got {params_batch.dtype}")
    if params_batch.dim() != 2 or params_batch.shape[1] != search.PARAMS_LEN:
        raise ValueError(
            f"params must be [B, {search.PARAMS_LEN}], got {tuple(params_batch.shape)}"
        )
    if not params_batch.is_contiguous():
        raise ValueError("params must be contiguous")


def _stride_for(window: int, stride: Optional[int]) -> int:
    """The per-step base advance (None = ``window``: contiguous windows),
    checked as the kernel checks it: window <= stride < 2^31."""
    if not 0 < window < 1 << 31:
        raise ValueError("per-step window must be in (0, 2^31) nonces")
    stride = window if stride is None else int(stride)
    if not window <= stride < 1 << 31:
        raise ValueError(f"stride {stride} must be in [window {window}, 2^31)")
    return stride


def _run_launch(params_batch, active, *, window, stride, max_steps, poll_steps, out_ptr,
                mbox_dev):
    """Enqueue one persistent launch on the current stream; returns the
    stream. The kernel writes its out words at ``out_ptr``."""
    global run_launches, run_strided_launches
    if max_steps < 0:
        raise ValueError("max_steps must be >= 0")
    rows = params_batch.shape[0]
    dev = params_batch.device
    lib = load_run_library()
    act = None
    if active is not None:
        act = active.to(device=dev, dtype=torch.uint8).contiguous()
        if act.shape != (rows,):
            raise ValueError(f"active must be [{rows}], got {tuple(act.shape)}")
    with torch.cuda.device(dev):
        state = torch.empty(lib.b2_run_state_words(rows), dtype=torch.int64, device=dev)
        stream = torch.cuda.current_stream(dev)
        err = lib.b2_run_launch(
            params_batch.data_ptr(), None if act is None else act.data_ptr(),
            state.data_ptr(), out_ptr, rows, window, stride, max_steps, poll_steps, mbox_dev,
            stream.cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"blake2b run launch failed: {lib.b2_error_string(err).decode()} ({err})"
        )
    with _lock:
        run_launches += 1
        run_strided_launches += stride != window
    return stream


def cuda_search_run_batch(
    params_batch: torch.Tensor,
    active: Optional[torch.Tensor],
    *,
    window: int,
    max_steps: int,
    stride: Optional[int] = None,
) -> tuple:
    """``run_loop_core`` without control as one persistent launch: up to
    ``max_steps`` windows of ``window`` nonces per row, each window's base
    ``stride`` past the last (None: ``window``, one contiguous scan) →
    (lo, hi) int32[B] bit views (on the card) of each row's absolute
    winning nonce, all-ones where the span was dry or the row inactive.
    Returns without waiting for the kernel. On a CPU tensor this is the
    plain version (``ops/runloop.py``)."""
    stride = _stride_for(window, stride)
    if params_batch.device.type == "cpu":
        from . import runloop

        return runloop.run_loop_core(
            params_batch, active, launch=runloop.plain_launch(window),
            window=stride, max_steps=max_steps,
        )
    _check_params(params_batch)
    rows = params_batch.shape[0]
    out = torch.empty(2 * rows + _OUT_STATS, dtype=torch.int32, device=params_batch.device)
    if rows:
        _run_launch(
            params_batch, active, window=window, stride=stride, max_steps=max_steps,
            poll_steps=0, out_ptr=out.data_ptr(), mbox_dev=None,
        )
    return out[:rows], out[rows:2 * rows]


class _PollServer:
    """Answers one launch's polls as fan member ``dev`` of control slot
    ``slot`` (``control.poll_slot`` maps the member to its physical device
    through the LaunchControl's fan map). Built before the launch, so the
    first poll (k = 0, posted as soon as the kernel starts) does not wait
    for it."""

    def __init__(self, lib: ctypes.CDLL, box: _Mailbox, rows: int, slot: int, dev: int = 0):
        self.lib, self.box, self.rows, self.slot, self.dev = lib, box, rows, slot, dev
        self.k = ctypes.c_uint()
        self.done = np.zeros(rows, dtype=np.uint8)
        self.cancel_all = np.zeros((rows, control.CTRL_WORDS), dtype=np.uint32)
        self.cancel_all[:, control.IDX_FLAGS] = control.FLAG_CANCEL

    def _words(self) -> np.ndarray:
        words = np.ascontiguousarray(
            control.poll_slot(self.slot, self.dev, self.k.value, self.done.astype(bool)),
            dtype=np.uint32,
        )
        if words.shape != self.cancel_all.shape:
            raise ValueError(f"control poll returned {words.shape}, not {self.cancel_all.shape}")
        return words

    def serve(self, finished) -> Optional[Exception]:
        """Answer the kernel's polls through ``control.poll_slot`` until it
        has returned (``finished``, a CUDA event after it, completes). If a
        poll raises, every later answer (this one included) is a CANCEL of
        every row, so the kernel exits within one poll; the error is
        returned for the caller to raise once the kernel is done."""
        lib, box, served, failure = self.lib, self.box, 0, None
        while True:
            n = lib.b2_mailbox_take(
                box.host, self.rows, served, POLL_SPIN_US, ctypes.byref(self.k),
                self.done.ctypes.data,
            )
            if n != served:
                words = self.cancel_all
                if failure is None:
                    try:
                        words = self._words()
                    except Exception as e:  # noqa: BLE001 — raised after the kernel exits
                        failure, words = e, self.cancel_all
                lib.b2_mailbox_answer(box.host, words.ctypes.data, self.rows, n)
                served = n
            elif finished.query():
                return failure


def take_out_stats(stats: np.ndarray, slot: int, dev: int, queued_ns: int) -> None:
    """Take a controlled launch's statistics words (its out words after lo
    and hi): the polls and their round trips go into ``run_poll_stats``, and
    the windows the kernel ran, dealt evenly over every row or re-granted
    over fewer, to control slot ``slot`` as fan member ``dev``
    (``control.record_grid``)."""
    polls = int(stats[0])
    total_ns = int(stats[1]) | int(stats[2]) << 32
    max_ns = int(stats[3]) | int(stats[4]) << 32
    windows, regranted = int(stats[5]), int(stats[6])
    with _lock:
        run_poll_stats["polls"] += polls
        run_poll_stats["round_trip_ns"] += total_ns
        run_poll_stats["round_trip_ns_max"] = max(run_poll_stats["round_trip_ns_max"], max_ns)
        run_poll_stats["queued_ns"] += queued_ns
        run_poll_stats["queued_ns_max"] = max(run_poll_stats["queued_ns_max"], queued_ns)
    control.record_grid(slot, dev, windows - regranted, regranted)


def _sleep_until(event, max_nap: float = QUEUED_SLEEP_MAX_S) -> int:
    """Sleep, doubling the nap up to ``max_nap``, until ``event`` has
    completed: until the work queued ahead of a launch is done and its
    first poll is about to come, or a readback has landed. Polling the event
    (not blocking in the driver) keeps this thread from waiting on anything
    but its own stream's progress. Returns the nanoseconds waited."""
    t0, nap = time.perf_counter_ns(), 20e-6
    while not event.query():
        # dpowlint: disable=DPOW101 — a launch thread's nap while the card drains the work queued ahead of its kernel: progress is the CUDA event's, not a timer's, so no Clock can stand in for it
        time.sleep(nap)
        nap = min(2 * nap, max_nap)
    return time.perf_counter_ns() - t0


def cuda_search_run_batch_controlled(
    params_batch: torch.Tensor,
    active: Optional[torch.Tensor],
    slot: int,
    *,
    window: int,
    max_steps: int,
    poll_steps: int,
    stride: Optional[int] = None,
    dev: int = 0,
) -> tuple:
    """The persistent launch with a live control channel: the kernel polls
    slot ``slot``'s control block (ops/control.py) every ``poll_steps``
    windows, as fan member ``dev`` of it, and applies cancel, raise and
    rebase mid-launch; windows advance by ``stride`` as in
    :func:`cuda_search_run_batch`. Blocks the calling thread, serving the
    polls, until the kernel has returned, and returns (lo, hi) int32[B] bit
    views as :func:`cuda_search_run_batch` does, but on the host (read from
    the mailbox, see above). On a CPU tensor this is the plain version
    (``ops/runloop.py``)."""
    stride = _stride_for(window, stride)
    if params_batch.device.type == "cpu":
        from . import runloop

        return runloop.run_loop_core(
            params_batch, active, launch=runloop.plain_launch(window),
            window=stride, max_steps=max_steps,
            control_poll=runloop.make_control_poll(slot, dev=dev), poll_steps=poll_steps,
        )
    _check_params(params_batch)
    if poll_steps < 1:
        raise ValueError("poll_steps must be >= 1")
    rows = params_batch.shape[0]
    if rows == 0:
        empty = torch.empty(0, dtype=torch.int32)
        return empty, empty.clone()
    lib = load_run_library()
    device = params_batch.device.index
    if device is None:
        device = torch.cuda.current_device()
    box = _take_mailbox(lib, rows, device)
    lib.b2_mailbox_reset(box.host)
    server = _PollServer(lib, box, rows, int(slot), int(dev))
    with torch.cuda.device(params_batch.device):
        started, finished = torch.cuda.Event(), torch.cuda.Event()
        started.record(torch.cuda.current_stream(params_batch.device))
    base = box.out_offset(rows)
    stream = _run_launch(
        params_batch, active, window=window, stride=stride, max_steps=max_steps,
        poll_steps=poll_steps, out_ptr=box.dev + 4 * base, mbox_dev=box.dev,
    )
    finished.record(stream)
    queued_ns = _sleep_until(started)
    failure = server.serve(finished)
    out = box.words[base:base + 2 * rows + _OUT_STATS].copy()
    _give_mailbox(box)  # the kernel has returned: nothing reads it any more
    take_out_stats(out[2 * rows:], int(slot), int(dev), queued_ns)
    if failure is not None:
        raise failure
    bits = torch.from_numpy(out[:2 * rows].view(np.int32).copy())
    return bits[:rows], bits[rows:]
