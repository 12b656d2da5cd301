"""C++ CPU work backend via ctypes: the port's own ``blake2b_worker.cc``.

Counterpart of ``tpu_dpow/backend/native_backend.py``. The analog of the
reference's vendored ``nano-work-server`` CPU mode (reference client/bin,
client/README.md:3,31), rebuilt as an in-process shared library instead of
an HTTP sidecar: ``bw_search_range`` scans a nonce range with a thread pool,
polling a host-owned cancel flag so ``work_cancel`` semantics survive
without a process boundary (reference client/work_handler.py:75-78). The C
ABI plus ctypes is the binding layer, and ctypes releases the GIL for the
duration of each native call, so searches run via ``asyncio.to_thread``
without blocking the event loop.

The library self-builds with g++ from ``tpu_dpow_torch/native/blake2b_worker.cc``
on first use, into ``tpu_dpow_torch/native/_build/`` (overrides:
``TPU_DPOW_TORCH_NATIVE_DIR`` for the output directory,
``TPU_DPOW_TORCH_NATIVE_MARCH`` for ``-march``, ``CXX`` for the compiler).
The port keeps its own build directory and variables: the stamp does not
hash the source, so two packages building one identically named library
into one directory would rebuild each other's output in turn. This engine
is for the host CPU; the chain (resilience/failover.py) uses it as the
fallback behind the GPU engine.
"""

from __future__ import annotations

import asyncio
import ctypes
import hashlib
import os
import platform
import secrets
import subprocess
import threading
from dataclasses import dataclass
from typing import Dict, Optional

from .. import obs
from ..models import WorkRequest
from ..utils import nanocrypto as nc
from . import WorkBackend, WorkCancelled, WorkError, await_shared_job

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native"
)
_BUILD_DIR = os.path.join(_NATIVE_DIR, "_build")
_LIB_NAME = "libblake2b_worker.so"
_ABI_VERSION = 1

_build_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _host_cpu_identity() -> str:
    """A string that changes when the .so's -march=native output would:
    CPU model + ISA feature flags (Linux), or the platform fallback."""
    try:
        model = flags = ""
        with open("/proc/cpuinfo") as f:
            for line in f:
                if not model and line.startswith("model name"):
                    model = line.split(":", 1)[1].strip()
                elif not flags and line.startswith("flags"):
                    flags = line.split(":", 1)[1].strip()
                if model and flags:
                    break
        if model or flags:
            return hashlib.sha256(f"{model}|{flags}".encode()).hexdigest()
    except OSError:
        pass
    return f"{platform.machine()}|{platform.processor()}"


def build_library(force: bool = False) -> str:
    """Compile native/blake2b_worker.cc → _build/.so if missing/stale; return path.

    The compile lands in a temp file and is os.rename()d into place, so
    concurrent processes (server + client on one host, parallel pytest)
    never dlopen a half-written ELF. TPU_DPOW_TORCH_NATIVE_DIR overrides the
    output directory for read-only installs; TPU_DPOW_TORCH_NATIVE_MARCH
    overrides the -march flag (default ``native`` — set e.g. ``x86-64-v2``
    when the .so lands on a shared volume for a heterogeneous fleet).

    Staleness covers more than mtime: a sidecar .stamp records the compile
    command and the host CPU identity, so a cached .so built with different
    flags or on a different CPU (where -march=native bits could SIGILL this
    process) is rebuilt instead of reused.
    """
    src = os.path.join(_NATIVE_DIR, "blake2b_worker.cc")
    out_dir = os.environ.get("TPU_DPOW_TORCH_NATIVE_DIR", _BUILD_DIR)
    out = os.path.join(out_dir, _LIB_NAME)
    stamp_path = out + ".stamp"
    if not os.path.exists(src):
        raise WorkError(f"native source not found: {src}")
    march = os.environ.get("TPU_DPOW_TORCH_NATIVE_MARCH", "native")
    cmd = [
        os.environ.get("CXX", "g++"),
        "-O3",
        f"-march={march}",
        "-funroll-loops",
        "-fPIC",
        "-std=c++17",
        "-shared",
        "-pthread",
    ]
    # CPU identity matters only for -march=native output (different CPU =>
    # possible SIGILL); a portable march on a shared volume must NOT embed
    # one host's identity, or a heterogeneous fleet ping-pong-rebuilds the
    # identical .so forever.
    identity = _host_cpu_identity() if march == "native" else "portable"
    stamp = f"{' '.join(cmd)}|{identity}"
    try:
        with open(stamp_path) as f:
            stamp_matches = f.read() == stamp
    except OSError:
        # No/unreadable stamp => rebuild. A stamp-less .so could be a
        # foreign-CPU -march=native artifact, and a SIGILL from dlopening
        # it kills the process before any self-test can run.
        stamp_matches = False
    stale = (
        force
        or not os.path.exists(out)
        or os.path.getmtime(out) < os.path.getmtime(src)
        or not stamp_matches
    )
    if stale:
        os.makedirs(out_dir, exist_ok=True)
        tmp = os.path.join(out_dir, f".{_LIB_NAME}.{os.getpid()}.tmp")
        try:
            subprocess.run(
                cmd + ["-o", tmp, src], check=True, capture_output=True, text=True
            )
            os.rename(tmp, out)  # atomic: losers just overwrite with the same bits
            with open(stamp_path, "w") as f:
                f.write(stamp)
        except FileNotFoundError as e:
            raise WorkError(f"no C++ compiler available: {e}") from e
        except subprocess.CalledProcessError as e:
            raise WorkError(f"native build failed:\n{e.stderr}") from e
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return out


def load_library() -> ctypes.CDLL:
    """Load (building if needed) the worker library, with signatures set."""
    global _lib
    with _build_lock:
        if _lib is not None:
            return _lib
        path = build_library()
        lib = ctypes.CDLL(path)
        lib.bw_abi_version.restype = ctypes.c_int
        lib.bw_abi_version.argtypes = []
        if lib.bw_abi_version() != _ABI_VERSION:
            raise WorkError(
                f"native ABI mismatch: lib={lib.bw_abi_version()} "
                f"expected={_ABI_VERSION} (rebuild: build_library(force=True))"
            )
        lib.bw_work_value.restype = ctypes.c_uint64
        lib.bw_work_value.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        lib.bw_search_range.restype = ctypes.c_int
        lib.bw_search_range.argtypes = [
            ctypes.c_char_p,  # block_hash[32]
            ctypes.c_uint64,  # difficulty
            ctypes.c_uint64,  # base
            ctypes.c_uint64,  # count
            ctypes.c_int,  # n_threads
            ctypes.POINTER(ctypes.c_int32),  # cancel flag
            ctypes.POINTER(ctypes.c_uint64),  # nonce_out
            ctypes.POINTER(ctypes.c_uint64),  # hashes_done
        ]
        _lib = lib
        return _lib


def native_work_value(block_hash: str, nonce: int) -> int:
    """Work value via the native library (test hook vs hashlib)."""
    lib = load_library()
    return int(
        lib.bw_work_value(bytes.fromhex(nc.validate_block_hash(block_hash)), nonce)
    )


@dataclass
class _NativeJob:
    difficulty: int
    future: asyncio.Future
    cancel_flag: ctypes.c_int32
    waiters: int = 0  # refcount: last cancelled waiter aborts the scan
    task: Optional[asyncio.Task] = None  # strong ref: the loop holds tasks weakly
    rebase: Optional[int] = None  # fleet re-cover: jump scan here next chunk


class NativeWorkBackend(WorkBackend):
    """Multithreaded CPU nonce search through the C++ worker library.

    One native call covers ``chunk`` nonces; the host loop between calls is
    where cancels and difficulty raises land, mirroring the chunked-launch
    structure of the GPU engine (and bounding cancel latency to one chunk
    even if the in-call flag poll were missed).
    """

    def __init__(
        self,
        *,
        threads: Optional[int] = None,
        chunk: int = 1 << 22,
    ):
        self.threads = threads or max(1, (os.cpu_count() or 2) - 1)
        self.chunk = chunk
        self._jobs: Dict[str, _NativeJob] = {}
        self._lib: Optional[ctypes.CDLL] = None
        self._setup_lock = asyncio.Lock()
        self._closed = False
        self.total_hashes = 0
        self.total_solutions = 0
        # Same engine-metric families as the torch engine, under its own
        # engine label — one dashboard covers a mixed fleet.
        reg = obs.get_registry()
        self._tracer = obs.get_tracer()
        self._m_hashes = reg.counter(
            "dpow_engine_hashes_total", "Nonces scanned on device", ("engine",))
        self._m_solutions = reg.counter(
            "dpow_engine_solutions_total", "Nonces found and host-validated",
            ("engine",))
        self._m_jobs = reg.gauge(
            "dpow_engine_jobs", "Jobs currently tracked by the engine",
            ("engine",))

    async def setup(self) -> None:
        self._closed = False
        async with self._setup_lock:  # concurrent first generates: load once
            if self._lib is not None:
                return
            lib = await asyncio.to_thread(load_library)
            self._lib = lib
            # Self-test: difficulty 1 must hit on the first nonce tried.
            found, nonce, _ = await asyncio.to_thread(
                self._search_chunk, bytes(32), 1, 0, 16, None
            )
            if not found:
                self._lib = None
                raise WorkError("native backend self-test failed")

    def _search_chunk(
        self,
        hash_bytes: bytes,
        difficulty: int,
        base: int,
        count: int,
        cancel_flag: Optional[ctypes.c_int32],
    ) -> tuple[bool, int, int]:
        """Blocking native scan → (found, nonce, hashes_done)."""
        assert self._lib is not None
        nonce_out = ctypes.c_uint64(0)
        hashes_done = ctypes.c_uint64(0)
        rc = self._lib.bw_search_range(
            hash_bytes,
            difficulty,
            base & nc.MAX_U64,
            count,
            self.threads,
            ctypes.byref(cancel_flag) if cancel_flag is not None else None,
            ctypes.byref(nonce_out),
            ctypes.byref(hashes_done),
        )
        # total_hashes is accumulated by the caller on the event loop, not
        # here: this runs on to_thread workers, where += would race.
        return rc == 1, int(nonce_out.value), int(hashes_done.value)

    async def generate(self, request: WorkRequest) -> str:
        if self._closed:
            raise WorkError("backend closed")
        if self._lib is None:
            await self.setup()
        key = request.block_hash
        job = self._jobs.get(key)
        if job is not None and not job.future.done():
            # Dedup concurrent generates for one hash (reference dedups on
            # enqueue, client/work_handler.py:84-89): a stronger difficulty
            # raises the running job's target before the next chunk.
            if request.difficulty > job.difficulty:
                job.difficulty = request.difficulty
        else:
            job = _NativeJob(
                difficulty=request.difficulty,
                future=asyncio.get_running_loop().create_future(),
                cancel_flag=ctypes.c_int32(0),
            )
            self._jobs[key] = job
            self._m_jobs.set(len(self._jobs), "native")
            self._tracer.mark_hash(key, "pack")
            # The scan is its own task, owned by no waiter: any one waiter
            # giving up must not tear down a job others still share. The job
            # keeps the strong reference (the event loop holds tasks weakly
            # — a GC'd task would strand every waiter on a dead future).
            job.task = asyncio.ensure_future(
                self._run_job(key, request.hash_bytes, job,
                              nonce_range=request.nonce_range)
            )
        return await self._await_job(job)

    async def _await_job(self, job: _NativeJob) -> str:
        def abort():  # stop the native scan threads
            job.cancel_flag.value = 1

        return await await_shared_job(job, abort)

    async def _run_job(
        self, key: str, hash_bytes: bytes, job: _NativeJob, nonce_range=None
    ) -> None:
        # A sharded-dispatch range (fleet) pins the start to the shard;
        # otherwise a random base decorrelates from the racing swarm. The
        # range end is soft — see WorkRequest.nonce_range.
        if nonce_range is not None:
            base = nonce_range[0]
        else:
            base = secrets.randbits(64)
        try:
            while not job.future.done():
                # Fleet re-cover: jump the scan to an orphaned shard's start
                # (cover_range). Checked between chunks, like cancels.
                if job.rebase is not None:
                    base, job.rebase = job.rebase, None
                # Snapshot: a dedup waiter may raise job.difficulty mid-chunk.
                difficulty = job.difficulty
                found, nonce, hashes = await asyncio.to_thread(
                    self._search_chunk, hash_bytes, difficulty, base, self.chunk,
                    job.cancel_flag,
                )
                self.total_hashes += hashes
                self._m_hashes.inc(hashes, "native")
                if job.future.done():  # cancelled (or closed) while in flight
                    break
                if not found:
                    base = (base + self.chunk) & nc.MAX_U64
                    continue
                # Nano's work field: u64 nonce as 16 big-endian hex chars.
                work = f"{nonce:016x}"
                value = nc.work_value(key, work)
                if value >= job.difficulty:
                    # Host hashlib re-check: belt to the native suspenders.
                    self.total_solutions += 1
                    self._m_solutions.inc(1, "native")
                    self._tracer.mark_hash(key, "device")
                    job.future.set_result(work)
                elif value >= difficulty:
                    # Target raised mid-flight: keep scanning past this hit.
                    # nonce+1 re-covers blocks other threads had already
                    # finished in the aborted chunk — deliberate: per-thread
                    # progress isn't reported, any nonce is as good as any
                    # other, and total_hashes counts the re-scan because it
                    # is real compute.
                    base = (nonce + 1) & nc.MAX_U64
                else:
                    job.future.set_exception(
                        WorkError(
                            f"native engine produced invalid work {work} for {key}"
                        )
                    )
        except Exception as e:  # engine death must never strand waiters
            if not job.future.done():
                job.future.set_exception(WorkError(f"native engine failed: {e!r}"))
        finally:
            if self._jobs.get(key) is job:
                del self._jobs[key]
            self._m_jobs.set(len(self._jobs), "native")

    async def cancel(self, block_hash: str) -> None:
        job = self._jobs.get(nc.validate_block_hash(block_hash))
        if job is not None and not job.future.done():
            job.cancel_flag.value = 1
            job.future.set_exception(WorkCancelled(block_hash))

    async def raise_difficulty(self, block_hash: str, difficulty: int) -> bool:
        """Retarget a running job; the scan re-reads the target each chunk."""
        job = self._jobs.get(nc.validate_block_hash(block_hash))
        if job is None or job.future.done():
            return False
        if difficulty > job.difficulty:
            job.difficulty = difficulty
        return True

    async def cover_range(self, block_hash: str, nonce_range: tuple) -> bool:
        """Fleet re-cover: the scan loop rebases between chunks."""
        job = self._jobs.get(nc.validate_block_hash(block_hash))
        if job is None or job.future.done():
            return False
        job.rebase = nonce_range[0] & nc.MAX_U64
        return True

    async def close(self) -> None:
        self._closed = True
        for key, job in list(self._jobs.items()):
            job.cancel_flag.value = 1
            if not job.future.done():
                job.future.set_exception(WorkCancelled("backend closed"))
        self._jobs.clear()
