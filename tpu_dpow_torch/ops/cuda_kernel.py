"""The hand-written CUDA kernel for the Blake2b nonce search: build, load, call.

Counterpart of ``tpu_dpow/ops/pallas_kernel.py``: ``cuda_search_chunk`` and
``cuda_search_chunk_batch`` take the signatures, geometry checks and
``< 2^31`` window limit of ``pallas_search_chunk`` and
``pallas_search_chunk_batch``. The three Pallas kernels (single, batched,
multi-window grid) are one CUDA kernel here (``csrc/blake2b_search.cu``);
``sublanes``, ``iters`` and ``nblocks`` only define the span one launch
scans per row, and ``group`` (the TPU's early-exit cadence) is checked and
otherwise unused: the kernel exits early per warp.

The kernel is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface at first use, and loaded with ``ctypes``. The
library's name carries a hash of the sources and the compile command, so an
edit rebuilds it and concurrent builders never load a half-written file.

A CUDA tensor goes to the kernel or raises. A CPU tensor goes to the plain
PyTorch version (``ops/search.py``); nothing else does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional

import torch

from . import search

DEFAULT_SUBLANES = 32
DEFAULT_ITERS = 256

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_HERE, "csrc")
# Where the library is built (listed in .gitignore).
BUILD_DIR = os.path.join(_HERE, "_build")
SOURCES = ("blake2b_search.cu", "blake2b_search.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_ABI_VERSION = 1

# Kernel launches made through the wrappers below (the only place it moves).
launches = 0

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_path: Optional[str] = None


def nvcc_path() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernel cannot be built")


def build_library() -> str:
    """Compile ``csrc/blake2b_search.cu`` if no library for these sources
    exists yet; return its path. ``<lib>.log`` keeps nvcc's output
    (``-Xptxas -v``: registers and spill bytes)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(_CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    out = os.path.join(BUILD_DIR, f"libb2search-{h.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = os.path.join(BUILD_DIR, f".{os.path.basename(out)}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, os.path.join(_CSRC, SOURCES[0])]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
        with open(out + ".log", "w") as f:
            f.write(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library once per process."""
    global _lib, _lib_path
    with _lock:
        if _lib is None:
            path = build_library()
            lib = ctypes.CDLL(path)
            lib.b2_abi_version.restype = ctypes.c_int
            if lib.b2_abi_version() != _ABI_VERSION:
                raise RuntimeError(f"{path}: ABI {lib.b2_abi_version()} != {_ABI_VERSION}")
            lib.b2_error_string.argtypes = [ctypes.c_int]
            lib.b2_error_string.restype = ctypes.c_char_p
            lib.b2_blocks_per_row.argtypes = [ctypes.c_int, ctypes.c_uint]
            lib.b2_blocks_per_row.restype = ctypes.c_int
            lib.b2_search_launch.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                ctypes.c_void_p,
            ]
            lib.b2_search_launch.restype = ctypes.c_int
            _lib, _lib_path = lib, path
        return _lib


def build_log() -> str:
    """nvcc's output for the loaded library ('' before the first load)."""
    if _lib_path is None or not os.path.exists(_lib_path + ".log"):
        return ""
    with open(_lib_path + ".log") as f:
        return f.read()


def library_path() -> Optional[str]:
    return _lib_path


def reset_launches() -> None:
    global launches
    with _lock:
        launches = 0


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
) -> torch.Tensor:
    """Batched launch: int32[B, 12] bit view of the uint32 rows → int32[B]
    bit view of the lowest valid offset per row, or SENTINEL.

    The span per row is ``nblocks * sublanes * 128 * iters`` nonces, as in
    ``pallas_search_chunk_batch``. On a CPU tensor this is the plain version.
    """
    global launches
    span = window(sublanes, iters, nblocks, group)
    if params_batch.device.type == "cpu":
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
    out = torch.full((rows,), -1, dtype=torch.int32, device=params_batch.device)
    if rows == 0:
        return out
    lib = load_library()
    with torch.cuda.device(params_batch.device):
        stream = torch.cuda.current_stream(params_batch.device).cuda_stream
        err = lib.b2_search_launch(
            params_batch.data_ptr(), out.data_ptr(), rows, span, stream
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

