"""Nonce-space search over the Nano PoW predicate — plain PyTorch path.

Counterpart of ``tpu_dpow/ops/search.py``. Two device paths share this
module's conventions:
  * the plain PyTorch chunk scanner below — runs on any device PyTorch runs
    on; it is what the engine runs on the CPU, and the version the chip
    check holds the CUDA kernel against;
  * the hand-written CUDA kernel (ops/cuda_kernel.py,
    ops/csrc/blake2b_search.cu) — same contract, on the GPU.

Contract for one chunk launch:
  inputs : params uint32[12] =
           [m1lo m1hi m2lo m2hi m3lo m3hi m4lo m4hi  diff_lo diff_hi  base_lo base_hi]
  output : uint32 offset of the first (lowest-offset) valid nonce in
           [base, base + chunk), or SENTINEL (0xFFFFFFFF) if none.

The row layout is byte-identical to the JAX package's, so a row packed by
either package means the same search in both. PyTorch's unsigned dtypes have
no arithmetic, so on the torch side a uint32 row or result travels as an
**int32 bit view** (``params_from_numpy`` / ``offsets_to_numpy``), and the
arithmetic widens to int64 lanes (ops/blake2b.py).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import blake2b

SENTINEL = np.uint32(0xFFFFFFFF)

# params vector layout indices
MSG_SLICE = slice(0, 8)
DIFF_LO, DIFF_HI = 8, 9
BASE_LO, BASE_HI = 10, 11
PARAMS_LEN = 12

_MASK32 = 0xFFFFFFFF
# Lanes evaluated per step of the plain scan: bounds its memory (~20 live
# int64 tensors of this many elements) while keeping each op large.
_PLAIN_LANES = {"cpu": 1 << 16, "cuda": 1 << 22}


def pack_params(block_hash: bytes, difficulty: int, base: int) -> np.ndarray:
    """Host-side prep of one chunk launch's scalar parameters."""
    out = np.empty(PARAMS_LEN, dtype=np.uint32)
    out[MSG_SLICE] = blake2b.hash_to_message_words(block_hash)
    out[DIFF_LO] = difficulty & 0xFFFFFFFF
    out[DIFF_HI] = (difficulty >> 32) & 0xFFFFFFFF
    out[BASE_LO] = base & 0xFFFFFFFF
    out[BASE_HI] = (base >> 32) & 0xFFFFFFFF
    return out


def params_from_numpy(rows: np.ndarray, device="cpu", non_blocking: bool = False) -> torch.Tensor:
    """uint32 params rows ([12] or [B, 12]) → their int32 bit view on ``device``.
    ``non_blocking`` uploads to a card through pinned memory, queued on the
    current stream, without the host waiting for the work ahead of it."""
    rows = np.ascontiguousarray(rows, dtype=np.uint32)
    host = torch.from_numpy(rows.view(np.int32).copy())
    if non_blocking and torch.device(device).type == "cuda":
        return host.pin_memory().to(device, non_blocking=True)
    return host.to(device)


def offsets_to_numpy(out: torch.Tensor) -> np.ndarray:
    """int32 bit-view offsets (any device) → uint32 numpy (SENTINEL intact)."""
    return out.cpu().numpy().view(np.uint32)


def _u32(t: torch.Tensor) -> torch.Tensor:
    """int32 bit view → int64 lanes holding the unsigned value."""
    return t.to(torch.int64) & _MASK32


def _i32(t: torch.Tensor) -> torch.Tensor:
    """int64 lanes holding values in [0, 2^32) → their int32 bit view."""
    return (t - (((t >> 31) & 1) << 32)).to(torch.int32)


def _row_fields(params_batch: torch.Tensor) -> tuple:
    """int32 [B, 12] rows → (msg [B, 4], difficulty [B], base [B]) as int64
    u64 bit patterns."""
    p = _u32(params_batch)
    msg = p[:, 0:8:2] | (p[:, 1:8:2] << 32)
    diff = p[:, DIFF_LO] | (p[:, DIFF_HI] << 32)
    base = p[:, BASE_LO] | (p[:, BASE_HI] << 32)
    return msg, diff, base


def search_chunk_batch(
    params_batch: torch.Tensor, *, chunk_size: int, lanes: Optional[int] = None
) -> torch.Tensor:
    """Scan [base, base + chunk_size) for every row → int32[B] bit view of the
    lowest valid offset per row, or SENTINEL.

    ``params_batch`` is the int32 bit view of uint32[B, 12] rows. The window
    is walked in ascending slices of at most ``lanes`` nonces across the
    rows still unsolved; a row leaves the walk at its first slice with a
    hit, so the result is the lowest offset exactly as the kernels give it.
    """
    if not 0 < chunk_size < 1 << 32:
        raise ValueError("chunk_size must be in (0, 2^32): offsets are uint32")
    if params_batch.dim() != 2 or params_batch.shape[1] != PARAMS_LEN:
        raise ValueError(f"params must be [B, {PARAMS_LEN}], got {tuple(params_batch.shape)}")
    if params_batch.dtype != torch.int32:
        raise TypeError(f"params must be the int32 bit view, got {params_batch.dtype}")
    dev = params_batch.device
    msg, diff, base = _row_fields(params_batch)
    b = params_batch.shape[0]
    out = torch.full((b,), -1, dtype=torch.int32, device=dev)  # SENTINEL bits
    todo = torch.arange(b, device=dev)
    budget = lanes or _PLAIN_LANES.get(dev.type, 1 << 20)
    start = 0
    while start < chunk_size and todo.numel():
        n = min(max(budget // todo.numel(), 1), chunk_size - start)
        offs = torch.arange(start, start + n, dtype=torch.int64, device=dev)
        nonce = base[todo, None] + offs  # int64 add wraps exactly like u64
        ok = blake2b.pow_meets_difficulty(
            nonce, msg[todo, None, :], diff[todo, None]
        )
        hit = ok.any(dim=1)
        first = torch.where(ok, offs, torch.full_like(offs, 1 << 32)).min(dim=1).values
        out[todo[hit]] = _i32(first[hit])
        todo = todo[~hit]
        start += n
    return out


def search_chunk(params: torch.Tensor, *, chunk_size: int) -> torch.Tensor:
    """Single-row :func:`search_chunk_batch`: int32[12] → int32 scalar bit view."""
    return search_chunk_batch(params.reshape(1, PARAMS_LEN), chunk_size=chunk_size)[0]


def nonces_from_offsets(params_batch: torch.Tensor, offs: torch.Tensor) -> tuple:
    """Window offsets → absolute (lo, hi) 64-bit nonces, carry-correct, as
    int32 bit views (the SENTINEL is not special-cased; the engine's numpy
    twin ``_offsets_to_nonces`` maps it to the all-ones unsolved marker)."""
    base_lo = _u32(params_batch[:, BASE_LO])
    lo = base_lo + _u32(offs)
    hi = (_u32(params_batch[:, BASE_HI]) + (lo >> 32)) & _MASK32
    return _i32(lo & _MASK32), _i32(hi)


def advance_base_batch(params_batch: torch.Tensor, delta_lo: int) -> torch.Tensor:
    """params[B, 12] (int32 bit view) with every row's 64-bit base advanced
    by ``delta_lo`` (< 2^32), carry into the high word included."""
    if not 0 <= delta_lo < 1 << 32:
        raise ValueError("delta_lo must be in [0, 2^32)")
    lo, hi = nonces_from_offsets(
        params_batch, torch.full_like(params_batch[:, BASE_LO], delta_lo - ((delta_lo >> 31) << 32))
    )
    out = params_batch.clone()
    out[:, BASE_LO] = lo
    out[:, BASE_HI] = hi
    return out


def work_hex_from_nonce(nonce: int) -> str:
    """Nano's work field: the u64 nonce rendered as 16 big-endian hex chars."""
    return f"{nonce:016x}"
