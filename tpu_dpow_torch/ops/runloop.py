"""Multi-window nonce search in one launch, with optional mid-launch control.

Counterpart of ``tpu_dpow/ops/runloop.py``. ``run_loop_core`` is the plain
PyTorch version of its device loop, step for step: scan one window per row,
record first hits, advance every row's 64-bit base, pin solved rows at their
winning nonce, and exit once every active row is done. With ``control_poll``
set it is the PERSISTENT flavor: at the start of every block of
``poll_steps`` windows it reads the launch's control words (ops/control.py)
and applies cancel, raise and rebase as the reference loop does.

``search_run_batch`` and ``search_run_batch_controlled`` keep the JAX
signatures (``kernel=`` and ``interpret=`` dropped) and add ``stride=``:
each window's base lies ``stride`` past the last one's (default: the
window, one contiguous scan), the interleaved windows a device of the fan
scans (parallel/fan_search.py). A CUDA tensor goes to the persistent CUDA
kernel (ops/cuda_kernel.py, ``csrc/blake2b_run.cu``), a CPU tensor to the
plain version, ``run_loop_core(launch=plain_launch(window),
window=stride)``. The plain version is what the engine runs
on the CPU and what the tests and ``chip_smoke.py`` hold the kernel against;
nothing on the path falls back to it when a card is present.

Rows travel as int32 bit views of the uint32[12] layout (ops/search.py);
the results are (lo, hi) int32[B] bit views of absolute 64-bit nonces,
all-ones (``UNSOLVED``) where a row came up dry, was inactive or cancelled.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from . import control as ctl
from . import cuda_kernel, search
from .search import BASE_HI, BASE_LO, DIFF_HI, DIFF_LO

#: nonce value reported for unsolved rows (all-ones). A genuine solution at
#: nonce 2^64-1 would be indistinguishable and re-searched — a 2^-64 event
#: per window, accepted for a branch-free device contract.
UNSOLVED = (1 << 64) - 1

_NO_HIT = -1  # search.SENTINEL as an int32 bit view


def plain_launch(window: int) -> Callable[[torch.Tensor], torch.Tensor]:
    """One window of the plain chunk scanner: params → int32[B] offsets."""
    return lambda params: search.search_chunk_batch(params, chunk_size=window)


def make_control_poll(slot: int, *, dev: int = 0):
    """The control poll for :func:`run_loop_core`: ``(k, done) →
    uint32[B, CTRL_WORDS]`` through ops/control.py's slot table, as the
    reference's ``io_callback`` reads it."""

    def control_poll(k: int, done: torch.Tensor) -> np.ndarray:
        return ctl.poll_slot(slot, dev, k, done.cpu().numpy())

    return control_poll


def run_loop_core(
    params_batch: torch.Tensor,
    active: Optional[torch.Tensor],
    *,
    launch,
    window: int,
    max_steps: int,
    control_poll=None,
    poll_steps: int = 0,
) -> tuple:
    """The multi-window loop (runloop.py:51-188), plain PyTorch.

    ``launch(params) -> offsets`` scans one window of ``window`` nonces per
    row (int32 bit views in and out). ``active`` (bool[B] or None) marks
    padding rows False: they start done at difficulty 0 and return
    ``UNSOLVED``. With ``control_poll`` (``(k, done) -> uint32[B,
    CTRL_WORDS]``) the loop polls at the start of each block of
    ``poll_steps`` windows, ``k = 0`` included, and a command issued during
    block k takes effect at the next block.
    """
    if params_batch.dtype != torch.int32:
        raise TypeError(f"params must be the int32 bit view, got {params_batch.dtype}")
    dev = params_batch.device
    b = params_batch.shape[0]
    lo = torch.full((b,), -1, dtype=torch.int32, device=dev)
    hi = lo.clone()
    params = params_batch.clone()
    if active is None:
        done = torch.zeros(b, dtype=torch.bool, device=dev)
    else:
        active = active.to(device=dev, dtype=torch.bool)
        done = ~active
        zero = torch.zeros_like(params[:, DIFF_LO])
        params[:, DIFF_LO] = torch.where(active, params[:, DIFF_LO], zero)
        params[:, DIFF_HI] = torch.where(active, params[:, DIFF_HI], zero)

    def step(params, lo, hi, done):
        offs = launch(params)
        found = (offs != _NO_HIT) & ~done
        win_lo, win_hi = search.nonces_from_offsets(params, offs)
        lo = torch.where(found, win_lo, lo)
        hi = torch.where(found, win_hi, hi)
        done = done | found
        params = search.advance_base_batch(params, window)
        # Pin solved rows at their winning nonce: every later window then
        # hits at offset 0 and drains at once.
        params[:, BASE_LO] = torch.where(done, lo, params[:, BASE_LO])
        params[:, BASE_HI] = torch.where(done, hi, params[:, BASE_HI])
        return params, lo, hi, done

    k = 0
    if control_poll is None:
        while k < max_steps and not bool(done.all()):
            params, lo, hi, done = step(params, lo, hi, done)
            k += 1
        return lo, hi

    poll_steps = max(1, int(poll_steps))
    seq = torch.zeros(b, dtype=torch.int64, device=dev)
    while k < max_steps and not bool(done.all()):
        words = np.asarray(control_poll(k, done), dtype=np.uint32)
        ctrl = torch.from_numpy(words.astype(np.int64)).to(dev)
        flags = ctrl[:, ctl.IDX_FLAGS]
        live = ~done
        cancel = live & ((flags & int(ctl.FLAG_CANCEL)) != 0)
        fresh = live & (ctrl[:, ctl.IDX_SEQ] != seq) & ~cancel
        do_raise = fresh & ((flags & int(ctl.FLAG_RAISE)) != 0)
        do_rebase = fresh & ((flags & int(ctl.FLAG_REBASE)) != 0)
        zero = torch.zeros_like(params[:, DIFF_LO])
        for col, idx in ((DIFF_LO, ctl.IDX_DIFF_LO), (DIFF_HI, ctl.IDX_DIFF_HI)):
            params[:, col] = torch.where(
                cancel, zero, torch.where(do_raise, search._i32(ctrl[:, idx]), params[:, col])
            )
        for col, idx in ((BASE_LO, ctl.IDX_BASE_LO), (BASE_HI, ctl.IDX_BASE_HI)):
            params[:, col] = torch.where(do_rebase, search._i32(ctrl[:, idx]), params[:, col])
        # A cancelled row is done but stays at the all-ones unsolved marker.
        done = done | cancel
        seq = torch.where(fresh, ctrl[:, ctl.IDX_SEQ], seq)
        j = 0
        while j < poll_steps and k < max_steps and not bool(done.all()):
            params, lo, hi, done = step(params, lo, hi, done)
            k += 1
            j += 1
    return lo, hi


def search_run_batch(
    params_batch: torch.Tensor,
    active: Optional[torch.Tensor],
    *,
    max_steps: int,
    sublanes: int = cuda_kernel.DEFAULT_SUBLANES,
    iters: int = cuda_kernel.DEFAULT_ITERS,
    nblocks: int = 1,
    group: int = 1,
    stride: Optional[int] = None,
) -> tuple:
    """Scan up to ``max_steps`` windows per row in ONE launch → (lo, hi)
    int32[B] bit views of each row's absolute winning nonce, or all-ones.
    The per-row window is ``sublanes * 128 * iters * nblocks`` nonces, and
    window k starts ``k * stride`` past the row's base (None: the window)."""
    window = cuda_kernel.window(sublanes, iters, nblocks, group)
    return cuda_kernel.cuda_search_run_batch(
        params_batch, active, window=window, max_steps=max_steps, stride=stride
    )


def search_run_batch_controlled(
    params_batch: torch.Tensor,
    active: Optional[torch.Tensor],
    slot: int,
    *,
    max_steps: int,
    poll_steps: int,
    sublanes: int = cuda_kernel.DEFAULT_SUBLANES,
    iters: int = cuda_kernel.DEFAULT_ITERS,
    nblocks: int = 1,
    group: int = 1,
    stride: Optional[int] = None,
) -> tuple:
    """:func:`search_run_batch` with a live control channel: the launch
    polls slot ``slot``'s control block every ``poll_steps`` windows and
    applies cancel, raise and rebase mid-launch, so ``max_steps`` can span
    the whole request while cancel latency stays one poll interval."""
    window = cuda_kernel.window(sublanes, iters, nblocks, group)
    return cuda_kernel.cuda_search_run_batch_controlled(
        params_batch, active, int(slot), window=window, max_steps=max_steps,
        poll_steps=poll_steps, stride=stride,
    )
