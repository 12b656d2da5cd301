"""Device fan: one request's nonce range searched over several devices.

Counterpart of ``tpu_dpow/parallel/fan_search.py`` (``jax.pmap`` over
``jax.local_devices()`` with ``lax.axis_index`` staggering and a
``lax.pmin`` election). On GPUs the same contract is host-driven:

  * **placement** — one launch per fan member on that member's
    ``torch.device``, inside ``torch.cuda.device(member)`` and on the
    member's stream when the caller gives one (``streams=``, a port-only
    argument: a stream is per thread, so the engine hands its own in).
    Launches without control are made from the calling thread, every
    member's before any result is read, so members on several cards scan
    at once. A controlled launch runs each member on a thread of its own
    (member 0 on the calling thread) that serves its kernel's control
    polls, so a member whose poll hangs wedges only itself while the
    others' polls keep flowing — as each device's ``io_callback`` thread
    does under ``pmap``;
  * **stagger** — ``advance_base_batch(p, axis_index * span)`` becomes base
    words baked per member on the host (:func:`stagger`);
  * **election** — ``lax.pmin`` becomes a host min over the members'
    global offsets. ``SENTINEL`` stays above every reachable global offset
    (which the geometry check keeps below 2^31), so no special case is
    needed.

A CUDA member launches the port's hand-written kernels (the chunk search
kernel, or the run kernel with strided windows, ops/cuda_kernel.py); a CPU
member runs their plain PyTorch versions. On the CPU a fan of N is N
logical members of ``torch.device("cpu")`` — the analog of the JAX
package's ``--xla_force_host_platform_device_count=8``. Nothing falls back: a CUDA member launches its kernel
or raises, and asking for more members than are visible raises.

The JAX signatures are kept, with ``kernel=`` and ``interpret=`` dropped,
``devices`` a list of ``torch.device`` and rows as numpy uint32 arrays.
On a CUDA member the window is the kernel's geometry, so ``chunk_per_shard``
must equal ``sublanes * 128 * iters * nblocks`` there (the JAX package's
Pallas rule); a CPU member scans any ``chunk_per_shard``.
"""

from __future__ import annotations

import contextlib
import threading
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..ops import cuda_kernel, runloop, search
from ..ops.search import SENTINEL

_MASK64 = (1 << 64) - 1

#: Logical CPU members a fan of -1 takes on the CPU, as the JAX package's
#: tests force 8 host-platform devices.
CPU_FAN_DEVICES = 8


def fan_devices(n: int = -1, device_type: str = "cuda") -> List[torch.device]:
    """Resolve the device complement for a fan of ``n``.

    ``n == -1`` takes every visible device; ``n >= 1`` takes the first n —
    including 1: a one-member fan runs the fan's machinery (per-member
    launches, per-member poll index, host election and attribution) on one
    device, the A/B configuration that prices it against the plain path.
    On ``cuda`` the visible devices are ``torch.cuda.device_count()`` cards;
    on ``cpu``, :data:`CPU_FAN_DEVICES` logical members of the CPU. Asking
    for more than are visible raises; the fan never shrinks quietly."""
    if device_type == "cuda":
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = [torch.device("cuda", i) for i in range(count)]
    elif device_type == "cpu":
        devices = [torch.device("cpu")] * CPU_FAN_DEVICES
    else:
        raise ValueError(f"fan devices must be cuda or cpu, not {device_type!r}")
    if n < 0:
        if not devices:
            raise ValueError(f"devices={n} but no {device_type} device is visible")
        return devices
    if n < 1 or n > len(devices):
        raise ValueError(f"devices={n} but {len(devices)} {device_type} devices visible")
    return devices[:n]


def _check_geometry(
    devices: Sequence[torch.device], chunk_per_shard: int, sublanes: int, iters: int,
    nblocks: int, *, global_chunk: bool,
) -> None:
    if global_chunk and chunk_per_shard * len(devices) >= 1 << 31:
        # Global offsets must stay below the int32/SENTINEL range so the
        # min election and the uint32 return contract both hold.
        raise ValueError("global chunk (chunk_per_shard * devices) must be < 2^31")
    if any(d.type == "cuda" for d in devices) and (
        chunk_per_shard != sublanes * 128 * iters * nblocks
    ):
        raise ValueError(
            "cuda members: chunk_per_shard must equal sublanes*128*iters*nblocks"
        )


def stagger(params_batch, n: int, step: int) -> np.ndarray:
    """Replicate uint32[B, 12] rows to [n, B, 12] with member i's bases
    ``i * step`` past the rows' own (64-bit carry) — the host form of
    ``advance_base_batch(p, axis_index * step)``."""
    rows = np.asarray(params_batch, dtype=np.uint32)
    stacked = np.repeat(rows[None], n, axis=0)
    bases = (rows[:, search.BASE_HI].astype(np.uint64) << np.uint64(32)) | rows[
        :, search.BASE_LO
    ].astype(np.uint64)
    for i in range(n):
        nb = bases + np.uint64(i) * np.uint64(step)  # uint64 wraps at 2^64
        stacked[i, :, search.BASE_LO] = (nb & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        stacked[i, :, search.BASE_HI] = (nb >> np.uint64(32)).astype(np.uint32)
    return stacked


@contextlib.contextmanager
def _on(device: torch.device, stream):
    """Inside a CUDA member's device and stream (the caller's, when it
    gives none); nothing to enter for a CPU member."""
    if device.type != "cuda":
        yield
        return
    with torch.cuda.device(device), torch.cuda.stream(stream):
        yield


def _each_member(launch, read, devices: Sequence[torch.device], streams) -> list:
    """``read(launch(i, device))`` for every member, from the calling
    thread: every member's launch first (a kernel returns without waiting,
    so members on several cards scan at once), then every member's result.
    For launches without control, which need no thread serving polls."""
    def stream(i):
        return streams[i] if streams is not None else None

    outs = []
    for i, d in enumerate(devices):
        with _on(d, stream(i)):
            outs.append(launch(i, d))
    results = []
    for i, (d, out) in enumerate(zip(devices, outs)):
        with _on(d, stream(i)):
            results.append(read(out))
    return results


def _on_member_threads(fn, devices: Sequence[torch.device], streams) -> list:
    """``fn(i, device)`` for every member, each on a thread of its own
    (member 0 on the calling thread) inside its device and stream: the
    controlled launch, where each member's thread serves its kernel's
    polls. Waits for every member, then raises the first failure."""
    n = len(devices)
    results, errors = [None] * n, [None] * n

    def member(i: int) -> None:
        try:
            with _on(devices[i], streams[i] if streams is not None else None):
                results[i] = fn(i, devices[i])
        except BaseException as e:  # noqa: BLE001 — re-raised below, after every member
            errors[i] = e

    threads = [
        threading.Thread(target=member, args=(i,), name=f"fan-member-{i}", daemon=True)
        for i in range(1, n)
    ]
    for t in threads:
        t.start()
    member(0)
    for t in threads:
        t.join()
    for e in errors:
        if e is not None:
            raise e
    return results


# The plain scan a CPU member runs is a long run of small tensor ops, each of
# which releases the interpreter lock: from several member threads at once
# they convoy on it, 8 members scanning several times slower together than
# one after another. CPU members take turns by whole windows instead; a
# poll, where a member may block, is outside the turn.
_cpu_turn = threading.Lock()


def _cpu_turns(launch):
    def take_turn(params: torch.Tensor) -> torch.Tensor:
        with _cpu_turn:
            return launch(params)

    return take_turn


def _upload(rows: np.ndarray, device: torch.device) -> torch.Tensor:
    return search.params_from_numpy(rows, device, non_blocking=device.type == "cuda")


def _active(active, n: int, b: int) -> Optional[np.ndarray]:
    """The active mask as uint8[n, b] (None: every row live), from [b] or
    per member [n, b]."""
    if active is None:
        return None
    return np.ascontiguousarray(np.broadcast_to(np.asarray(active, dtype=bool), (n, b)),
                                dtype=np.uint8)


def _active_on(act: Optional[np.ndarray], i: int, device: torch.device):
    if act is None:
        return None
    mask = torch.from_numpy(act[i].copy())
    return mask if device.type == "cpu" else mask.pin_memory().to(device, non_blocking=True)


def _local_scan(
    p_local: torch.Tensor, device: torch.device, *, chunk_per_shard: int, sublanes: int,
    iters: int, nblocks: int, group: int,
) -> torch.Tensor:
    """One member's window scan: the chunk search kernel on a CUDA member,
    its plain version on a CPU member → int32[B] local offsets."""
    if device.type == "cpu":
        return search.search_chunk_batch(p_local, chunk_size=chunk_per_shard)
    return cuda_kernel.cuda_search_chunk_batch(
        p_local, sublanes=sublanes, iters=iters, nblocks=nblocks, group=group
    )


def fan_search_devices(
    stacked_params: np.ndarray,
    *,
    devices: Sequence[torch.device],
    chunk_per_shard: int,
    sublanes: int = cuda_kernel.DEFAULT_SUBLANES,
    iters: int = cuda_kernel.DEFAULT_ITERS,
    nblocks: int = 1,
    group: int = 1,
    streams: Optional[Sequence] = None,
) -> np.ndarray:
    """Per-member launch with caller-owned bases: uint32[D, B, 12] →
    uint32[D, B] LOCAL offsets.

    No election: every member scans its own rows' windows (the caller
    bakes each member's base words into its slice). This is the engine's
    fan primitive — the host keeps the per-member bases, so it can elect
    the winner AND attribute it to the member whose sub-range produced it.
    """
    devs = list(devices)
    stacked = np.asarray(stacked_params, dtype=np.uint32)
    if stacked.shape[0] != len(devs):
        raise ValueError(
            f"stacked params lead axis {stacked.shape[0]} != {len(devs)} fan devices"
        )
    _check_geometry(devs, chunk_per_shard, sublanes, iters, nblocks, global_chunk=False)
    geo = dict(chunk_per_shard=chunk_per_shard, sublanes=sublanes, iters=iters,
               nblocks=nblocks, group=group)
    offs = _each_member(
        lambda i, d: _local_scan(_upload(stacked[i], d), d, **geo),
        search.offsets_to_numpy, devs, streams,
    )
    return np.stack(offs)


def fan_search_chunk_batch(
    params_batch,
    *,
    devices: Optional[Sequence[torch.device]] = None,
    n_devices: int = -1,
    chunk_per_shard: int,
    sublanes: int = cuda_kernel.DEFAULT_SUBLANES,
    iters: int = cuda_kernel.DEFAULT_ITERS,
    nblocks: int = 1,
    group: int = 1,
    streams: Optional[Sequence] = None,
) -> np.ndarray:
    """One fanned launch: uint32[B, 12] → uint32[B] global offsets.

    Each request's window of ``chunk_per_shard * n_devices`` nonces splits
    into disjoint member sub-ranges — member i scans ``[base +
    i*chunk_per_shard, base + (i+1)*chunk_per_shard)`` — and the returned
    offset is relative to the request's own base (SENTINEL if the whole
    fanned window is dry), so a host loop advances bases by the global
    chunk exactly as on one device.
    """
    devs = list(devices) if devices is not None else fan_devices(n_devices)
    n = len(devs)
    _check_geometry(devs, chunk_per_shard, sublanes, iters, nblocks, global_chunk=True)
    local = fan_search_devices(
        stagger(params_batch, n, chunk_per_shard), devices=devs,
        chunk_per_shard=chunk_per_shard, sublanes=sublanes, iters=iters,
        nblocks=nblocks, group=group, streams=streams,
    ).astype(np.int64)
    member = np.arange(n, dtype=np.int64)[:, None] * chunk_per_shard
    glob = np.where(local == int(SENTINEL), int(SENTINEL), member + local)
    return glob.min(axis=0).astype(np.uint32)


def fan_search_run_controlled(
    stacked_params: np.ndarray,
    slot: int,
    *,
    devices: Sequence[torch.device],
    chunk_per_shard: int,
    max_steps: int,
    poll_steps: int,
    stride: Optional[int] = None,
    active: Optional[np.ndarray] = None,
    sublanes: int = cuda_kernel.DEFAULT_SUBLANES,
    iters: int = cuda_kernel.DEFAULT_ITERS,
    nblocks: int = 1,
    group: int = 1,
    streams: Optional[Sequence] = None,
) -> tuple:
    """The PERSISTENT fan launch: per-member multi-window search with a
    live control channel — uint32[D, B, 12] caller-baked bases in,
    per-member absolute (lo, hi) uint32[D, B] nonces out (all-ones
    unsolved/cancelled).

    No election: the host elects the winner and keeps the attribution.
    Every member polls the SAME control slot every ``poll_steps`` windows
    with its own member index, so ops/control.py hands each member its own
    rebase base. ``stride`` is each member's per-window frontier advance:
    ``chunk_per_shard`` for contiguous 'split' macro-ranges (the default),
    ``chunk_per_shard * n_devices`` for 'interleave' (the caller bakes the
    ``d * chunk_per_shard`` stagger into the base words). The call returns
    once every member has returned: a member whose poll hangs holds it.
    """
    devs = list(devices)
    stacked = np.asarray(stacked_params, dtype=np.uint32)
    if stacked.shape[0] != len(devs):
        raise ValueError(
            f"stacked params lead axis {stacked.shape[0]} != {len(devs)} fan devices"
        )
    _check_geometry(devs, chunk_per_shard, sublanes, iters, nblocks, global_chunk=False)
    if stride is None:
        stride = chunk_per_shard
    if stride >= 1 << 31:
        raise ValueError("per-window stride must stay below 2^31 nonces")
    act = _active(active, len(devs), stacked.shape[1])

    def run(i: int, d: torch.device) -> tuple:
        if d.type == "cpu":
            lo, hi = runloop.run_loop_core(
                _upload(stacked[i], d), _active_on(act, i, d),
                launch=_cpu_turns(runloop.plain_launch(chunk_per_shard)), window=stride,
                max_steps=max_steps, poll_steps=poll_steps,
                control_poll=runloop.make_control_poll(int(slot), dev=i),
            )
        else:
            lo, hi = cuda_kernel.cuda_search_run_batch_controlled(
                _upload(stacked[i], d), _active_on(act, i, d), int(slot),
                window=chunk_per_shard, max_steps=max_steps, poll_steps=poll_steps,
                stride=stride, dev=i,
            )
        return search.offsets_to_numpy(lo), search.offsets_to_numpy(hi)

    out = _on_member_threads(run, devs, streams)
    return np.stack([lo for lo, _ in out]), np.stack([hi for _, hi in out])


def fan_search_run(
    params_batch,
    active=None,
    *,
    devices: Optional[Sequence[torch.device]] = None,
    n_devices: int = -1,
    chunk_per_shard: int,
    max_steps: int,
    sublanes: int = cuda_kernel.DEFAULT_SUBLANES,
    iters: int = cuda_kernel.DEFAULT_ITERS,
    nblocks: int = 1,
    group: int = 1,
    streams: Optional[Sequence] = None,
) -> tuple:
    """Multi-step fanned search: windows flow until every request hits or
    ``max_steps`` fanned windows are dry → (lo, hi) uint32[B] absolute
    nonces (all-ones unsolved).

    Window k of member i covers ``[base + k*global + i*chunk, +chunk)``:
    the members' interleaved windows tile the nonce space with no gaps or
    overlaps. Each member runs the run kernel with strided windows (stride
    = the global window); a member whose rows all hit returns early, and
    the host election below picks the globally earliest offset, which is
    the per-window election's winner because every member reports its
    FIRST hit.
    """
    devs = list(devices) if devices is not None else fan_devices(n_devices)
    n = len(devs)
    _check_geometry(devs, chunk_per_shard, sublanes, iters, nblocks, global_chunk=True)
    rows = np.asarray(params_batch, dtype=np.uint32)
    stacked = stagger(rows, n, chunk_per_shard)
    act = _active(active, n, rows.shape[0])
    out = _each_member(
        lambda i, d: cuda_kernel.cuda_search_run_batch(
            _upload(stacked[i], d), _active_on(act, i, d), window=chunk_per_shard,
            max_steps=max_steps, stride=chunk_per_shard * n,
        ),
        lambda lohi: tuple(map(search.offsets_to_numpy, lohi)), devs, streams,
    )
    return elect(rows, np.stack([lo for lo, _ in out]), np.stack([hi for _, hi in out]))


def elect(params_batch, lo_d: np.ndarray, hi_d: np.ndarray) -> tuple:
    """The host election of :func:`fan_search_run`: per row, the member
    nonce (of uint32[D, B] absolute nonces, all-ones where dry) that lies
    the fewest nonces past the row's base → (lo, hi) uint32[B], all-ones
    where every member was dry."""
    rows = np.asarray(params_batch, dtype=np.uint32)
    b = rows.shape[0]
    bases = (rows[:, search.BASE_HI].astype(np.uint64) << np.uint64(32)) | rows[
        :, search.BASE_LO
    ].astype(np.uint64)
    out_lo = np.full((b,), 0xFFFFFFFF, dtype=np.uint32)
    out_hi = np.full((b,), 0xFFFFFFFF, dtype=np.uint32)
    for r in range(b):
        best: Optional[int] = None
        for i in range(lo_d.shape[0]):
            nonce = (int(hi_d[i, r]) << 32) | int(lo_d[i, r])
            if nonce == _MASK64:
                continue
            off = (nonce - int(bases[r])) & _MASK64
            if best is None or off < ((best - int(bases[r])) & _MASK64):
                best = nonce
        if best is not None:
            out_lo[r] = best & 0xFFFFFFFF
            out_hi[r] = best >> 32
    return out_lo, out_hi
