"""Mesh gang: one ganged nonce search over a (batch, nonce) grid of devices.

Counterpart of ``tpu_dpow/parallel/mesh_search.py`` (``jax.shard_map`` over
a ``Mesh`` with a ``lax.pmin`` election). The mesh's two axes keep their
meaning:

  * the **nonce axis** splits each request's window into disjoint per-device
    sub-ranges — member i scans ``[base + i*chunk, base + (i+1)*chunk)``;
  * the **batch axis** spreads the rows of one launch over groups of
    devices: the rows split into contiguous blocks, one per batch shard, as
    ``P(BATCH_AXIS, None)`` places them.

On GPUs the ``shard_map`` body is host-driven, as the device fan's is
(parallel/fan_search.py, whose helpers this module reuses):
``advance_base_batch(p, axis_index * span)`` becomes base words baked per
member on the host (``fan_search.stagger``), every member's launch of the
hand-written search kernel (ops/cuda_kernel.py) is enqueued before any
result is read (``fan_search._each_member``), and ``lax.pmin`` becomes a
host min over the members' global offsets. A CPU member runs the kernel's
plain PyTorch version; on the CPU a mesh of N is N logical members of
``torch.device("cpu")``, as the JAX package's tests force 8 host devices.

The multi-window functions keep the JAX structure, where the ``while_loop``
sits OUTSIDE the ``shard_map``: the port's plain loop
(``runloop.run_loop_core``) drives one ganged launch per window of
``chunk_per_shard * nonce shards`` nonces. The gang is one logical
frontier: the controlled variant polls with ``dev=0``, and no member scans
past the window in which the gang found a row's winner.

The JAX signatures are kept, with ``kernel=`` and ``interpret=`` dropped,
rows as numpy uint32 arrays, results as numpy uint32 arrays, and
``streams=`` added (one CUDA stream per mesh member, row-major, as the fan
takes them). On a CUDA member the window is the kernel's geometry, so
``chunk_per_shard`` must equal ``sublanes * 128 * iters * nblocks`` there.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from ..ops import cuda_kernel, runloop, search
from ..ops.search import SENTINEL
from . import fan_search

BATCH_AXIS = "batch"
NONCE_AXIS = "nonce"


@dataclass(frozen=True)
class MeshDevice:
    """A mesh member as the multi-host layout sees it: the process that owns
    it, its id within that process, and its ``torch.device`` (None for a
    member of another process). The counterpart of a ``jax.Device``'s
    ``.process_index`` and ``.id``."""

    process_index: int
    id: int
    device: Optional[torch.device] = None


def _torch_device(member) -> Optional[torch.device]:
    return member if isinstance(member, torch.device) else member.device


class Mesh:
    """A (batch, nonce) grid of devices: ``devices`` is the 2-D object array
    (``torch.device`` members, or :class:`MeshDevice` records for a
    multi-host layout) and ``shape`` maps each axis name to its size.

    ``local_rows`` names the batch rows this process computes (None: every
    row, a single-process mesh). A multi-host mesh computes only its own
    process's row, so no collective runs on the hot path."""

    def __init__(self, devices, axis_names=(BATCH_AXIS, NONCE_AXIS),
                 local_rows: Optional[Sequence[int]] = None):
        rows = [list(r) for r in devices]
        if not rows or not rows[0] or any(len(r) != len(rows[0]) for r in rows):
            raise ValueError("a mesh is a non-empty rectangular 2-D device grid")
        arr = np.empty((len(rows), len(rows[0])), dtype=object)
        for r, row in enumerate(rows):
            for i, d in enumerate(row):
                arr[r, i] = d
        self.devices = arr
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, arr.shape))
        self.local_rows = None if local_rows is None else tuple(local_rows)

    @property
    def size(self) -> int:
        return self.devices.size

    def addressable_rows(self, b: int) -> np.ndarray:
        """Indices of the params rows this process computes out of ``b``:
        the contiguous blocks of its local batch shards."""
        n_b = self.shape[BATCH_AXIS]
        block = b // n_b
        shards = range(n_b) if self.local_rows is None else self.local_rows
        return np.concatenate(
            [np.arange(r * block, (r + 1) * block) for r in shards] or [np.arange(0)]
        ).astype(np.int64)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, local_rows={self.local_rows})"


def make_mesh(devices: Optional[Sequence] = None, *, batch_shards: int = 1) -> Mesh:
    """A (batch, nonce) mesh over the given devices (default: every visible
    card).

    batch_shards=1 (default) is latency mode: the full device complement
    gangs up on each request's nonce space. batch_shards=len(devices) is
    throughput mode: one independent request stream per device.
    """
    devices = list(devices if devices is not None else fan_search.fan_devices(-1))
    n = len(devices)
    if n % batch_shards != 0:
        raise ValueError(f"{batch_shards} batch shards do not divide {n} devices")
    per = n // batch_shards
    return Mesh([devices[r * per:(r + 1) * per] for r in range(batch_shards)])


def _check_mesh_geometry(members, n_nonce: int, chunk_per_shard: int, sublanes: int,
                         iters: int, nblocks: int) -> None:
    if chunk_per_shard * n_nonce >= 1 << 31:
        # Global offsets must stay below the int32/SENTINEL range so the
        # min election and the uint32 return contract both hold.
        raise ValueError("global chunk (chunk_per_shard * nonce shards) must be < 2^31")
    fan_search._check_geometry(
        members, chunk_per_shard, sublanes, iters, nblocks, global_chunk=False
    )


def _local_members(mesh: Mesh) -> tuple:
    """(batch row, nonce index, torch.device, flat member index) of every
    member this process launches, row-major."""
    n_n = mesh.shape[NONCE_AXIS]
    rows = range(mesh.shape[BATCH_AXIS]) if mesh.local_rows is None else mesh.local_rows
    out = []
    for r in rows:
        for i in range(n_n):
            dev = _torch_device(mesh.devices[r, i])
            if dev is None:
                raise ValueError(f"mesh member ({r}, {i}) has no local device")
            out.append((r, i, dev, r * n_n + i))
    return tuple(out)


def sharded_search_chunk_batch(
    params_batch,
    *,
    mesh: Mesh,
    chunk_per_shard: int,
    sublanes: int = cuda_kernel.DEFAULT_SUBLANES,
    iters: int = cuda_kernel.DEFAULT_ITERS,
    nblocks: int = 1,
    group: int = 1,
    streams: Optional[Sequence] = None,
) -> np.ndarray:
    """One ganged multi-device launch: uint32[B, 12] → uint32[B] global
    offsets.

    Each request's window of ``chunk_per_shard * mesh.shape[NONCE_AXIS]``
    nonces is scanned in parallel; the returned offset is relative to the
    request's own base (SENTINEL if the whole ganged window is dry), so a
    host loop advances bases by the global chunk exactly as on one device.
    B must divide by the batch shards. Rows of a batch shard this process
    does not compute (multi-host) come back SENTINEL.
    """
    rows = np.asarray(params_batch, dtype=np.uint32)
    b = rows.shape[0]
    n_b, n_n = mesh.shape[BATCH_AXIS], mesh.shape[NONCE_AXIS]
    if b % n_b:
        raise ValueError(f"batch of {b} rows does not split over {n_b} batch shards")
    members = _local_members(mesh)
    _check_mesh_geometry([m[2] for m in members], n_n, chunk_per_shard, sublanes, iters,
                         nblocks)
    block = b // n_b
    staggered = {
        r: fan_search.stagger(rows[r * block:(r + 1) * block], n_n, chunk_per_shard)
        for r in {m[0] for m in members}
    }
    geo = dict(chunk_per_shard=chunk_per_shard, sublanes=sublanes, iters=iters,
               nblocks=nblocks, group=group)
    member_streams = None if streams is None else [streams[m[3]] for m in members]

    def launch(k: int, d: torch.device) -> torch.Tensor:
        r, i = members[k][0], members[k][1]
        return fan_search._local_scan(fan_search._upload(staggered[r][i], d), d, **geo)

    local = fan_search._each_member(
        launch, search.offsets_to_numpy, [m[2] for m in members], member_streams
    )
    out = np.full((b,), SENTINEL, dtype=np.uint32)
    for r in staggered:
        offs = np.stack([local[k] for k, m in enumerate(members) if m[0] == r]).astype(np.int64)
        member = np.arange(n_n, dtype=np.int64)[:, None] * chunk_per_shard
        glob = np.where(offs == int(SENTINEL), int(SENTINEL), member + offs)
        out[r * block:(r + 1) * block] = glob.min(axis=0).astype(np.uint32)
    return out


def _host_loop(params_batch, active, mesh: Mesh, chunk_per_shard: int, **kwargs) -> tuple:
    """(params int32 CPU tensor, active bool CPU tensor or None, ganged
    launch) for the plain loop. Rows this process does not compute start
    done, as padding does."""
    rows = np.asarray(params_batch, dtype=np.uint32)
    act = None if active is None else np.asarray(active, dtype=bool).copy()
    if mesh.local_rows is not None:
        mine = np.zeros(rows.shape[0], dtype=bool)
        mine[mesh.addressable_rows(rows.shape[0])] = True
        act = mine if act is None else act & mine
    geo = dict(mesh=mesh, chunk_per_shard=chunk_per_shard, **kwargs)

    def launch(params: torch.Tensor) -> torch.Tensor:
        offs = sharded_search_chunk_batch(params.numpy().view(np.uint32), **geo)
        return torch.from_numpy(offs.view(np.int32).copy())

    return (
        search.params_from_numpy(rows),
        None if act is None else torch.from_numpy(act),
        launch,
    )


def sharded_search_run(
    params_batch,
    active=None,
    *,
    mesh: Mesh,
    chunk_per_shard: int,
    max_steps: int,
    sublanes: int = cuda_kernel.DEFAULT_SUBLANES,
    iters: int = cuda_kernel.DEFAULT_ITERS,
    nblocks: int = 1,
    group: int = 1,
    streams: Optional[Sequence] = None,
) -> tuple:
    """Multi-step ganged search: keep ganged windows flowing until every
    request has a hit or ``max_steps`` windows are dry → (lo, hi) uint32[B]
    absolute winning nonces (all-ones where unsolved).

    ``active`` (bool[B], optional) marks real rows: False rows are batch
    padding, done from the start, so they never hold the loop at
    ``max_steps``.
    """
    n_nonce = mesh.shape[NONCE_AXIS]
    params, act, launch = _host_loop(
        params_batch, active, mesh, chunk_per_shard, sublanes=sublanes, iters=iters,
        nblocks=nblocks, group=group, streams=streams,
    )
    lo, hi = runloop.run_loop_core(
        params, act, launch=launch, window=chunk_per_shard * n_nonce, max_steps=max_steps,
    )
    return search.offsets_to_numpy(lo), search.offsets_to_numpy(hi)


def sharded_search_run_controlled(
    params_batch,
    active,
    slot: int,
    *,
    mesh: Mesh,
    chunk_per_shard: int,
    max_steps: int,
    poll_steps: int,
    sublanes: int = cuda_kernel.DEFAULT_SUBLANES,
    iters: int = cuda_kernel.DEFAULT_ITERS,
    nblocks: int = 1,
    group: int = 1,
    streams: Optional[Sequence] = None,
) -> tuple:
    """:func:`sharded_search_run` with a live control channel: the loop
    polls control slot ``slot`` (ops/control.py) at the start of every block
    of ``poll_steps`` ganged windows, with ``dev=0`` — the gang is one
    logical frontier. A rebase rewrites the row's base and the next
    window's launch staggers the new region exactly as the first window
    staggered the old one.

    The engine refuses persistent mode with a mesh, as the JAX engine
    does; this function is the gang's controlled launch for callers that
    drive it directly.
    """
    n_nonce = mesh.shape[NONCE_AXIS]
    params, act, launch = _host_loop(
        params_batch, active, mesh, chunk_per_shard, sublanes=sublanes, iters=iters,
        nblocks=nblocks, group=group, streams=streams,
    )
    lo, hi = runloop.run_loop_core(
        params, act, launch=launch, window=chunk_per_shard * n_nonce, max_steps=max_steps,
        control_poll=runloop.make_control_poll(int(slot)), poll_steps=poll_steps,
    )
    return search.offsets_to_numpy(lo), search.offsets_to_numpy(hi)


def expected_steps(difficulty: int, *, chunk_per_shard: int, n_nonce: int) -> int:
    """Median number of ganged windows to a solution at this difficulty."""
    p = (2**64 - difficulty) / 2**64
    median_hashes = math.log(2) / max(p, 1e-30)
    return max(1, math.ceil(median_hashes / (chunk_per_shard * n_nonce)))


def replicate_params(params_batch, mesh: Mesh) -> np.ndarray:
    """The rows as the ganged launch takes them: unchanged, since each
    member uploads its own staggered copy at launch. Kept so that callers
    port one to one."""
    return np.asarray(params_batch, dtype=np.uint32)
