"""Multi-host meshes: scale the gang past one host's cards.

Counterpart of ``tpu_dpow/parallel/multihost.py``. One logical worker may
span several hosts, each running one process of a ``torch.distributed``
group (gloo, over TCP).

Topology rule: the ``nonce`` axis — whose winner election runs every
launch — stays inside one host; the ``batch`` axis, which needs no
per-launch communication at all (requests are independent), is the axis
allowed to cross hosts. :func:`make_multihost_mesh` arranges the global
device grid exactly that way: ``batch`` = process index, ``nonce`` = that
process's cards. A process then computes only the rows of its own batch
row (``Mesh.addressable_rows``): no collective runs on the hot path.

For a single process this degrades to ``make_mesh`` over the local cards,
so the same code path runs everywhere.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from .mesh_search import Mesh, MeshDevice


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """``torch.distributed.init_process_group("gloo")`` with env-var
    fallbacks: TPU_DPOW_COORDINATOR (host:port of rank 0),
    TPU_DPOW_NUM_PROCESSES, TPU_DPOW_PROCESS_ID — the JAX package's env
    contract. No-op when neither arguments nor env are present
    (single-host mode). Honored at startup by the worker-client and
    workserver entry points."""
    coordinator_address = coordinator_address or os.environ.get(
        "TPU_DPOW_COORDINATOR"
    )
    if num_processes is None and "TPU_DPOW_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["TPU_DPOW_NUM_PROCESSES"])
    if process_id is None and "TPU_DPOW_PROCESS_ID" in os.environ:
        process_id = int(os.environ["TPU_DPOW_PROCESS_ID"])
    if coordinator_address is None:
        return  # single-host: nothing to initialize
    if num_processes is None or process_id is None:
        raise ValueError(
            "a coordinator needs the process count and this process's id "
            "(TPU_DPOW_NUM_PROCESSES, TPU_DPOW_PROCESS_ID)"
        )
    import torch.distributed as dist

    if "://" not in coordinator_address:
        coordinator_address = f"tcp://{coordinator_address}"
    dist.init_process_group(
        "gloo", init_method=coordinator_address, world_size=num_processes,
        rank=process_id,
    )


def arrange_by_host(devices: Sequence) -> np.ndarray:
    """Global devices → (hosts, cards_per_host) array.

    Groups by ``device.process_index`` (host identity), sorts within a
    host by device id for a stable order, and validates the layout is
    rectangular (equal cards per host).
    """
    hosts: dict = {}
    for d in devices:
        hosts.setdefault(d.process_index, []).append(d)
    counts = {len(v) for v in hosts.values()}
    if len(counts) != 1:
        raise ValueError(
            f"uneven chips per host: { {k: len(v) for k, v in hosts.items()} }"
        )
    rows = [
        sorted(hosts[p], key=lambda d: d.id) for p in sorted(hosts)
    ]
    return np.asarray(rows, dtype=object)


def _process_index() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def global_devices(local_devices: Optional[Sequence] = None) -> list:
    """Every process's members as :class:`MeshDevice` records: each process
    shares its local card count through ``all_gather_object`` (no exchange
    in a single process). Only this process's records carry a
    ``torch.device``."""
    import torch.distributed as dist

    from .fan_search import fan_devices

    local = list(local_devices if local_devices is not None else fan_devices(-1))
    rank = _process_index()
    if dist.is_available() and dist.is_initialized():
        counts: list = [None] * dist.get_world_size()
        dist.all_gather_object(counts, len(local))
    else:
        counts = [len(local)]
    out, gid = [], 0
    for p, n in enumerate(counts):
        for i in range(n):
            out.append(MeshDevice(p, gid, local[i] if p == rank else None))
            gid += 1
    return out


def make_multihost_mesh(
    devices: Optional[Sequence] = None, *, local_devices: Optional[Sequence] = None
) -> Mesh:
    """A (batch=hosts, nonce=local cards) mesh over a multi-host layout.

    ``devices``: the global device records (anything with
    ``.process_index`` and ``.id``); default :func:`global_devices` over
    ``local_devices`` (default: every visible card). The mesh computes only
    this process's batch row. With one process this is simply
    (1, n_local) — the single-host latency mode of ``make_mesh``.
    """
    if devices is None:
        devices = global_devices(local_devices)
    arr = arrange_by_host(devices)
    rank = _process_index()
    local_rows = [r for r in range(arr.shape[0]) if arr[r, 0].process_index == rank]
    return Mesh(arr, local_rows=local_rows)
