"""WorkBackend: the dispatch boundary where compute engines plug in.

Counterpart of ``tpu_dpow/backend/__init__.py``. The reference's equivalent
seam is an HTTP POST of ``{"action": "work_generate", hash, difficulty}`` to
an external ``nano-work-server``, with ``work_cancel`` aborting an in-flight
hash; here it is an async protocol with three interchangeable engines:

  * :class:`~tpu_dpow_torch.backend.torch_backend.TorchWorkBackend` — the
    batched nonce search through the hand-written CUDA kernels on one GPU
    or fanned over several (``devices=``), or on the CPU through their
    plain PyTorch versions. The flagship path.
  * :class:`~tpu_dpow_torch.backend.native_backend.NativeWorkBackend` — C++
    multithreaded CPU search via ctypes (the reference's CPU mode analog),
    the usual fallback of the failover chain (resilience/failover.py).
  * :class:`~tpu_dpow_torch.backend.subprocess_backend.SubprocessWorkBackend`
    — HTTP JSON-RPC to an external nano-work-server-compatible process.
"""

from __future__ import annotations

import abc
import asyncio
from typing import Callable

from ..models import WorkRequest


class WorkError(Exception):
    """The backend failed to produce work."""


class WorkCancelled(WorkError):
    """The in-flight request was cancelled (reference work_cancel analog)."""


class DevicesExhausted(WorkError):
    """Every device in the engine's fault domain is quarantined: the
    engine KNOWS it cannot serve (resilience/devfault.py). Distinct from a
    plain WorkError so the failover chain (resilience/failover.py) can
    escalate immediately — trip the engine's breaker outright instead of
    probing a backend that has already declared itself dead — and count the
    cause separately from a hang."""


async def await_shared_job(job, abort: Callable[[], None]) -> str:
    """Wait on a shared (deduped) job with last-waiter-out cancellation.

    ``job`` needs ``.future`` and a ``.waiters`` int. Concurrent generates
    for one hash share a single search job; one impatient waiter — e.g. a
    wait_for timeout — must not tear down work others still share. Only when
    the last waiter gives up does ``abort`` run and the future get cancelled.
    """
    job.waiters += 1
    try:
        return await asyncio.shield(job.future)
    except asyncio.CancelledError:
        job.waiters -= 1
        if job.waiters <= 0 and not job.future.done():
            abort()
            job.future.cancel()
        raise


class WorkBackend(abc.ABC):
    """Async engine producing Nano proof-of-work."""

    @abc.abstractmethod
    async def setup(self) -> None:
        """Probe/initialize the engine; raise if unavailable."""

    @abc.abstractmethod
    async def generate(self, request: WorkRequest) -> str:
        """Search until a valid nonce is found → 16-hex-char work string.

        Raises WorkCancelled if cancel() arrives first.
        """

    @abc.abstractmethod
    async def cancel(self, block_hash: str) -> None:
        """Abort an in-flight generate for this hash (idempotent)."""

    async def raise_difficulty(self, block_hash: str, difficulty: int) -> bool:
        """Raise a RUNNING job's target in place; True if it took effect.

        The default says "can't" (False): the caller must then fall back to
        cancel + re-generate.
        """
        return False

    async def cover_range(self, block_hash: str, nonce_range: tuple) -> bool:
        """Re-aim a RUNNING job's scan at ``nonce_range``; True if it took.

        The default says "can't" (False) and the caller drops the hint — an
        engine racing the full space is always correct.
        """
        return False

    async def close(self) -> None:  # pragma: no cover - trivial default
        return None


def get_backend(name: str, **kwargs) -> WorkBackend:
    """Construct a backend by name: 'torch' | 'native' | 'subprocess'.

    Keyword arguments go to the engine's constructor, e.g. ``devices=-1,
    device_shard="interleave"`` for the torch engine's device fan,
    ``threads=`` for native, ``uri=`` for subprocess."""
    if name == "torch":
        from .torch_backend import TorchWorkBackend

        return TorchWorkBackend(**kwargs)
    if name == "native":
        from .native_backend import NativeWorkBackend

        return NativeWorkBackend(**kwargs)
    if name == "subprocess":
        from .subprocess_backend import SubprocessWorkBackend

        return SubprocessWorkBackend(**kwargs)
    raise ValueError(f"unknown work backend: {name!r}")
