"""Chaos layer of the port: deterministic fault injection at a seam.

Counterpart of ``tpu_dpow/chaos/``. So far the port carries the device
seam only: :class:`FaultyDevice` (hang-at-poll / slow-poll /
dead-after-K-windows / hang-at-launch per DEVICE index), hooked at the
engine's launch-thread and control-poll boundaries (ops/control.py) — the
seam under the per-device fault domains (resilience/devfault.py). The
transport, store and backend seams come with the client/server slice.
"""

from ..resilience.clock import FakeClock, SystemClock  # noqa: F401
from .device import FaultyDevice  # noqa: F401
