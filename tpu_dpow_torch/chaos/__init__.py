"""Chaos layer of the port: deterministic, seedable fault injection.

Counterpart of ``tpu_dpow/chaos/``: a fault-injecting wrapper for each
dependency seam, all driven by one scripted :class:`FaultSchedule`:

  FaultyTransport — drop / delay / duplicate / reorder / disconnect,
                    per direction, per topic pattern;
  FaultyStore     — connection errors, delays, hangs, per key pattern;
  FaultyBackend   — WorkError, hang-until-cancel, wrong nonces, delays,
                    per block hash;
  FaultyDevice    — hang-at-poll / slow-poll / dead-after-K-windows per
                    DEVICE index, hooked at the engine's launch-thread
                    and control-poll boundaries (ops/control.py).

Everything is deterministic: counts are exact, probabilistic rules draw
from the schedule's seeded RNG, and every delay runs on an injectable
clock (:class:`FakeClock`, re-exported from tpu_dpow_torch.resilience).
"""

import asyncio as _asyncio

from ..resilience.clock import FakeClock, SystemClock  # noqa: F401
from .backend import FaultyBackend, invalid_work_for  # noqa: F401
from .device import FaultyDevice  # noqa: F401
from .schedule import (  # noqa: F401
    ACTIONS,
    DELAY,
    DISCONNECT,
    DROP,
    DUPLICATE,
    ERROR,
    HANG,
    REORDER,
    WRONG_WORK,
    FaultSchedule,
    Rule,
)
from .store import FaultyStore  # noqa: F401
from .transport import FaultyTransport  # noqa: F401


async def join_client(client, server):
    """``await client.setup()`` against a FakeClock server, without
    moving time.

    The server's heartbeat loop beats on the injectable clock (dpowlint
    DPOW101), so under a FakeClock a beat only fires when the scenario
    advances time — and a client joining BETWEEN beats would wait out its
    real-time startup gate against a frozen clock. Advancing the clock to
    feed the gate would drift every subsequent choreographed deadline, so
    instead this re-publishes the heartbeat directly (exactly what the
    loop would do) until setup resolves. Scenario time stays untouched.
    """
    task = _asyncio.ensure_future(client.setup())
    try:
        for _ in range(500):  # bounded: fail fast instead of spinning forever
            if task.done():
                return task.result()
            await server.transport.publish("heartbeat", "", qos=0)
            for _ in range(20):  # let the frame flow broker → client → gate
                await _asyncio.sleep(0)
        raise TimeoutError(
            "client.setup() did not resolve within 500 heartbeat rounds — "
            "it is stuck on something other than the startup gate"
        )
    finally:
        # any non-success exit (timeout above, a chaos-injected publish
        # error, outer cancellation) must not strand the half-initialized
        # setup task
        if not task.done():
            task.cancel()
            await _asyncio.gather(task, return_exceptions=True)
