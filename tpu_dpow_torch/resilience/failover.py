"""FailoverBackend: chain work engines behind per-engine circuit breakers.

Counterpart of ``tpu_dpow/resilience/failover.py``. The reference worker
has exactly one engine (the vendored nano-work-server) and one failure
mode: log and drop the work (reference client/work_handler.py:95-108).
Here the client can run a CHAIN — torch → native → error — where each
engine sits behind its own
:class:`~tpu_dpow_torch.resilience.breaker.CircuitBreaker`:

  * a WorkError (or an unexpected exception, or a hang past
    ``hang_timeout``) records a failure and falls through to the next
    engine in the chain, so the request is still served;
  * DevicesExhausted (the engine's fault domains quarantined every card)
    trips the engine's breaker at once and falls through;
  * ``failure_threshold`` consecutive failures trip the engine's breaker:
    it is skipped outright (no per-request latency paid probing a dead
    engine) until ``reset_timeout`` elapses, when ONE probe request is let
    through (half-open) — success closes the breaker and the engine
    resumes as primary;
  * WorkCancelled is neutral: a cancel is the swarm working as intended,
    not an engine fault.

Per-engine serving and failover counts land beside the breaker state on
/metrics (dpow_client_backend_served_total / ..._failover_total).
"""

from __future__ import annotations

import asyncio
from typing import Dict, List, Optional, Sequence, Tuple

from .. import obs
from ..backend import DevicesExhausted, WorkBackend, WorkCancelled, WorkError
from ..models import WorkRequest
from ..utils.logging import get_logger
from .breaker import CircuitBreaker
from .clock import Clock, SystemClock

logger = get_logger("tpu_dpow_torch.resilience")


class FailoverBackend(WorkBackend):
    def __init__(
        self,
        backends: Sequence[Tuple[str, WorkBackend]],
        *,
        failure_threshold: int = 3,
        reset_timeout: float = 30.0,
        hang_timeout: float = 0.0,  # 0 = no hang detection
        clock: Optional[Clock] = None,
    ):
        if not backends:
            raise ValueError("FailoverBackend needs at least one engine")
        self.backends: List[Tuple[str, WorkBackend]] = list(backends)
        self.hang_timeout = hang_timeout
        self.clock = clock or SystemClock()
        self.breakers: Dict[str, CircuitBreaker] = {
            name: CircuitBreaker(
                f"backend:{name}",
                failure_threshold=failure_threshold,
                reset_timeout=reset_timeout,
                clock=self.clock,
            )
            for name, _ in self.backends
        }
        self._ready: Dict[str, bool] = {}
        # Which engine currently owns each in-flight hash, so cancel and
        # raise_difficulty reach the engine actually grinding it.
        self._owners: Dict[str, Tuple[str, WorkBackend]] = {}
        # The handler sizes its in-flight cap off the engine's batch width;
        # the chain batches like its primary does.
        primary = self.backends[0][1]
        if hasattr(primary, "max_batch"):
            self.max_batch = primary.max_batch
        reg = obs.get_registry()
        self._m_served = reg.counter(
            "dpow_client_backend_served_total",
            "Work served, by engine in the failover chain", ("backend",))
        self._m_failover = reg.counter(
            "dpow_client_backend_failover_total",
            "Generates that fell through an engine, by engine and cause",
            ("backend", "cause"))

    async def setup(self) -> None:
        """Probe every engine up front: a fallback that cannot start is
        dropped from the chain NOW (logged), not discovered mid-failover."""
        for name, backend in self.backends:
            try:
                await backend.setup()
                self._ready[name] = True
            except asyncio.CancelledError:
                raise
            except Exception as e:
                self._ready[name] = False
                logger.error("engine %s failed setup; dropped from the "
                             "failover chain: %s", name, e)
        if not any(self._ready.values()):
            raise WorkError("no engine in the failover chain came up")

    async def close(self) -> None:
        for name, backend in self.backends:
            if self._ready.get(name):
                await backend.close()

    async def _bounded(self, coro):
        """Run an engine call under the hang budget, on the injectable
        clock (asyncio.wait_for would tie hang detection to real time and
        make every chaos test sleep for real)."""
        if self.hang_timeout <= 0:
            return await coro
        task = asyncio.ensure_future(coro)
        timer = asyncio.ensure_future(self.clock.sleep(self.hang_timeout))
        try:
            await asyncio.wait({task, timer}, return_when=asyncio.FIRST_COMPLETED)
        except asyncio.CancelledError:
            task.cancel()
            timer.cancel()
            await asyncio.gather(task, timer, return_exceptions=True)
            raise
        if task.done():
            timer.cancel()
            return task.result()
        task.cancel()
        await asyncio.gather(task, return_exceptions=True)
        raise asyncio.TimeoutError

    async def generate(self, request: WorkRequest) -> str:
        block_hash = request.block_hash
        last_error: Optional[BaseException] = None
        for name, backend in self.backends:
            if not self._ready.get(name):
                continue
            breaker = self.breakers[name]
            if not breaker.allow():
                continue
            self._owners[block_hash] = (name, backend)
            try:
                work = await self._bounded(backend.generate(request))
            except WorkCancelled:
                # Not an engine fault; don't fail over a cancel — but free
                # the half-open probe slot this call may be holding, or a
                # cancelled probe wedges the breaker (and the engine) open.
                breaker.release_probe()
                raise
            except asyncio.CancelledError:
                breaker.release_probe()
                raise
            except asyncio.TimeoutError:
                breaker.record_failure()
                self._m_failover.inc(1, name, "hang")
                last_error = WorkError(
                    f"{name} engine hung past {self.hang_timeout}s")
                logger.error("engine %s hung on %s; failing over",
                             name, block_hash)
                try:
                    await backend.cancel(block_hash)
                except Exception:
                    pass
            except DevicesExhausted as e:
                # The engine's own fault domains already declared every
                # device quarantined (backend/torch_backend.py watchdog):
                # don't wait out hang_timeout or burn failure_threshold
                # requests probing a backend that knows it is dead — trip
                # the breaker NOW and serve from the next engine. The
                # breaker's normal reset → half-open probe re-admits it
                # (by then a successful device probe usually has, too).
                breaker.trip()
                self._m_failover.inc(1, name, "devices_exhausted")
                last_error = e
                logger.error("engine %s has zero healthy devices on %s; "
                             "breaker tripped, failing over", name, block_hash)
            except WorkError as e:
                breaker.record_failure()
                self._m_failover.inc(1, name, "error")
                last_error = e
                logger.warning("engine %s failed %s (%s); failing over",
                               name, block_hash, e)
            except Exception as e:
                breaker.record_failure()
                self._m_failover.inc(1, name, "crash")
                last_error = e
                logger.error("engine %s crashed on %s; failing over",
                             name, block_hash, exc_info=True)
            else:
                breaker.record_success()
                self._m_served.inc(1, name)
                return work
            finally:
                if self._owners.get(block_hash) == (name, backend):
                    del self._owners[block_hash]
        raise WorkError(
            f"all engines failed or open for {block_hash}"
            + (f" (last: {last_error})" if last_error else "")
        )

    async def cancel(self, block_hash: str) -> None:
        owner = self._owners.get(block_hash)
        if owner is not None:
            await owner[1].cancel(block_hash)
            return
        # No recorded owner (cancel raced the failover hop): fan out — the
        # contract is idempotent on every engine.
        for name, backend in self.backends:
            if self._ready.get(name):
                try:
                    await backend.cancel(block_hash)
                except Exception:
                    pass

    async def raise_difficulty(self, block_hash: str, difficulty: int) -> bool:
        owner = self._owners.get(block_hash)
        if owner is None:
            return False
        return await owner[1].raise_difficulty(block_hash, difficulty)
