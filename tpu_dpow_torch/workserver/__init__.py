"""Standalone work server: the nano-work-server wire protocol over a backend.

Counterpart of ``tpu_dpow/workserver/__init__.py``. The reference vendors a
Rust/OpenCL binary serving HTTP JSON-RPC on 127.0.0.1:7000; this module is
that process around this package's engine, with the same contract —

    {"action": "work_generate", "hash": H, "difficulty": D} → {"work": W, ...}
    {"action": "work_cancel",   "hash": H}                  → {}
    {"action": "work_validate", "hash": H, "work": W, ...}  → {"valid": "0"|"1"}
    anything else                                           → {"error": ...}

so an unmodified nano-work-server client gets GPU-computed work (or the
native CPU engine's, ``--backend native``). :class:`WorkServerProcess`
runs such a server as a child process with a bounded teardown.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Optional

from aiohttp import web

from ..backend import WorkBackend, WorkCancelled, WorkError
from ..models import WorkRequest
from ..utils import nanocrypto as nc

logger = logging.getLogger(__name__)


def _difficulty(data: dict) -> int:
    return int(
        nc.validate_difficulty(str(data.get("difficulty", f"{nc.BASE_DIFFICULTY:016x}"))),
        16,
    )


def build_app(backend: WorkBackend) -> web.Application:
    async def handler(request: web.Request) -> web.Response:
        try:
            data = await request.json()
        except Exception:
            return web.json_response({"error": "Bad request (not json)"})
        if not isinstance(data, dict):
            return web.json_response({"error": "Bad request (not json object)"})
        action = data.get("action")
        try:
            if action == "work_generate":
                block_hash = nc.validate_block_hash(str(data.get("hash", "")))
                work = await backend.generate(WorkRequest(block_hash, _difficulty(data)))
                value = nc.work_value(block_hash, work)
                return web.json_response(
                    {
                        "work": work,
                        "difficulty": f"{value:016x}",
                        "multiplier": str(nc.derive_work_multiplier(value)),
                    }
                )
            if action == "work_cancel":
                block_hash = nc.validate_block_hash(str(data.get("hash", "")))
                await backend.cancel(block_hash)
                return web.json_response({})
            if action == "work_validate":
                block_hash = nc.validate_block_hash(str(data.get("hash", "")))
                work = nc.validate_work_hex(str(data.get("work", "")))
                # Only insufficient work is "0"; malformed fields error out
                # above like every other action.
                valid = "1" if nc.work_value(block_hash, work) >= _difficulty(data) else "0"
                return web.json_response({"valid": valid})
            return web.json_response({"error": f"Unknown action: {action!r}"})
        except WorkCancelled:
            return web.json_response({"error": "Cancelled"})
        except ValueError as e:  # includes every nc.Invalid* subclass
            return web.json_response({"error": str(e)})
        except WorkError as e:
            return web.json_response({"error": str(e)})
        except Exception:
            logger.exception("work server internal error")
            return web.json_response({"error": "Internal error"})

    app = web.Application()
    app.router.add_post("/", handler)
    return app


class WorkServerProcess:
    """Managed EXTERNAL work server: spawn a nano-work-server-compatible
    child process (this module's own ``python -m tpu_dpow_torch.workserver``,
    or the reference's vendored binary) and guarantee bounded teardown.

    The close path is the point: ``terminate`` is a polite SIGTERM, but a
    wedged child — stuck in a device call, or simply ignoring the signal —
    must not be awaited forever. ``stop`` escalates to SIGKILL after
    ``terminate_grace`` and bounds the final wait too, so shutdown always
    returns; a child that survives even SIGKILL's wait window (unkillable
    D-state) is abandoned with an error log rather than blocking the
    caller.
    """

    def __init__(
        self,
        argv: list,
        *,
        terminate_grace: float = 5.0,
        kill_grace: float = 5.0,
    ):
        self.argv = list(argv)
        self.terminate_grace = terminate_grace
        self.kill_grace = kill_grace
        self._proc: Optional[asyncio.subprocess.Process] = None

    @property
    def pid(self) -> Optional[int]:
        return self._proc.pid if self._proc is not None else None

    @property
    def returncode(self) -> Optional[int]:
        return self._proc.returncode if self._proc is not None else None

    async def start(self) -> None:
        self._proc = await asyncio.create_subprocess_exec(*self.argv)

    async def stop(self) -> bool:
        """terminate → bounded wait → kill → bounded wait. True when the
        child is confirmed gone; False when it was abandoned still
        running (logged, never awaited forever)."""
        # Detach-then-await: one teardown per child even under concurrent
        # stop() calls.
        proc, self._proc = self._proc, None
        if proc is None or proc.returncode is not None:
            return True
        try:
            proc.terminate()
        except ProcessLookupError:
            return True
        try:
            await asyncio.wait_for(proc.wait(), self.terminate_grace)
            return True
        except asyncio.TimeoutError:
            logger.warning(
                "work server pid %d ignored SIGTERM for %.1fs; killing",
                proc.pid, self.terminate_grace,
            )
        try:
            proc.kill()
        except ProcessLookupError:
            return True
        try:
            await asyncio.wait_for(proc.wait(), self.kill_grace)
            return True
        except asyncio.TimeoutError:
            # Unkillable (D-state) child: abandon it — blocking shutdown
            # on it would be strictly worse. The transport-less orphan is
            # the kernel's to reap.
            logger.error(
                "work server pid %d survived SIGKILL for %.1fs; abandoned",
                proc.pid, self.kill_grace,
            )
            return False


class WorkServer:
    """Embeddable runner: serve a backend on host:port until stopped."""

    def __init__(self, backend: WorkBackend, host: str = "127.0.0.1", port: int = 7000):
        self.backend = backend
        self.host = host
        self.port = port
        self._runner: Optional[web.AppRunner] = None

    async def start(self) -> None:
        await self.backend.setup()
        self._runner = web.AppRunner(build_app(self.backend))
        await self._runner.setup()
        site = web.TCPSite(self._runner, self.host, self.port)
        await site.start()
        for _host, port in self._runner.addresses:  # resolve port 0 → actual
            self.port = port
        logger.info("work server listening on %s:%d", self.host, self.port)

    async def stop(self) -> None:
        # Detach-then-await: one cleanup per runner even under concurrent stops.
        runner, self._runner = self._runner, None
        if runner is not None:
            await runner.cleanup()
        await self.backend.close()
