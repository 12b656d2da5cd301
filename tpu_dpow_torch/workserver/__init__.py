"""Standalone work server: the nano-work-server wire protocol over a backend.

Counterpart of ``tpu_dpow/workserver/__init__.py``. The reference vendors a
Rust/OpenCL binary serving HTTP JSON-RPC on 127.0.0.1:7000; this module is
that process around this package's engine, with the same contract —

    {"action": "work_generate", "hash": H, "difficulty": D} → {"work": W, ...}
    {"action": "work_cancel",   "hash": H}                  → {}
    {"action": "work_validate", "hash": H, "work": W, ...}  → {"valid": "0"|"1"}
    anything else                                           → {"error": ...}

so an unmodified nano-work-server client gets GPU-computed work.
"""

from __future__ import annotations

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
