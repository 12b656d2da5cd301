"""HTTP JSON-RPC backend speaking the nano-work-server wire protocol.

Counterpart of ``tpu_dpow/backend/subprocess_backend.py``. Lets the port's
client drive any external worker that implements the reference's
work-server API (reference client/work_handler.py:75-78,104-108; vendored
binary at client/bin): ``work_generate {hash, difficulty} → {work}`` and
``work_cancel {hash}``. Also the client of the port's own standalone work
server (``python -m tpu_dpow_torch.workserver``), closing the compatibility
loop in both directions.
"""

from __future__ import annotations

from typing import Optional

import aiohttp

from ..models import WorkRequest
from . import WorkBackend, WorkCancelled, WorkError


class SubprocessWorkBackend(WorkBackend):
    def __init__(self, uri: str = "http://127.0.0.1:7000", timeout: float = 300.0):
        if not uri.startswith("http"):
            uri = "http://" + uri
        self.uri = uri
        self.timeout = aiohttp.ClientTimeout(total=timeout)
        self._session: Optional[aiohttp.ClientSession] = None

    async def _post(self, payload: dict) -> dict:
        if self._session is None:
            self._session = aiohttp.ClientSession(timeout=self.timeout)
        async with self._session.post(self.uri, json=payload) as resp:
            return await resp.json(content_type=None)

    async def setup(self) -> None:
        # The reference's liveness probe: an invalid action must produce an
        # error reply (client/work_handler.py:50-55).
        try:
            reply = await self._post({"action": "invalid"})
        except Exception as e:
            raise WorkError(f"work server unreachable at {self.uri}: {e}") from e
        if "error" not in reply:
            raise WorkError(f"unexpected probe reply from work server: {reply}")

    async def generate(self, request: WorkRequest) -> str:
        reply = await self._post(
            {
                "action": "work_generate",
                "hash": request.block_hash,
                "difficulty": request.difficulty_hex,
            }
        )
        if "work" not in reply:
            error = reply.get("error", f"malformed reply {reply}")
            if "cancel" in str(error).lower():
                raise WorkCancelled(request.block_hash)
            raise WorkError(f"work_generate failed: {error}")
        return reply["work"]

    async def cancel(self, block_hash: str) -> None:
        try:
            await self._post({"action": "work_cancel", "hash": block_hash})
        except Exception:
            pass  # cancel is advisory, never fatal (reference behavior)

    async def close(self) -> None:
        # Detach-then-await: a concurrent close() must find the slot empty
        # instead of double-closing the session.
        session, self._session = self._session, None
        if session is not None:
            await session.close()
