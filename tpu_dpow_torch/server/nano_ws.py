"""Nano node websocket client: the precache feed.

Parity with reference server/dpow/nano_websocket.py: subscribe to the
``confirmation`` topic with ack, forward every confirmed block to the
callback, reconnect forever on drop (reference :40-49 reconnects every 30 s;
here with capped exponential backoff).
"""

from __future__ import annotations

import asyncio
import json
from typing import Awaitable, Callable, Optional

try:  # gated: this environment may not ship the websockets package —
    # the client is still constructible (and fully testable) with an
    # injected ``connect`` factory.
    import websockets
except ImportError:  # pragma: no cover - depends on the environment
    websockets = None

from ..utils.logging import get_logger

logger = get_logger("tpu_dpow_torch.server")


class NanoWebsocketClient:
    def __init__(
        self,
        uri: str,
        callback: Callable[[dict], Awaitable[None]],
        *,
        reconnect_interval: float = 30.0,
        connect: Optional[Callable] = None,
        sleep: Optional[Callable[[float], Awaitable[None]]] = None,
    ):
        self.uri = uri
        self.callback = callback
        self.reconnect_interval = reconnect_interval
        # Injectable seams: tests hand in a scripted connection factory and
        # a recording sleep, so the reconnect-backoff schedule is assertable
        # without a real node or a single real sleep.
        if connect is None:
            if websockets is None:
                raise RuntimeError(
                    "the websockets package is not installed; pass an "
                    "explicit connect= factory"
                )
            connect = websockets.connect
        self._connect = connect
        self._sleep = sleep or asyncio.sleep
        self._task: Optional[asyncio.Task] = None
        self._stopped = False

    async def _subscribe(self, ws) -> None:
        await ws.send(
            json.dumps({"action": "subscribe", "topic": "confirmation", "ack": True})
        )
        reply = json.loads(await ws.recv())
        if reply.get("ack") != "subscribe":
            raise ConnectionError(f"unexpected subscribe ack: {reply}")
        logger.info("subscribed to node confirmations at %s", self.uri)

    async def _run(self) -> None:
        delay = 1.0
        while not self._stopped:
            try:
                async with self._connect(self.uri) as ws:
                    await self._subscribe(ws)
                    async for raw in ws:
                        # Reset backoff only once the FEED is proven live —
                        # resetting after the subscribe ack would let a node
                        # that accepts, acks, and immediately closes pin the
                        # delay at its floor forever, never reaching the cap.
                        delay = 1.0
                        # Message-level problems must not tear down a healthy
                        # socket (that loses every confirmation in the
                        # reconnect backoff window) — and a failing HANDLER
                        # must not masquerade as a bad node frame, or the
                        # operator debugs the feed instead of the handler.
                        try:
                            data = json.loads(raw)
                            message = (
                                data["message"]
                                if data.get("topic") == "confirmation"
                                else None
                            )
                        except Exception:
                            logger.warning(
                                "bad node frame skipped: %.120r", raw, exc_info=True
                            )
                            continue
                        if message is None:
                            continue
                        try:
                            await self.callback(message)
                        except Exception:
                            logger.error(
                                "confirmation handler failed for %s",
                                message.get("hash") if isinstance(message, dict)
                                else message,
                                exc_info=True,
                            )
            except asyncio.CancelledError:
                return
            except Exception as e:
                logger.warning(
                    "node websocket dropped (%s); reconnecting in %.0fs", e, delay
                )
            else:
                # Clean server-side close: without a pause here, a node that
                # accepts + acks + closes would spin a hot reconnect loop.
                logger.info("node websocket closed; reconnecting in %.0fs", delay)
            await self._sleep(delay)
            delay = min(delay * 2, self.reconnect_interval)

    def start(self) -> None:
        self._task = asyncio.ensure_future(self._run())

    async def stop(self) -> None:
        self._stopped = True
        # Detach-then-await (dpowlint DPOW801): concurrent stop() calls
        # must not both cancel/await the same task.
        task, self._task = self._task, None
        if task is not None:
            task.cancel()
            await asyncio.gather(task, return_exceptions=True)
