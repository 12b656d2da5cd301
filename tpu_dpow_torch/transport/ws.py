"""Websocket face for the broker: browser workers and dashboards.

Parity with the reference's MQTT-over-websockets listener on port 9001
(reference server/setup/mosquitto/dpow.conf:7-8) proxied at ``/mqtt/`` by
nginx (reference server/setup/nginx/dpow:9-14), which is what its live MQTT
dashboard rides on (reference server/README.md:133-135). TWO dialects share
the listener, distinguished by the first websocket message:

  * **real MQTT over binary frames** (subprotocol "mqtt") — stock browser
    MQTT clients (mqtt.js & co.) connect exactly as they would to
    Mosquitto's websockets listener; packets bridge into the shared MQTT
    handler (transport/mqtt.py);
  * **JSON text frames** — the same contract as the TCP face
    (transport/tcp.py), one JSON object per message, so a browser can also
    join with the stock ``WebSocket`` API and no MQTT library at all:

    const ws = new WebSocket("wss://host/mqtt/");
    ws.onopen = () => {
      ws.send(JSON.stringify({op: "connect", username: "dpowinterface",
                              password: "..."}));
      ws.send(JSON.stringify({op: "sub", pattern: "statistics"}));
    };
    ws.onmessage = (e) => console.log(JSON.parse(e.data));

Server face: ``WsBrokerServer`` (aiohttp). Client endpoint: ``WsTransport``,
the TCP client with the stream swapped for a websocket — reconnect/backoff,
subscription replay, and QoS-1 puback tracking are inherited unchanged.
"""

from __future__ import annotations

import asyncio
import json
import logging
from typing import Optional

from aiohttp import ClientSession, WSMsgType, web

from . import TransportError
from .broker import Broker
from .frames import FrameConn
from .tcp import TcpTransport

logger = logging.getLogger(__name__)


class WsBrokerServer:
    """Serves a Broker over websockets (aiohttp)."""

    def __init__(
        self,
        broker: Broker,
        host: str = "127.0.0.1",
        port: int = 9001,
        path: str = "/mqtt",
    ):
        self.broker = broker
        self.host = host
        self.port = port
        self.path = path.rstrip("/") or "/mqtt"
        self._runner: Optional[web.AppRunner] = None
        self._conns: set = set()

    async def start(self) -> None:
        app = web.Application()
        # Accept both /mqtt and /mqtt/ — nginx location blocks commonly
        # forward the trailing-slash form (reference setup/nginx/dpow:9).
        app.router.add_get(self.path, self._handle)
        app.router.add_get(self.path + "/", self._handle)
        self._runner = web.AppRunner(app)
        await self._runner.setup()
        site = web.TCPSite(self._runner, self.host, self.port)
        await site.start()
        for server in (site._server,):  # resolve port 0 → actual
            if server is not None and server.sockets:
                self.port = server.sockets[0].getsockname()[1]
        logger.info("ws broker face on %s:%s%s", self.host, self.port, self.path)

    async def stop(self) -> None:
        for ws in list(self._conns):
            await ws.close()
        # Detach-then-await (dpowlint DPOW801): one cleanup per runner
        # even under concurrent stop() calls.
        runner, self._runner = self._runner, None
        if runner is not None:
            await runner.cleanup()

    async def _handle(self, request: web.Request) -> web.WebSocketResponse:
        # protocols=("mqtt",): stock browser MQTT clients (mqtt.js & co.)
        # request the "mqtt" websocket subprotocol, exactly as against
        # Mosquitto's websockets listener (reference
        # server/setup/mosquitto/dpow.conf:7-8).
        ws = web.WebSocketResponse(heartbeat=30, protocols=("mqtt",))
        await ws.prepare(request)
        conn = FrameConn(self.broker, "ws")
        pump: Optional[asyncio.Task] = None
        out: list = []
        self._conns.add(ws)
        try:
            async for msg in ws:
                if msg.type == WSMsgType.BINARY and msg.data[:1] == b"\x10":
                    # MQTT CONNECT in a binary frame: this is a stock MQTT-
                    # over-websockets client, not a JSON one. Bridge the
                    # websocket into the shared MQTT handler via a stream
                    # adapter and let it own the rest of the connection.
                    await self._serve_mqtt(ws, msg.data)
                    break
                if msg.type != WSMsgType.TEXT:
                    break
                try:
                    frame = json.loads(msg.data)
                except Exception:
                    await ws.send_json({"op": "error", "reason": "bad frame"})
                    continue
                keep = conn.handle(frame, out.append)
                for reply in out:
                    await ws.send_json(reply)
                out.clear()
                if not keep:
                    break
                if conn.session is not None and pump is None:
                    pump = asyncio.ensure_future(self._pump(conn.queue, ws))
        except ConnectionError:
            pass
        finally:
            self._conns.discard(ws)
            if pump is not None:
                pump.cancel()
            conn.detach()
            await ws.close()
        return ws

    async def _serve_mqtt(self, ws: web.WebSocketResponse, first: bytes) -> None:
        """One MQTT session over websocket binary frames.

        Reuses the TCP MQTT handler (transport/mqtt.py) through a
        StreamReader fed from websocket messages and a writer shim that
        flushes buffered packet bytes as binary frames.
        """
        from .mqtt import handle_mqtt_conn

        reader = asyncio.StreamReader()
        reader.feed_data(first)

        async def feed() -> None:
            try:
                async for m in ws:
                    if m.type != WSMsgType.BINARY:
                        break
                    # Backpressure: a transportless StreamReader buffers
                    # without bound; don't outrun the MQTT handler.
                    while len(getattr(reader, "_buffer", b"")) > 1 << 20:
                        # dpowlint: disable=DPOW101 — real-socket buffer poll, not a timer; FakeClock cannot drive live websocket I/O
                        await asyncio.sleep(0.02)
                        if reader.at_eof():
                            return
                    reader.feed_data(m.data)
            except ConnectionError:
                pass
            finally:
                reader.feed_eof()

        feeder = asyncio.ensure_future(feed())
        try:
            await handle_mqtt_conn(self.broker, reader, _WsWriterShim(ws), None)
        finally:
            feeder.cancel()

    async def _pump(self, queue: asyncio.Queue, ws: web.WebSocketResponse) -> None:
        # Captured queue, not session.queue: see TcpBrokerServer._pump.
        try:
            while True:
                msg = await queue.get()
                if msg is None:
                    break
                await ws.send_json(
                    {"op": "msg", "topic": msg.topic, "payload": msg.payload, "qos": msg.qos}
                )
        except (ConnectionError, asyncio.CancelledError):
            pass


class _WsWriterShim:
    """StreamWriter-shaped adapter: buffered writes → binary ws frames.

    Implements exactly the surface transport/mqtt.py's handler uses
    (write + drain); each drain ships the accumulated packet bytes as one
    websocket binary message.
    """

    def __init__(self, ws: web.WebSocketResponse):
        self._ws = ws
        self._buf = bytearray()

    def write(self, data: bytes) -> None:
        self._buf += data

    async def drain(self) -> None:
        if self._buf and not self._ws.closed:
            data = bytes(self._buf)
            self._buf.clear()
            await self._ws.send_bytes(data)


class WsTransport(TcpTransport):
    """Reconnecting websocket client endpoint (same protocol as TCP)."""

    def __init__(self, url: str = "ws://127.0.0.1:9001/mqtt", **kwargs):
        super().__init__(**kwargs)
        self.url = url
        self._http: Optional[ClientSession] = None
        self._ws = None
        self._closing: list = []  # detached ws.close() tasks to await in close()

    @classmethod
    def from_uri(cls, uri: str, **kwargs) -> "WsTransport":
        """'ws://user:password@host:port/path' (wss:// for TLS)."""
        from urllib.parse import unquote, urlparse, urlunparse

        u = urlparse(uri)
        if u.scheme not in ("ws", "wss"):
            raise TransportError(f"unsupported websocket scheme {u.scheme!r}")
        netloc = u.hostname or "127.0.0.1"
        if u.port:
            netloc += f":{u.port}"
        url = urlunparse((u.scheme, netloc, u.path or "/mqtt", "", u.query, ""))
        return cls(
            url=url, username=unquote(u.username or ""),
            password=unquote(u.password or ""), **kwargs
        )

    async def _open(self) -> None:
        if self._http is None or self._http.closed:
            self._http = ClientSession()
        self._ws = await self._http.ws_connect(self.url, heartbeat=30)

    async def _send(self, obj: dict) -> None:
        if self._ws is None or self._ws.closed:
            raise TransportError("not connected")
        await self._ws.send_json(obj)

    async def _read_frame(self) -> Optional[dict]:
        if self._ws is None:
            return None
        msg = await self._ws.receive()
        if msg.type != WSMsgType.TEXT:
            return None
        return json.loads(msg.data)

    def _drop_socket(self) -> None:
        self._connected = False
        ws, self._ws = self._ws, None
        if ws is not None and not ws.closed:
            # Mid-run reconnects can only detach the close (sync context);
            # close() awaits every detached task so teardown never races
            # the session's own shutdown or leaks "never retrieved" noise.
            # Prune finished entries here, or a flaky link reconnecting for
            # days accumulates dead Task objects without bound — retrieving
            # each pruned task's exception so asyncio doesn't log it at GC.
            kept = []
            for t in self._closing:
                if t.done():
                    if not t.cancelled():
                        t.exception()
                else:
                    kept.append(t)
            self._closing = kept
            self._closing.append(asyncio.ensure_future(ws.close()))

    async def close(self) -> None:
        await super().close()
        # Detach-then-await (dpowlint DPOW801): a ws teardown task spawned
        # DURING the gather lands in the fresh list instead of being
        # dropped — half-closed sockets must stay awaitable.
        closing, self._closing = self._closing, []
        if closing:
            await asyncio.gather(*closing, return_exceptions=True)
        http, self._http = self._http, None
        if http is not None:
            await http.close()
