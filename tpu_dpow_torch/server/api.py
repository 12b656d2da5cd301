"""HTTP / websocket faces of the server (reference dpow_server.py:378-500).

Four aiohttp apps, same port layout as the reference:
  * service API     — POST /service/  (port 5030 or a unix socket for nginx)
  * service WS API  — GET /service_ws/ (port 5035, heartbeat 20 s, 2 KB msgs)
  * upchecks        — GET /upcheck/, /upcheck/blocks/ (port 5031)
  * block callback  — POST /block/ (port 5040; node HTTP callback ingestion,
                      the precache feed without a node websocket)
"""

from __future__ import annotations

import asyncio
import datetime
import json
import math
import os
import traceback
from typing import Optional

from aiohttp import WSMsgType, web

from .. import obs
from ..sched import Busy
from ..utils.logging import get_logger
from .app import DpowServer
from .config import ServerConfig
from .exceptions import InvalidRequest, RequestTimeout, RetryRequest

logger = get_logger("tpu_dpow_torch.server")


def _responses_counter():
    return obs.get_registry().counter(
        "dpow_server_responses_total",
        "Service API responses, by outcome", ("outcome",))


async def _handle_service_request(server: DpowServer, data) -> dict:
    request_id = None
    try:
        if not isinstance(data, dict):
            raise InvalidRequest("Bad request (not json)")
        request_id = data.get("id")
        response = await server.service_handler(data)
        _responses_counter().inc(1, "ok")
    except InvalidRequest as e:
        response = {"error": e.reason}
        _responses_counter().inc(1, "invalid")
    except RequestTimeout:
        response = {"error": "Timeout reached without work", "timeout": True}
        _responses_counter().inc(1, "timeout")
    except Busy as e:
        # Admission control said no (window full / shed / hard over-quota,
        # tpu_dpow_torch/sched/). One structured shape on both faces: the POST
        # handler maps it to HTTP 429 + a Retry-After header; websocket
        # callers read the same fields out of this frame.
        response = {
            "error": "Service busy, retry later",
            "busy": True,
            "retry_after": max(1, math.ceil(e.retry_after)),
            # why: "overloaded" / shed reasons / "draining". A draining
            # replica is leaving rotation — clients with a server list
            # (loadgen HttpPostDriver) retry another face immediately
            # instead of backing off.
            "reason": getattr(e, "reason", "overloaded"),
        }
        _responses_counter().inc(1, "busy")
    except RetryRequest:
        response = {"error": "Retry request"}
        _responses_counter().inc(1, "retry")
    except Exception:
        response = {
            "error": "Unknown error, please report the following timestamp "
            f"to the maintainers: {datetime.datetime.now()}"
        }
        _responses_counter().inc(1, "internal_error")
        logger.critical(traceback.format_exc())
    if request_id is not None:
        response["id"] = request_id
    return response


def build_apps(server: DpowServer, broker=None):
    """Returns (service_app, ws_app, upcheck_app, blocks_app)."""

    async def service_post_handler(request: web.Request) -> web.Response:
        try:
            data = await request.json()
        except (ValueError, json.JSONDecodeError):
            return web.json_response({"error": "Bad request (not json)"})
        response = await _handle_service_request(server, data)
        if response.get("busy"):
            # docs/admission.md 429 contract: status + Retry-After header,
            # body carries the same hint for json-only clients.
            return web.json_response(
                response,
                status=429,
                headers={"Retry-After": str(response["retry_after"])},
            )
        return web.json_response(response)

    async def service_ws_handler(request: web.Request) -> web.WebSocketResponse:
        ws = web.WebSocketResponse(heartbeat=20.0, max_msg_size=2048)
        await ws.prepare(request)
        try:
            async for msg in ws:
                if msg.type == WSMsgType.TEXT:
                    try:
                        data = json.loads(msg.data)
                    except json.JSONDecodeError:
                        await ws.send_json({"error": "Bad request (not json)"})
                        continue
                    await ws.send_json(await _handle_service_request(server, data))
        except Exception:
            pass
        return ws

    async def upcheck_handler(request: web.Request) -> web.Response:
        return web.Response(text="up")

    async def upcheck_broker_handler(request: web.Request) -> web.Response:
        # Observability for the embedded broker (SURVEY.md §5.5): message
        # routing counters + live session inventory. 404 when the broker is
        # external (its own tooling owns those numbers then).
        if broker is None:
            raise web.HTTPNotFound()
        sessions = {
            s.client_id: {
                "connected": s.queue is not None,
                "durable": not s.clean,
                "subscriptions": len(s.subscriptions),
                "offline_queued": len(s.offline),
            }
            for s in broker.sessions.values()
        }
        return web.json_response({"stats": broker.stats, "sessions": sessions})

    async def upcheck_blocks_handler(request: web.Request) -> web.Response:
        # `is None`, not falsy: a block stamped at FakeClock t=0.0 is a
        # seen block, not the never-seen sentinel.
        if server.last_block is None:
            return web.Response(text="")
        # Same clock that stamped last_block (block_arrival_handler) — the
        # health face stays truthful under FakeClock tests too.
        return web.Response(text=f"{server.clock.time() - server.last_block:.2f}")

    async def control_get_handler(request: web.Request) -> web.Response:
        return web.json_response(server.control_state())

    async def control_post_handler(request: web.Request) -> web.Response:
        # The autoscaler's levers (docs/loadgen.md): drain / precache
        # shed / fleet horizon. Internal face only — this rides the
        # upcheck port next to /metrics, never the public service port.
        try:
            data = await request.json()
        except (ValueError, json.JSONDecodeError):
            return web.json_response({"error": "Bad request (not json)"},
                                     status=400)
        if not isinstance(data, dict):
            return web.json_response({"error": "Bad request (not object)"},
                                     status=400)
        try:
            state = server.apply_control(data)
        except (TypeError, ValueError) as e:
            return web.json_response({"error": str(e)}, status=400)
        logger.info("control applied: %s -> %s", data, state)
        return web.json_response(state)

    async def block_cb_handler(request: web.Request) -> web.Response:
        try:
            data = await request.json()
            await server.block_arrival_ws_handler(data)
        except Exception:
            logger.error("unable to process block callback:\n%s", traceback.format_exc())
        return web.Response()

    service_app = web.Application()
    service_app.router.add_post("/service/", service_post_handler)
    service_app.router.add_post("/service", service_post_handler)

    ws_app = web.Application()
    ws_app.router.add_get("/service_ws/", service_ws_handler)
    ws_app.router.add_get("/service_ws", service_ws_handler)

    upcheck_app = web.Application()
    upcheck_app.router.add_get("/upcheck/", upcheck_handler)
    upcheck_app.router.add_get("/upcheck", upcheck_handler)
    upcheck_app.router.add_get("/upcheck/blocks/", upcheck_blocks_handler)
    upcheck_app.router.add_get("/upcheck/blocks", upcheck_blocks_handler)
    upcheck_app.router.add_get("/upcheck/broker/", upcheck_broker_handler)
    upcheck_app.router.add_get("/upcheck/broker", upcheck_broker_handler)
    # Autoscaler control face (tpu_dpow_torch/autoscale/, docs/loadgen.md) —
    # on the internal port, like /metrics.
    upcheck_app.router.add_get("/control/", control_get_handler)
    upcheck_app.router.add_get("/control", control_get_handler)
    upcheck_app.router.add_post("/control/", control_post_handler)
    upcheck_app.router.add_post("/control", control_post_handler)
    # Prometheus scrape surface, on the port that is already the internal
    # health face (never the public service port): request/result/dispatch
    # counters, per-stage span histograms, engine + broker internals.
    obs.add_metrics_route(upcheck_app)

    blocks_app = web.Application()
    blocks_app.router.add_post("/block/", block_cb_handler)
    blocks_app.router.add_post("/block", block_cb_handler)

    return service_app, ws_app, upcheck_app, blocks_app


class ServerRunner:
    """Owns the aiohttp runners + the orchestrator's background loops."""

    def __init__(self, server: DpowServer, config: Optional[ServerConfig] = None,
                 *, broker=None):
        self.server = server
        self.config = config or server.config
        self.broker = broker  # embedded-broker observability (optional)
        self._runners: list = []
        self.ports: dict = {}

    async def start(self) -> None:
        await self.server.setup()
        self.server.start_loops()
        service_app, ws_app, upcheck_app, blocks_app = build_apps(self.server, self.broker)
        c = self.config
        specs = [
            ("service", service_app, c.service_port, c.web_path),
            ("service_ws", ws_app, c.service_ws_port, None),
            ("upcheck", upcheck_app, c.upcheck_port, None),
        ]
        if c.enable_precache and not c.node_ws_uri:
            specs.append(("blocks", blocks_app, c.block_cb_port, None))
        for name, app, port, unix_path in specs:
            runner = web.AppRunner(app)
            await runner.setup()
            if unix_path:
                site = web.UnixSite(runner, unix_path)
            else:
                site = web.TCPSite(runner, c.host, port)
            await site.start()
            if unix_path:
                # Group-writable so a reverse proxy running as a different
                # user in the shared group (nginx ↔ server) can connect even
                # when the deployment deviates from the shipped systemd unit
                # (reference hardens this the same way, server/dpow/socket.py:7-30).
                os.chmod(unix_path, 0o660)
            if not unix_path:
                self.ports[name] = site._server.sockets[0].getsockname()[1]
            self._runners.append(runner)

    async def stop(self) -> None:
        for runner in self._runners:
            await runner.cleanup()
        self._runners = []
        await self.server.close()
