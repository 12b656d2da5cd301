"""Standalone broker: ``python -m tpu_dpow_torch.transport [--port ...] [--users ...]``.

The rebuild's deployable stand-in for the reference's Mosquitto process
(reference server/setup/mosquitto/dpow.conf + acls): a pub/sub broker with
the same topic contract, QoS levels, and per-user ACL matrix, but run from
this package instead of an external C daemon. The TCP listener serves BOTH
real MQTT 3.1.1 and the JSON-lines protocol (auto-detected per connection),
and the optional websocket listener likewise serves MQTT-over-websockets
and JSON text frames — stock paho/hbmqtt/mqtt.js clients connect unmodified. Single-host deployments
can skip it entirely (`--inproc_broker` on the server embeds one); this
entrypoint exists for multi-host swarms where workers connect over the
network.

The users file is JSON:

    {"dpowserver": {"password": "...",
                    "acl_pub": ["work/#", "..."],
                    "acl_sub": ["result/#"]}, ...}

Absent a users file, the default dpowserver/client/dpowinterface matrix from
transport.default_users() applies (mirroring reference
server/setup/mosquitto/acls:1-33); see setup/broker/users.json for the
deployable template.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging

from . import User, default_users
from .broker import Broker
from .tcp import TcpBrokerServer


def load_users(path: str) -> dict:
    with open(path) as f:
        raw = json.load(f)
    return {
        name: User(
            password=u["password"],
            acl_pub=tuple(u.get("acl_pub", ())),
            acl_sub=tuple(u.get("acl_sub", ())),
        )
        for name, u in raw.items()
        if not name.startswith("_")  # "_comment" and friends
    }


async def amain(argv=None) -> None:
    p = argparse.ArgumentParser("tpu-dpow-torch broker")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=1883)
    p.add_argument(
        "--ws_port",
        type=int,
        default=None,
        help="also serve the websocket face on this port (browser workers / "
        "dashboards; reference mosquitto websockets listener 9001)",
    )
    p.add_argument("--ws_path", default="/mqtt", help="websocket endpoint path")
    p.add_argument("--users", default=None, help="path to users JSON")
    p.add_argument("--verbose", action="store_true")
    ns = p.parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if ns.verbose else logging.INFO)

    users = load_users(ns.users) if ns.users else default_users()
    broker = Broker(users=users)
    server = TcpBrokerServer(broker, host=ns.host, port=ns.port)
    await server.start()
    ws_server = None
    if ns.ws_port is not None:
        from .ws import WsBrokerServer

        ws_server = WsBrokerServer(
            broker, host=ns.host, port=ns.ws_port, path=ns.ws_path
        )
        await ws_server.start()
    logging.getLogger(__name__).info(
        "broker listening on %s:%d (%d users)", ns.host, ns.port, len(users)
    )
    try:
        await asyncio.Event().wait()
    except (KeyboardInterrupt, asyncio.CancelledError):
        pass
    finally:
        if ws_server is not None:
            await ws_server.stop()
        await server.stop()


def main(argv=None) -> None:
    try:
        asyncio.run(amain(argv))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
