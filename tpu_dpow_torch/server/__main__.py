"""Server entrypoint: ``python -m tpu_dpow_torch.server [flags]``.

Composition root: config → store → transport (TCP to an external broker, or
an in-process broker when --inproc_broker is set) → DpowServer → aiohttp
apps → node feed. Mirrors reference dpow_server.py:445-515 main().
"""

from __future__ import annotations

import asyncio

from .. import obs
from ..store import get_store
from ..transport import default_users, transport_from_uri
from ..transport.broker import Broker
from ..transport.inproc import InProcTransport
from ..transport.tcp import TcpBrokerServer
from ..utils.logging import get_logger
from .api import ServerRunner
from .app import DpowServer
from .config import parse_args

# NanoWebsocketClient is imported lazily where the node feed is actually
# configured: it needs the optional ``websockets`` package, and a server
# without --node_ws_uri (HTTP-callback precache, or precache off) must not
# die at import time on a box that doesn't ship it.


async def amain(argv=None) -> None:
    obs.gcwatch.install()
    config = parse_args(argv)
    logger = get_logger("tpu_dpow_torch.server", file_path=config.log_file, debug=config.debug)

    # Per-replica broker session id (docs/replication.md): MQTT sessions
    # are keyed by client id, so two replicas sharing the literal "server"
    # would steal each other's subscriptions and queued QoS-1 messages on
    # every (re)connect. One process (replicas == 1) keeps the legacy id.
    client_id = (
        f"server-{config.replica_id}" if config.replicas > 1 else "server"
    )
    broker_server = None
    if config.inproc_broker:
        broker = Broker(users=default_users())
        from urllib.parse import urlparse

        u = urlparse(config.transport_uri)
        broker_server = TcpBrokerServer(broker, host=u.hostname or "127.0.0.1",
                                        port=u.port or 1883)
        await broker_server.start()
        transport = InProcTransport(
            broker, username="dpowserver", password="dpowserver",
            client_id=client_id,
        )
    else:
        transport = transport_from_uri(config.transport_uri, client_id=client_id)

    store = get_store(config.store_uri)
    server = DpowServer(config, store, transport)
    runner = ServerRunner(server, config,
                          broker=broker if config.inproc_broker else None)
    await runner.start()
    logger.info("tpu-dpow server up; service ports %s", runner.ports)

    node_client = None
    if config.enable_precache and config.node_ws_uri:
        from .nano_ws import NanoWebsocketClient

        node_client = NanoWebsocketClient(config.node_ws_uri, server.block_arrival_ws_handler)
        node_client.start()

    try:
        await asyncio.Event().wait()
    except (KeyboardInterrupt, asyncio.CancelledError):
        pass
    finally:
        if node_client:
            await node_client.stop()
        await runner.stop()
        if broker_server:
            await broker_server.stop()


def main(argv=None) -> None:
    try:
        asyncio.run(amain(argv))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
