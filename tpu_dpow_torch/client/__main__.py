"""Worker client entrypoint: ``python -m tpu_dpow_torch.client --payout nano_...``.

Connects to the broker, joins the swarm, and feeds the GPU engine (or the
CPU with ``--device cpu``) with the swarm's work. Also installed as the
``tpu-dpow-torch-client`` script.
"""

from __future__ import annotations

import asyncio
import socket

from .. import obs
from ..transport import transport_from_uri
from ..utils import maybe_init_distributed
from ..utils.logging import get_logger
from .app import DpowClient
from .config import parse_args


async def amain(argv=None) -> None:
    # The interpreter phase ends here: process start -> this entry.
    obs.get_tracer().startup_begin(obs.process_start())
    obs.gcwatch.install()
    maybe_init_distributed()
    config = parse_args(argv)
    get_logger("tpu_dpow_torch.client", file_path=config.log_file)
    # client_id must be stable across restarts (durable session: offline
    # QoS-1 cancel/client replay) but UNIQUE per worker — payout address
    # alone collides when a fleet shares one payout, and the broker's
    # session takeover would then silently mute all but the newest worker.
    # Default adds the hostname; several workers on ONE machine need an
    # explicit --client_id each.
    host_tag = socket.gethostname().replace("/", "-")[:24] or "host"
    client_id = config.client_id or f"client-{config.payout_address[-8:]}-{host_tag}"
    transport = transport_from_uri(
        config.server_uri,
        client_id=client_id,
        clean_session=False,
    )
    client = DpowClient(config, transport)
    try:
        await client.run()
    finally:
        await client.close()


def main(argv=None) -> None:
    try:
        asyncio.run(amain(argv))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
