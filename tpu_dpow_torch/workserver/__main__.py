"""``python -m tpu_dpow_torch.workserver [--listen 127.0.0.1:7000] [--device cuda] [--mesh_devices N]``

Drop-in replacement for the reference's vendored nano-work-server binary
(``nano-work-server --gpu 0:0 -l 127.0.0.1:7000``): the same HTTP JSON-RPC
surface, with the work computed by the CUDA kernel on one GPU, or ganged
over a mesh of N (``--mesh_devices``).
"""

from __future__ import annotations

import argparse
import asyncio
import logging

from ..backend import get_backend
from ..utils import maybe_init_distributed
from . import WorkServer


async def amain(argv=None) -> None:
    p = argparse.ArgumentParser("tpu-dpow-torch work server")
    p.add_argument("--listen", "-l", default="127.0.0.1:7000", help="host:port")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda, cuda:N, or cpu (plain PyTorch search)")
    p.add_argument("--mesh_devices", type=int, default=0,
                   help="gang N local devices per hash; 0 = plain "
                   "single-device path")
    p.add_argument("--verbose", action="store_true")
    ns = p.parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if ns.verbose else logging.INFO)
    maybe_init_distributed()

    host, _, port_str = ns.listen.rpartition(":")
    if not port_str.isdigit():
        p.error(f"--listen must be host:port, got {ns.listen!r}")
    # IPv6 literals arrive bracketed ('[::1]:7000'); getaddrinfo wants them bare.
    host = host.strip("[]")
    kwargs = {"mesh_devices": ns.mesh_devices} if ns.mesh_devices > 0 else {}
    server = WorkServer(
        get_backend("torch", device=ns.device, **kwargs), host or "127.0.0.1", int(port_str)
    )
    await server.start()
    try:
        await asyncio.Event().wait()
    except (KeyboardInterrupt, asyncio.CancelledError):
        pass
    finally:
        await server.stop()


def main(argv=None) -> None:
    try:
        asyncio.run(amain(argv))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
