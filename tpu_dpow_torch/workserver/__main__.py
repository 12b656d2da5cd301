"""``python -m tpu_dpow_torch.workserver [--listen 127.0.0.1:7000] [--backend torch|native]``

Drop-in replacement for the reference's vendored nano-work-server binary
(``nano-work-server --gpu 0:0 -l 127.0.0.1:7000``): the same HTTP JSON-RPC
surface, with the work computed by the CUDA kernel on one GPU (``--device
cuda``, the default), ganged over a mesh of N (``--mesh_devices``), or by
the native C++ engine on the host CPU (``--backend native [--threads N]``).
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
    p.add_argument("--backend", default="torch", choices=["torch", "native"])
    p.add_argument("--threads", type=int, default=None,
                   help="native backend thread count")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda, cuda:N, or cpu (plain PyTorch "
                   "search; backend=torch)")
    p.add_argument("--mesh_devices", type=int, default=0,
                   help="gang N local devices per hash; 0 = plain "
                   "single-device path (backend=torch)")
    p.add_argument("--verbose", action="store_true")
    ns = p.parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if ns.verbose else logging.INFO)
    maybe_init_distributed()

    host, _, port_str = ns.listen.rpartition(":")
    if not port_str.isdigit():
        p.error(f"--listen must be host:port, got {ns.listen!r}")
    # IPv6 literals arrive bracketed ('[::1]:7000'); getaddrinfo wants them bare.
    host = host.strip("[]")
    if ns.backend == "native":
        kwargs = {"threads": ns.threads} if ns.threads else {}
    else:
        kwargs = {"device": ns.device}
        if ns.mesh_devices > 0:
            kwargs["mesh_devices"] = ns.mesh_devices
    server = WorkServer(
        get_backend(ns.backend, **kwargs), host or "127.0.0.1", int(port_str)
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
