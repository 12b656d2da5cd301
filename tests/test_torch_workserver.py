"""The port's work server over aiohttp, driven by the JAX package's client.

Mirrors tests/test_workserver.py: ``tpu_dpow_torch.workserver.WorkServer``
speaks the nano-work-server HTTP JSON-RPC, and ``tpu_dpow``'s
``SubprocessWorkBackend`` drives it as a client, so one test covers both
sides of the wire contract with the port's engine (plain version, CPU)
underneath.
"""

import asyncio

import numpy as np
import pytest

from tpu_dpow.backend import WorkCancelled as ClientCancelled
from tpu_dpow.backend import WorkError as ClientError
from tpu_dpow.backend.subprocess_backend import SubprocessWorkBackend
from tpu_dpow.models import WorkRequest
from tpu_dpow_torch.backend.torch_backend import TorchWorkBackend
from tpu_dpow_torch.utils import nanocrypto as nc
from tpu_dpow_torch.workserver import WorkServer

RNG = np.random.default_rng(19)
EASY = 0xFFF0000000000000
HARD = 0xFFFFFFFFFFFFF000


def random_hash() -> str:
    return RNG.bytes(32).hex().upper()


async def serve():
    server = WorkServer(TorchWorkBackend(device="cpu"), port=0)
    await server.start()
    client = SubprocessWorkBackend(uri=f"http://127.0.0.1:{server.port}")
    return server, client


def test_roundtrip_generate_and_validate():
    async def run():
        server, client = await serve()
        try:
            await client.setup()  # invalid-action probe must yield an error
            h = random_hash()
            work = await client.generate(WorkRequest(h, EASY))
            nc.validate_work(h, work, EASY)
            reply = await client._post(
                {"action": "work_generate", "hash": h, "difficulty": f"{EASY:016x}"}
            )
            assert int(reply["difficulty"], 16) == nc.work_value(h, reply["work"]) >= EASY
            assert float(reply["multiplier"]) > 0
            good = await client._post(
                {"action": "work_validate", "hash": h, "work": work,
                 "difficulty": f"{EASY:016x}"}
            )
            assert good["valid"] == "1"
            bad = await client._post(
                {"action": "work_validate", "hash": h, "work": "0" * 16,
                 "difficulty": f"{EASY:016x}"}
            )
            assert bad["valid"] == "0"
        finally:
            await client.close()
            await server.stop()

    asyncio.run(asyncio.wait_for(run(), timeout=60))


def test_cancel_over_the_wire():
    async def run():
        server, client = await serve()
        try:
            h = random_hash()
            task = asyncio.ensure_future(client.generate(WorkRequest(h, HARD)))
            await asyncio.sleep(0.3)
            await client.cancel(h)
            with pytest.raises((ClientCancelled, ClientError)):
                await asyncio.wait_for(task, timeout=10)
        finally:
            await client.close()
            await server.stop()

    asyncio.run(asyncio.wait_for(run(), timeout=60))


def test_bad_requests_get_error_replies():
    async def run():
        server, client = await serve()
        try:
            for payload in (
                {"action": "work_generate", "hash": "zz"},
                {"action": "work_generate"},
                {"action": "work_validate", "hash": "00" * 32, "work": "xyz"},
                {"action": "nope"},
                {},
            ):
                reply = await client._post(payload)
                assert "error" in reply, payload
        finally:
            await client.close()
            await server.stop()

    asyncio.run(asyncio.wait_for(run(), timeout=60))


def test_module_entrypoint_parses_listen():
    from tpu_dpow_torch.workserver import __main__ as entry

    with pytest.raises(SystemExit):
        entry.main(["--listen", "no-port-here"])
