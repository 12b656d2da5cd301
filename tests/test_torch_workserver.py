"""The port's work server over aiohttp, driven by the JAX package's client.

Mirrors tests/test_workserver.py: ``tpu_dpow_torch.workserver.WorkServer``
speaks the nano-work-server HTTP JSON-RPC, and ``tpu_dpow``'s
``SubprocessWorkBackend`` drives it as a client, so one test covers both
sides of the wire contract with the port's engine (plain version, CPU)
underneath. The port's own ``SubprocessWorkBackend`` drives it over the
native engine, and ``WorkServerProcess`` stops cooperative and
SIGTERM-ignoring children within its graces.
"""

import asyncio
import shutil
import sys
import time

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


@pytest.mark.skipif(shutil.which("g++") is None, reason="no C++ toolchain")
def test_workserver_with_native_backend():
    async def run():
        from tpu_dpow_torch.backend.native_backend import NativeWorkBackend
        from tpu_dpow_torch.backend.subprocess_backend import (
            SubprocessWorkBackend as PortSubprocessWorkBackend,
        )
        from tpu_dpow_torch.models import WorkRequest as PortWorkRequest

        server = WorkServer(NativeWorkBackend(threads=1, chunk=1 << 16), port=0)
        await server.start()
        clients = [PortSubprocessWorkBackend(uri=f"127.0.0.1:{server.port}"),
                   SubprocessWorkBackend(uri=f"http://127.0.0.1:{server.port}")]
        try:
            for client, request in zip(clients, (PortWorkRequest, WorkRequest)):
                await client.setup()
                h = random_hash()
                work = await client.generate(request(h, EASY))
                nc.validate_work(h, work, EASY)
        finally:
            for client in clients:
                await client.close()
            await server.stop()

    asyncio.run(asyncio.wait_for(run(), timeout=60))


def test_workserver_process_stop_kills_sigterm_ignoring_child():
    """A work-server child that IGNORES terminate is killed within the
    close bound — never awaited forever."""
    from tpu_dpow_torch.workserver import WorkServerProcess

    stubborn = (
        "import signal, time; "
        "signal.signal(signal.SIGTERM, signal.SIG_IGN); "
        "print('up', flush=True); time.sleep(600)"
    )

    async def run():
        mgr = WorkServerProcess([sys.executable, "-c", stubborn],
                                terminate_grace=0.5, kill_grace=10.0)
        await mgr.start()
        assert mgr.pid is not None
        await asyncio.sleep(0.3)  # let the child install its handler
        t0 = time.monotonic()
        confirmed = await mgr.stop()
        elapsed = time.monotonic() - t0
        assert confirmed, "child must be confirmed dead after escalation"
        assert elapsed < 8.0, f"stop() took {elapsed:.1f}s — not bounded"
        assert elapsed >= 0.4, "child ignored SIGTERM; kill escalation ran"
        assert await mgr.stop()  # idempotent: a second stop is a no-op

    asyncio.run(asyncio.wait_for(run(), timeout=60))


def test_workserver_process_stop_cooperative_child_is_fast():
    """A child that honors SIGTERM exits inside terminate_grace — no kill
    escalation, stop() returns promptly."""
    from tpu_dpow_torch.workserver import WorkServerProcess

    async def run():
        mgr = WorkServerProcess([sys.executable, "-c", "import time; time.sleep(600)"],
                                terminate_grace=5.0, kill_grace=5.0)
        await mgr.start()
        await asyncio.sleep(0.2)
        t0 = time.monotonic()
        assert await mgr.stop()
        assert time.monotonic() - t0 < 4.0
        assert mgr.returncode is None  # detached: the handle is gone

    asyncio.run(asyncio.wait_for(run(), timeout=30))


@pytest.mark.skipif(shutil.which("g++") is None, reason="no C++ toolchain")
def test_module_entrypoint_serves_the_native_backend_under_the_process_manager():
    """``python -m tpu_dpow_torch.workserver --backend native --threads 1``
    under ``WorkServerProcess`` answers the port's subprocess client, and
    stops within its graces."""
    import os
    import socket

    from tpu_dpow_torch.backend.subprocess_backend import (
        SubprocessWorkBackend as PortSubprocessWorkBackend,
    )
    from tpu_dpow_torch.models import WorkRequest as PortWorkRequest
    from tpu_dpow_torch.workserver import WorkServerProcess

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    async def run():
        mgr = WorkServerProcess(
            [sys.executable, "-c", f"import sys; sys.path.insert(0, {repo!r}); "
             "from tpu_dpow_torch.workserver.__main__ import main; "
             f"main(['--listen', '127.0.0.1:{port}', '--backend', 'native', '--threads', '1'])"],
            terminate_grace=5.0, kill_grace=5.0)
        await mgr.start()
        client = PortSubprocessWorkBackend(uri=f"http://127.0.0.1:{port}")
        try:
            for _ in range(200):
                try:
                    await client.setup()
                    break
                except Exception:
                    await asyncio.sleep(0.05)
            h = random_hash()
            work = await client.generate(PortWorkRequest(h, EASY))
            nc.validate_work(h, work, EASY)
        finally:
            await client.close()
            t0 = time.monotonic()
            assert await mgr.stop()
            assert time.monotonic() - t0 < 5.0

    asyncio.run(asyncio.wait_for(run(), timeout=60))
