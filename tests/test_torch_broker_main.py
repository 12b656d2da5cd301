"""The port's standalone broker, ``python -m tpu_dpow_torch.transport``:
twins of tests/test_broker_main.py, plus ``amain`` serving a users file on
both listeners (MQTT and JSON-lines on the TCP port, the websocket face on
``--ws_port``) and ``--help``.
"""

import asyncio
import json
import os
import socket
import subprocess
import sys

from tpu_dpow.transport.__main__ import load_users as jax_load_users
from tpu_dpow_torch.transport import QOS_0, QOS_1
from tpu_dpow_torch.transport import __main__ as broker_main
from tpu_dpow_torch.transport.__main__ import load_users
from tpu_dpow_torch.transport.broker import Broker
from tpu_dpow_torch.transport.mqtt import MqttTransport
from tpu_dpow_torch.transport.tcp import TcpBrokerServer, TcpTransport
from tpu_dpow_torch.transport.ws import WsTransport

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEMPLATE = os.path.join(REPO, "setup", "broker", "users.json")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_load_users_skips_comment_keys(tmp_path):
    path = tmp_path / "users.json"
    path.write_text(json.dumps({
        "_comment": "ignored",
        "alice": {"password": "pw", "acl_pub": ["work/#"], "acl_sub": ["result/#"]},
    }))
    users = load_users(str(path))
    assert set(users) == {"alice"}
    assert users["alice"].password == "pw"
    assert users["alice"].acl_pub == ("work/#",)
    assert users["alice"].acl_sub == ("result/#",)


def test_shipped_users_template_parses():
    users = load_users(TEMPLATE)
    assert {"dpowserver", "client", "dpowinterface"} <= set(users)
    assert "work/#" in users["dpowserver"].acl_pub
    assert "result/#" in users["client"].acl_pub
    assert users["dpowinterface"].acl_pub == ()
    # The same template, read by both packages, gives the same users.
    want = jax_load_users(TEMPLATE)
    assert {k: vars(u) for k, u in users.items()} == {k: vars(u) for k, u in want.items()}


def test_broker_with_users_file_end_to_end(tmp_path):
    """Boot a TCP broker from a users file; pub/sub through it."""
    path = tmp_path / "users.json"
    path.write_text(json.dumps({
        "srv": {"password": "s", "acl_pub": ["work/#"], "acl_sub": ["result/#"]},
        "wrk": {"password": "w", "acl_pub": ["result/#"], "acl_sub": ["work/#"]},
    }))

    async def run():
        server = TcpBrokerServer(Broker(users=load_users(str(path))), host="127.0.0.1", port=0)
        await server.start()
        try:
            srv = TcpTransport.from_uri(f"tcp://srv:s@127.0.0.1:{server.port}", client_id="srv")
            wrk = TcpTransport.from_uri(f"tcp://wrk:w@127.0.0.1:{server.port}", client_id="wrk")
            await srv.connect()
            await wrk.connect()
            await wrk.subscribe("work/#", QOS_0)
            await asyncio.sleep(0.05)
            await srv.publish("work/ondemand", "AB,ffffffc000000000", QOS_0)
            msg = await asyncio.wait_for(anext(aiter(wrk.messages())), 2)
            assert (msg.topic, msg.payload) == ("work/ondemand", "AB,ffffffc000000000")
            await srv.close()
            await wrk.close()
        finally:
            await server.stop()

    asyncio.run(run())


def test_amain_serves_mqtt_json_and_ws_from_a_users_file(tmp_path):
    """The entry point with ``--users``, ``--port`` and ``--ws_port``: an
    MQTT publisher and a JSON-lines subscriber share the TCP port, a
    websocket subscriber the second one; credentials outside the file are
    refused; cancelling ``amain`` stops both listeners."""
    path = tmp_path / "users.json"
    path.write_text(json.dumps({
        "_comment": "test",
        "srv": {"password": "s", "acl_pub": ["work/#"], "acl_sub": ["result/#"]},
        "wrk": {"password": "w", "acl_pub": ["result/#"], "acl_sub": ["work/#"]},
    }))
    port, ws_port = free_port(), free_port()

    async def run():
        task = asyncio.ensure_future(broker_main.amain([
            "--host", "127.0.0.1", "--port", str(port), "--ws_port", str(ws_port),
            "--ws_path", "/mqtt", "--users", str(path)]))
        srv = MqttTransport(port=port, username="srv", password="s", client_id="srv")
        for _ in range(100):
            try:
                await srv.connect()
                break
            except Exception:
                await asyncio.sleep(0.05)
        try:
            js = TcpTransport(port=port, username="wrk", password="w", client_id="js")
            ws = WsTransport.from_uri(f"ws://wrk:w@127.0.0.1:{ws_port}/mqtt", client_id="ws")
            await js.connect()
            await ws.connect()
            await js.subscribe("work/#", QOS_1)
            await ws.subscribe("work/#", QOS_1)
            await asyncio.sleep(0.05)
            await srv.publish("work/ondemand", "EF,fffffff800000000", QOS_1)
            for t in (js, ws):
                msg = await asyncio.wait_for(anext(aiter(t.messages())), 5)
                assert (msg.topic, msg.payload) == ("work/ondemand", "EF,fffffff800000000")
            bad = MqttTransport(port=port, username="client", password="client",
                                client_id="x", reconnect_retries=1)
            try:
                await bad.connect()
                raise AssertionError("a user outside the users file was let in")
            except Exception as e:
                assert type(e).__name__ == "AuthError"
            await bad.close()
            for t in (js, ws, srv):
                await t.close()
        finally:
            task.cancel()
            await asyncio.gather(task, return_exceptions=True)
        # Both listeners are gone.
        for p in (port, ws_port):
            try:
                _r, w = await asyncio.open_connection("127.0.0.1", p)
                w.close()
                raise AssertionError(f"port {p} still open")
            except OSError:
                pass

    asyncio.run(asyncio.wait_for(run(), 30))


def test_broker_entry_point_help_exits_zero():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-m", "tpu_dpow_torch.transport", "--help"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    for flag in ("--host", "--port", "--ws_port", "--ws_path", "--users"):
        assert flag in out.stdout
