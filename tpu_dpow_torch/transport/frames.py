"""Shared frame dispatcher for the broker's network faces (TCP + websocket).

One JSON frame in → zero or more JSON control frames out; the framing
(newline-delimited stream vs websocket text message) is each face's concern,
the protocol is shared — contract documented in transport/tcp.py. This is
the rebuild's analog of Mosquitto serving the same MQTT protocol on its TCP
listener 1883 and its websockets listener 9001 (reference
server/setup/mosquitto/dpow.conf:1-8).
"""

from __future__ import annotations

import itertools
from typing import Callable, Optional

from . import AuthError
from .broker import Broker, Session

_ids = itertools.count()


class FrameConn:
    """Per-connection protocol state machine, transport-agnostic.

    ``handle`` dispatches one inbound frame, emitting replies through
    ``send`` (the face flushes them). It returns False when the connection
    must close (auth failure on connect). After ``handle`` leaves
    ``self.session`` set, the face must start pumping ``session.queue`` to
    the peer as ``{"op": "msg", ...}`` frames.
    """

    def __init__(self, broker: Broker, kind: str = "conn"):
        self.broker = broker
        self.kind = kind
        self.session: Optional[Session] = None
        self.queue = None  # the queue THIS connection installed at attach

    def handle(self, frame: dict, send: Callable[[dict], None]) -> bool:
        try:
            op = frame["op"]
        except Exception:
            send({"op": "error", "reason": "bad frame"})
            return True
        if op == "connect":
            if self.session is not None:
                # A second connect on one socket is a protocol error (as in
                # MQTT): rejecting it keeps exactly one broker session and
                # one pump per connection.
                send({"op": "error", "reason": "already connected"})
                return False
            try:
                self.session = self.broker.attach(
                    str(frame.get("client_id") or f"{self.kind}-{next(_ids)}"),
                    str(frame.get("username", "")),
                    str(frame.get("password", "")),
                    bool(frame.get("clean_session", True)),
                )
            except AuthError as e:
                send({"op": "error", "reason": str(e)})
                return False
            self.queue = self.session.queue
            send({"op": "connack"})
        elif self.session is None:
            send({"op": "error", "reason": "not connected"})
        elif op == "sub":
            try:
                self.broker.subscribe(
                    self.session, str(frame["pattern"]), int(frame.get("qos", 0))
                )
                send({"op": "suback", "pattern": frame["pattern"]})
            except AuthError as e:
                # pattern included so the client can correlate the denial
                # with its pending subscribe instead of just logging it.
                send({"op": "error", "reason": str(e), "pattern": frame["pattern"]})
        elif op == "unsub":
            self.broker.unsubscribe(self.session, str(frame["pattern"]))
        elif op == "pub":
            try:
                self.broker.publish(
                    self.session,
                    str(frame["topic"]),
                    str(frame["payload"]),
                    int(frame.get("qos", 0)),
                )
                if frame.get("mid") is not None:
                    send({"op": "puback", "mid": frame["mid"]})
            except AuthError as e:
                send({"op": "error", "reason": str(e)})
        elif op == "ping":
            send({"op": "pong"})
        else:
            send({"op": "error", "reason": f"unknown op {op!r}"})
        return True

    def detach(self) -> None:
        if self.session is not None:
            self.broker.detach(self.session, self.queue)
            self.session = None
            self.queue = None
