"""Pub/sub transport: the rebuild's Mosquitto seam.

The reference's data plane is MQTT over an external Mosquitto broker with a
password file and an ACL matrix (reference server/setup/mosquitto/dpow.conf,
acls:1-33; topic contract in docs/specification.md:5-15). This environment
has neither Mosquitto nor an MQTT client library, so the rebuild ships its
own transport with the same semantics behind an injectable interface:

  * MQTT-style topic trees with ``+`` (one level) and ``#`` (rest) wildcards;
  * QoS 0 (at-most-once) and QoS 1 (at-least-once: broker-side per-client
    session queues replayed on reconnect — the property the reference relies
    on by subscribing ``cancel/{type}`` and ``client/{payout}`` at QOS_1
    with cleansession=False, reference client/dpow_client.py:109,143-147);
  * username/password auth with per-user publish/subscribe ACL patterns
    (mirroring the dpowserver/client/dpowinterface matrix);
  * 1 Hz broker-relayed server heartbeat (reference server/dpow/mqtt.py:76-89).

Implementations: in-process (tests, single-process deployments) and TCP
(JSON-lines framing, multi-host). A real MQTT broker can be slotted back in
by implementing Transport against any client library.

This is the port's own copy of ``tpu_dpow/transport/``: the same topics,
ACLs, QoS semantics, JSON-lines frames and MQTT 3.1.1 packets, so a port
endpoint talks to a ``tpu_dpow`` broker and the reverse. Faces: JSON-lines
over TCP (``tcp://``), MQTT 3.1.1 on the same TCP port (``mqtt://``, sniffed
per connection) and websockets carrying either dialect (``ws://``,
``wss://``); ``python -m tpu_dpow_torch.transport`` runs the standalone
broker.
"""

from __future__ import annotations

import abc
import asyncio
from dataclasses import dataclass
from typing import AsyncIterator, Optional

QOS_0 = 0
QOS_1 = 1


@dataclass(frozen=True)
class Message:
    topic: str
    payload: str
    qos: int = QOS_0
    dup: bool = False  # redelivery of a possibly-already-seen QoS-1 message


class TransportError(Exception):
    pass


class AuthError(TransportError):
    pass


def topic_matches(pattern: str, topic: str) -> bool:
    """MQTT matching: '+' = exactly one level, '#' = all remaining levels."""
    p_levels = pattern.split("/")
    t_levels = topic.split("/")
    for i, p in enumerate(p_levels):
        if p == "#":
            return True
        if i >= len(t_levels):
            return False
        if p != "+" and p != t_levels[i]:
            return False
    return len(p_levels) == len(t_levels)


def pattern_covers(grant: str, pattern: str) -> bool:
    """True iff every topic matching ``pattern`` also matches ``grant``.

    The subscription-ACL question: may a user whose grant is ``grant``
    subscribe ``pattern``? Decidable segment-wise for MQTT wildcards —
    unlike matching the two patterns against each other, which wrongly
    admits a pattern BROADER than the grant (e.g. '#' "matches" 'work/#').
    """
    g = grant.split("/")
    s = pattern.split("/")
    i = 0
    while True:
        g_tok = g[i] if i < len(g) else None
        s_tok = s[i] if i < len(s) else None
        if g_tok == "#":
            return True  # grant covers the whole remaining subtree
        if g_tok is None and s_tok is None:
            return True  # both exhausted: identical depth, all covered
        if s_tok == "#":
            # The pattern admits suffixes of every length >= 0 here (MQTT
            # '#' also matches the parent level) — except at i == 0, where
            # the zero-length suffix would be the empty topic, which does
            # not exist. A grant remainder of k '+' segments then '#'
            # covers suffix lengths >= k, so containment holds iff
            # k <= (1 if at top level else 0). k == 0 is the g_tok == '#'
            # case above; k == 1 at top level is e.g. grant '+/#' vs '#'.
            k = 0
            while i + k < len(g) and g[i + k] == "+":
                k += 1
            return i + k < len(g) and g[i + k] == "#" and k <= (1 if i == 0 else 0)
        if g_tok is None or s_tok is None:
            return False  # depth mismatch without a '#' to absorb it
        if g_tok == "+":
            i += 1  # any single segment is covered
            continue
        if s_tok == "+":
            return False  # pattern matches any segment; grant is literal
        if g_tok != s_tok:
            return False
        i += 1


class Transport(abc.ABC):
    """One endpoint's connection to the broker."""

    @abc.abstractmethod
    async def connect(self) -> None: ...

    @abc.abstractmethod
    async def publish(self, topic: str, payload: str, qos: int = QOS_0) -> None: ...

    @abc.abstractmethod
    async def subscribe(self, pattern: str, qos: int = QOS_0) -> None: ...

    @abc.abstractmethod
    async def messages(self) -> AsyncIterator[Message]:
        """Async iterator over inbound messages for this endpoint's
        subscriptions (the reference's message_receive_loop analog,
        server/dpow/mqtt.py:54-74)."""

    @abc.abstractmethod
    async def close(self) -> None: ...

    @property
    @abc.abstractmethod
    def connected(self) -> bool: ...


@dataclass
class User:
    """Broker account with mosquitto-style ACL patterns."""

    password: str
    acl_pub: tuple = ("#",)
    acl_sub: tuple = ("#",)

    def may_publish(self, topic: str) -> bool:
        return any(topic_matches(p, topic) for p in self.acl_pub)

    def may_subscribe(self, pattern: str) -> bool:
        # Allowed iff the requested pattern is no broader than some grant
        # (true containment — matching the patterns against each other
        # would admit e.g. '#' because it "matches" the grant 'work/#').
        return any(pattern_covers(p, pattern) for p in self.acl_sub)

    def may_receive(self, topic: str) -> bool:
        """Delivery-time read check (mosquitto enforces ACLs per delivered
        message too — belt for subscriptions that predate an ACL change or
        rode in on a resumed session)."""
        return any(topic_matches(p, topic) for p in self.acl_sub)


def transport_from_uri(uri: str, **kwargs) -> "Transport":
    """Transport by URI scheme.

    ``mqtt://`` → real MQTT 3.1.1 wire (this broker or a stock Mosquitto);
    ``tcp://``/``dpow://`` → the JSON-lines protocol; ``ws://``/``wss://`` →
    websocket frames.
    """
    from urllib.parse import urlparse

    scheme = urlparse(uri).scheme
    if scheme == "mqtt":
        from .mqtt import MqttTransport

        return MqttTransport.from_uri(uri, **kwargs)
    if scheme in ("tcp", "dpow"):
        from .tcp import TcpTransport

        return TcpTransport.from_uri(uri, **kwargs)
    if scheme in ("ws", "wss"):
        from .ws import WsTransport

        return WsTransport.from_uri(uri, **kwargs)
    raise TransportError(f"unsupported transport scheme {scheme!r}")


# The reference's ACL matrix (server/setup/mosquitto/acls:1-33), transcribed:
# the server writes work/cancel/heartbeat/statistics/client-stats and reads
# results; clients the inverse; the dashboard user reads everything public.
def default_users(server_password: str = "dpowserver", client_password: str = "client") -> dict:
    return {
        "dpowserver": User(
            password=server_password,
            # result/#: addressed result relays between orchestrator
            # replicas (result/{replica}/{type}); replica/#: the
            # forwarded-dispatch lanes replica/dispatch/{id}. Both are
            # server↔server traffic — every replica connects as
            # dpowserver (tpu_dpow.replica, docs/replication.md).
            acl_pub=("work/#", "cancel/#", "heartbeat", "statistics",
                     "client/#", "result/#", "replica/#"),
            # fleet/#: worker capability announces (tpu_dpow.fleet) — an
            # additive grant over the reference matrix.
            acl_sub=("result/#", "fleet/#", "replica/#"),
        ),
        "client": User(
            password=client_password,
            acl_pub=("result/#", "fleet/announce"),
            # work/# already covers the per-worker sharded-dispatch lanes
            # (work/{type}/{worker_id}).
            acl_sub=("work/#", "cancel/#", "heartbeat", "statistics", "client/#"),
        ),
        "dpowinterface": User(
            password="dpowinterface",
            acl_pub=(),
            # Read-everything observer (reference acls gives dpowinterface
            # read on every topic, /root/reference/server/setup/mosquitto/
            # acls:22-31) — the latency probe subscribes work/result/cancel.
            acl_sub=(
                "work/#", "cancel/#", "result/#",
                "statistics", "client/#", "heartbeat", "fleet/#",
            ),
        ),
    }
