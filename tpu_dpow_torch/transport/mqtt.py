"""MQTT 3.1.1 faces of the broker: server handler + client transport.

Server side: ``handle_mqtt_conn`` serves one MQTT connection against the
shared Broker core (transport/broker.py) — the reference's Mosquitto seam
(reference server/setup/mosquitto/dpow.conf, acls:1-33) becomes a protocol
face of the same broker that already speaks JSON-lines and websockets, so
stock paho/hbmqtt clients and dashboards connect unmodified. The TCP server
(transport/tcp.py) sniffs the first byte of each connection and routes MQTT
CONNECT (0x10) here, everything else to the JSON-lines handler: ONE port
(1883) serves both, exactly where the reference ecosystem expects MQTT.

Client side: ``MqttTransport`` speaks MQTT wire instead of JSON frames by
overriding TcpTransport's frame layer only — reconnect/backoff, QoS-1 ack
futures, subscription replay and the inbox all come from the parent. It
connects equally to this broker or to a stock Mosquitto, which restores the
reference's deployment option of an external C broker
(SURVEY.md §2.4 item 2).

Delivery semantics match the rest of the transport package: QoS 1 is
at-least-once INTO the broker (PUBACK from the broker); onward delivery
rides the broker's persistent session queues (clean_session=False +
reconnect replay), not per-packet retransmit timers.
"""

from __future__ import annotations

import asyncio
import itertools
import logging
from typing import Optional

from . import AuthError, QOS_1, TransportError
from .broker import Broker, Session
from .tcp import TcpTransport
from . import mqtt_codec as mc

logger = logging.getLogger(__name__)

_ids = itertools.count()

# Outbound QoS-1 in-flight window per connection (Mosquitto max_inflight
# analog). Far below the 65000-mid wrap, so a reused mid can never collide
# with one still awaiting its PUBACK.
MAX_INFLIGHT_QOS1 = 256


async def handle_mqtt_conn(
    broker: Broker,
    reader: asyncio.StreamReader,
    writer,  # StreamWriter or any write()/drain() shim (websocket face)
    first_byte: Optional[bytes],
) -> None:
    """Serve one MQTT connection.

    ``first_byte``: the fixed-header byte a protocol-sniffing caller already
    consumed (transport/tcp.py), or None when the stream still holds it
    (transport/ws.py feeds whole frames into its reader).
    """
    session: Optional[Session] = None
    my_queue = None  # the queue THIS connection installed at attach
    pump: Optional[asyncio.Task] = None
    out_mid = itertools.count(1)
    # Outbound QoS-1 PUBLISHes awaiting the client's PUBACK, mid → Message
    # (insertion-ordered). Whatever is still here when the connection dies
    # is requeued for redelivery — the per-packet at-least-once leg that
    # the reference's client depends on from Mosquitto for cancels
    # (reference client/dpow_client.py:143-147). The in-flight window is
    # capped (Mosquitto's max_inflight): a client that answers pings but
    # never PUBACKs would otherwise grow this without bound, and after the
    # 16-bit mid counter wraps a reused mid would silently evict a
    # still-outstanding message from redelivery tracking.
    unacked: dict = {}
    ack_space = asyncio.Event()
    ack_space.set()

    def send(pkt) -> None:
        writer.write(mc.encode(pkt))

    async def pump_session(queue: asyncio.Queue) -> None:
        # Captured queue, not session.queue: after a session takeover a
        # newer connection owns a fresh queue (see broker.attach), and this
        # pump gets a None poison pill on its own.
        try:
            while True:
                msg = await queue.get()
                if msg is None:
                    break
                mid = None
                if msg.qos > 0:
                    while len(unacked) >= MAX_INFLIGHT_QOS1:
                        # Flow control: hold QoS-1 delivery until acks
                        # drain the window (new messages keep queuing in
                        # the bounded session queue meanwhile).
                        ack_space.clear()
                        await ack_space.wait()
                    mid = next(out_mid) % 65000 + 1  # u16, nonzero: wrap
                    # Record BEFORE the write: a drop inside drain() must
                    # still count this message as outstanding.
                    unacked[mid] = msg
                send(
                    mc.Publish(
                        topic=msg.topic,
                        payload=msg.payload.encode("utf-8"),
                        qos=msg.qos,
                        mid=mid,
                        dup=msg.dup,
                    )
                )
                await writer.drain()
        except (ConnectionError, asyncio.CancelledError):
            pass

    keepalive = 60
    try:
        pkt = await mc.read_packet(reader, first_byte)
        if not isinstance(pkt, mc.Connect):
            return
        keepalive = pkt.keepalive  # 0 = client disabled keepalive (§3.1.2.10)
        try:
            session = broker.attach(
                pkt.client_id or f"mqtt-{next(_ids)}",
                pkt.username or "",
                pkt.password or "",
                pkt.clean_session,
            )
        except AuthError:
            send(mc.Connack(return_code=mc.CONNACK_BAD_CREDENTIALS))
            await writer.drain()
            return
        my_queue = session.queue
        # Session-present: an existing durable session was resumed.
        resumed = not pkt.clean_session and bool(session.subscriptions)
        send(mc.Connack(return_code=mc.CONNACK_ACCEPTED, session_present=resumed))
        await writer.drain()
        pump = asyncio.ensure_future(pump_session(my_queue))

        while True:
            timeout = keepalive * 1.5 if keepalive else None
            try:
                pkt = await asyncio.wait_for(mc.read_packet(reader), timeout)
            except asyncio.TimeoutError:
                logger.debug("mqtt keepalive expired for %s", session.client_id)
                break
            if pkt is None or isinstance(pkt, mc.Disconnect):
                break
            if isinstance(pkt, mc.Pingreq):
                send(mc.Pingresp())
            elif isinstance(pkt, mc.Puback):
                unacked.pop(pkt.mid, None)
                ack_space.set()  # wake a flow-control-parked pump
            elif isinstance(pkt, mc.Publish):
                payload = pkt.payload.decode("utf-8", errors="replace")
                try:
                    broker.publish(session, pkt.topic, payload, pkt.qos)
                except AuthError:
                    # 3.1.1 has no per-publish NACK; denial = drop (exactly
                    # mosquitto's ACL behavior).
                    logger.debug(
                        "denied publish to %s by %s", pkt.topic, session.username
                    )
                if pkt.qos >= QOS_1 and pkt.mid is not None:
                    send(mc.Puback(mid=pkt.mid))
            elif isinstance(pkt, mc.Subscribe):
                codes = []
                for pattern, qos in pkt.topics:
                    try:
                        broker.subscribe(session, pattern, min(qos, QOS_1))
                        codes.append(min(qos, QOS_1))
                    except AuthError:
                        codes.append(mc.SUBACK_FAILURE)
                send(mc.Suback(mid=pkt.mid, codes=codes))
            elif isinstance(pkt, mc.Unsubscribe):
                for pattern in pkt.topics:
                    broker.unsubscribe(session, pattern)
                send(mc.Unsuback(mid=pkt.mid))
            await writer.drain()
    except (
        ConnectionError,
        asyncio.IncompleteReadError,
        mc.MqttCodecError,
    ) as e:
        logger.debug("mqtt connection ended: %r", e)
    finally:
        if pump is not None:
            pump.cancel()
        if session is not None:
            broker.detach(session, my_queue)
            if unacked:
                # Sent-but-unacked QoS-1 deliveries go back FIRST (they are
                # older than the queue remnant detach just salvaged).
                broker.requeue(session, list(unacked.values()))


class MqttTransport(TcpTransport):
    """MQTT 3.1.1 client endpoint (this broker or a stock Mosquitto).

    Built by swapping TcpTransport's JSON frame layer for MQTT packets; all
    connection management (backoff reconnect, subscription replay, ack
    futures, bounded inbox) is inherited.
    """

    SCHEMES = ("mqtt",)

    #: keepalive declared in CONNECT; the pinger sends PINGREQ at half this
    #: so an idle subscriber (a worker listening for work/#) is never
    #: dropped by this broker's — or Mosquitto's — 1.5x inactivity cutoff.
    KEEPALIVE = 60.0

    _sub_mid = None  # lazy counter for SUBSCRIBE/UNSUBSCRIBE packet ids
    _ping_task: Optional[asyncio.Task] = None

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._sub_mids: dict = {}  # pending SUBSCRIBE mid → pattern

    async def _connect_once(self) -> None:
        # Mids from SUBSCRIBEs whose SUBACK never arrived died with the old
        # connection — reconnect replays subscriptions under fresh mids, and
        # the replayed SUBACKs resolve waits by pattern, so stale entries
        # would only leak and could mis-resolve after the 16-bit mid wraps.
        self._sub_mids.clear()
        await super()._connect_once()
        if self._ping_task is None or self._ping_task.done():
            self._ping_task = asyncio.ensure_future(self._ping_loop())

    async def _ping_loop(self) -> None:
        while not self._closed:
            await self._sleep(self.KEEPALIVE / 2)
            if self._closed:
                return
            if self._connected:
                try:
                    await self._send({"op": "ping"})
                except Exception:
                    pass  # the rx loop owns drop detection / reconnect

    async def close(self) -> None:
        if self._ping_task is not None:
            self._ping_task.cancel()
            self._ping_task = None
        await super().close()

    def _next_sub_mid(self) -> int:
        if self._sub_mid is None:
            self._sub_mid = itertools.count(1)
        return next(self._sub_mid) % 65535 + 1

    async def _send(self, obj: dict) -> None:
        if self._writer is None:
            raise TransportError("not connected")
        op = obj["op"]
        if op == "connect":
            pkt = mc.Connect(
                client_id=obj["client_id"],
                username=obj["username"] or None,
                password=obj["password"] or None,
                clean_session=obj["clean_session"],
                keepalive=int(self.KEEPALIVE),
            )
        elif op == "pub":
            pkt = mc.Publish(
                topic=obj["topic"],
                payload=obj["payload"].encode("utf-8"),
                qos=obj["qos"],
                mid=obj.get("mid"),
            )
        elif op == "sub":
            mid = self._next_sub_mid()
            # Remember which pattern this mid subscribed, so the SUBACK's
            # per-topic code can resolve the pattern-keyed wait in
            # TcpTransport.subscribe (JSON-face parity: denial raises).
            self._sub_mids[mid] = obj["pattern"]
            pkt = mc.Subscribe(mid=mid, topics=[(obj["pattern"], obj["qos"])])
        elif op == "unsub":
            pkt = mc.Unsubscribe(mid=self._next_sub_mid(), topics=[obj["pattern"]])
        elif op == "ping":
            pkt = mc.Pingreq()
        else:
            raise TransportError(f"cannot express {op!r} in MQTT")
        self._writer.write(mc.encode(pkt))
        await self._writer.drain()

    async def _read_frame(self) -> Optional[dict]:
        while True:
            if self._reader is None:
                return None
            try:
                pkt = await mc.read_packet(self._reader)
            except mc.MqttCodecError as e:
                # Undecodable stream = broken session: treat as a drop so
                # the rx loop reconnects instead of dying.
                logger.warning("mqtt stream error: %s", e)
                return None
            if pkt is None:
                return None
            if isinstance(pkt, mc.Connack):
                if pkt.return_code == mc.CONNACK_ACCEPTED:
                    return {"op": "connack"}
                return {"op": "error", "reason": f"bad credentials (rc={pkt.return_code})"}
            if isinstance(pkt, mc.Publish):
                if pkt.qos >= QOS_1 and pkt.mid is not None:
                    self._writer.write(mc.encode(mc.Puback(mid=pkt.mid)))
                return {
                    "op": "msg",
                    "topic": pkt.topic,
                    "payload": pkt.payload.decode("utf-8", errors="replace"),
                    "qos": pkt.qos,
                }
            if isinstance(pkt, mc.Puback):
                return {"op": "puback", "mid": pkt.mid}
            if isinstance(pkt, mc.Pingresp):
                return {"op": "pong"}
            if isinstance(pkt, mc.Suback):
                pattern = self._sub_mids.pop(pkt.mid, None)
                if pattern is None:
                    continue  # replayed/unknown mid: nothing waiting
                if pkt.codes and pkt.codes[0] == mc.SUBACK_FAILURE:
                    return {"op": "error", "reason": f"subscription denied: {pattern!r}",
                            "pattern": pattern}
                return {"op": "suback", "pattern": pattern}
            if isinstance(pkt, mc.Unsuback):
                continue
            logger.debug("ignoring mqtt packet %r", pkt)

    # MQTT publish mids must fit 16 bits; TcpTransport's counter is fine for
    # the JSON face but must wrap here.
    async def publish(self, topic: str, payload: str, qos: int = 0) -> None:
        if qos >= QOS_1:
            # Wrap the shared counter into the u16 space MQTT requires.
            mid = next(self._mid) % 65000 + 1
            fut = asyncio.get_running_loop().create_future()
            self._acks[mid] = fut
            await self._send({"op": "pub", "topic": topic, "payload": payload,
                              "qos": qos, "mid": mid})
            try:
                await asyncio.wait_for(fut, timeout=10.0)
            except asyncio.TimeoutError:
                self._acks.pop(mid, None)
                raise TransportError(f"no puback for publish to {topic}")
        else:
            await TcpTransport.publish(self, topic, payload, qos)
