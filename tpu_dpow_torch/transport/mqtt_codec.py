"""MQTT 3.1.1 packet codec (the subset the dpow data plane uses).

The reference's entire ecosystem speaks MQTT against Mosquitto — hbmqtt in
the server and client (reference server/dpow/mqtt.py, client/dpow_client.py),
paho in the latency probe (reference server/scripts/check_latency.py), and
MQTT-over-websockets dashboards (reference server/setup/mosquitto/dpow.conf).
This codec lets the rebuild's broker accept those clients unmodified and
lets the rebuild's own processes ride a stock Mosquitto: CONNECT/CONNACK,
PUBLISH (QoS 0/1) + PUBACK, SUBSCRIBE/SUBACK, UNSUBSCRIBE/UNSUBACK,
PINGREQ/PINGRESP, DISCONNECT — i.e. everything the topic contract
(docs/specification.md) exercises. Not implemented (and not used by the
contract): QoS 2, retained messages, will messages (parsed, ignored).

Pure functions over bytes; the asyncio faces live in transport/mqtt.py. The
port keeps its own copy so that its packets and its work and result payloads
are byte-identical to ``tpu_dpow``'s.
Packet formats follow MQTT 3.1.1 (OASIS standard, §2-§3).
"""

from __future__ import annotations

import asyncio
import re
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

# Packet types (high nibble of the fixed-header first byte).
CONNECT = 1
CONNACK = 2
PUBLISH = 3
PUBACK = 4
SUBSCRIBE = 8
SUBACK = 9
UNSUBSCRIBE = 10
UNSUBACK = 11
PINGREQ = 12
PINGRESP = 13
DISCONNECT = 14

# CONNACK return codes.
CONNACK_ACCEPTED = 0
CONNACK_BAD_CREDENTIALS = 4
CONNACK_NOT_AUTHORIZED = 5

SUBACK_FAILURE = 0x80

MAX_REMAINING_LEN = 256 * 1024  # sane bound for this protocol's payloads


class MqttCodecError(Exception):
    pass


def _encode_varint(n: int) -> bytes:
    out = bytearray()
    while True:
        byte = n % 128
        n //= 128
        if n:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def _encode_string(s: str) -> bytes:
    b = s.encode("utf-8")
    if len(b) > 0xFFFF:
        raise MqttCodecError("string too long")
    return len(b).to_bytes(2, "big") + b


class _Reader:
    """Cursor over one packet's body."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise MqttCodecError("truncated packet")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def u16(self) -> int:
        return int.from_bytes(self.take(2), "big")

    def string(self) -> str:
        try:
            return self.take(self.u16()).decode("utf-8")
        except UnicodeDecodeError as e:
            # Malformed wire input must surface as a codec error the faces
            # catch (clean CONNACK/refusal), never an unexpected exception
            # class out of the connection handler.
            raise MqttCodecError(f"invalid utf-8 in string: {e}") from e

    def rest(self) -> bytes:
        out = self.data[self.pos :]
        self.pos = len(self.data)
        return out

    @property
    def remaining(self) -> int:
        return len(self.data) - self.pos


def _packet(ptype: int, flags: int, body: bytes) -> bytes:
    return bytes([(ptype << 4) | flags]) + _encode_varint(len(body)) + body


# -- packet dataclasses ----------------------------------------------------


@dataclass
class Connect:
    client_id: str
    username: Optional[str] = None
    password: Optional[str] = None
    clean_session: bool = True
    keepalive: int = 60
    will_topic: Optional[str] = None  # parsed for compatibility; not honored


@dataclass
class Connack:
    return_code: int
    session_present: bool = False


@dataclass
class Publish:
    topic: str
    payload: bytes
    qos: int = 0
    mid: Optional[int] = None
    dup: bool = False
    retain: bool = False


@dataclass
class Puback:
    mid: int


@dataclass
class Subscribe:
    mid: int
    topics: List[Tuple[str, int]] = field(default_factory=list)


@dataclass
class Suback:
    mid: int
    codes: List[int] = field(default_factory=list)


@dataclass
class Unsubscribe:
    mid: int
    topics: List[str] = field(default_factory=list)


@dataclass
class Unsuback:
    mid: int


@dataclass
class Pingreq:
    pass


@dataclass
class Pingresp:
    pass


@dataclass
class Disconnect:
    pass


# -- encoding --------------------------------------------------------------


def encode(pkt) -> bytes:
    if isinstance(pkt, Connect):
        flags = 0x02 if pkt.clean_session else 0x00
        payload = _encode_string(pkt.client_id)
        if pkt.username is not None:
            flags |= 0x80
        if pkt.password is not None:
            flags |= 0x40
        body = (
            _encode_string("MQTT")
            + bytes([4, flags])
            + pkt.keepalive.to_bytes(2, "big")
            + payload
        )
        if pkt.username is not None:
            body += _encode_string(pkt.username)
        if pkt.password is not None:
            body += _encode_string(pkt.password)
        return _packet(CONNECT, 0, body)
    if isinstance(pkt, Connack):
        return _packet(
            CONNACK, 0, bytes([1 if pkt.session_present else 0, pkt.return_code])
        )
    if isinstance(pkt, Publish):
        flags = (0x08 if pkt.dup else 0) | (pkt.qos << 1) | (1 if pkt.retain else 0)
        body = _encode_string(pkt.topic)
        if pkt.qos > 0:
            if pkt.mid is None:
                raise MqttCodecError("qos>0 publish needs a packet id")
            body += pkt.mid.to_bytes(2, "big")
        body += pkt.payload
        return _packet(PUBLISH, flags, body)
    if isinstance(pkt, Puback):
        return _packet(PUBACK, 0, pkt.mid.to_bytes(2, "big"))
    if isinstance(pkt, Subscribe):
        body = pkt.mid.to_bytes(2, "big") + b"".join(
            _encode_string(t) + bytes([q]) for t, q in pkt.topics
        )
        return _packet(SUBSCRIBE, 0x02, body)
    if isinstance(pkt, Suback):
        return _packet(SUBACK, 0, pkt.mid.to_bytes(2, "big") + bytes(pkt.codes))
    if isinstance(pkt, Unsubscribe):
        body = pkt.mid.to_bytes(2, "big") + b"".join(
            _encode_string(t) for t in pkt.topics
        )
        return _packet(UNSUBSCRIBE, 0x02, body)
    if isinstance(pkt, Unsuback):
        return _packet(UNSUBACK, 0, pkt.mid.to_bytes(2, "big"))
    if isinstance(pkt, Pingreq):
        return _packet(PINGREQ, 0, b"")
    if isinstance(pkt, Pingresp):
        return _packet(PINGRESP, 0, b"")
    if isinstance(pkt, Disconnect):
        return _packet(DISCONNECT, 0, b"")
    raise MqttCodecError(f"cannot encode {type(pkt).__name__}")


# -- decoding --------------------------------------------------------------


def decode(first_byte: int, body: bytes):
    """One packet from its fixed-header first byte + body bytes."""
    ptype = first_byte >> 4
    flags = first_byte & 0x0F
    r = _Reader(body)
    if ptype == CONNECT:
        proto = r.string()
        level = r.take(1)[0]
        if proto not in ("MQTT", "MQIsdp") or level not in (3, 4):
            raise MqttCodecError(f"unsupported protocol {proto!r} level {level}")
        cflags = r.take(1)[0]
        keepalive = r.u16()
        client_id = r.string()
        will_topic = None
        if cflags & 0x04:  # will flag: parse (and ignore) topic + message
            will_topic = r.string()
            r.take(r.u16())
        username = r.string() if cflags & 0x80 else None
        password = r.string() if cflags & 0x40 else None
        return Connect(
            client_id=client_id,
            username=username,
            password=password,
            clean_session=bool(cflags & 0x02),
            keepalive=keepalive,
            will_topic=will_topic,
        )
    if ptype == CONNACK:
        ack = r.take(2)
        return Connack(return_code=ack[1], session_present=bool(ack[0] & 1))
    if ptype == PUBLISH:
        qos = (flags >> 1) & 0x03
        if qos > 1:
            raise MqttCodecError("QoS 2 not supported")
        topic = r.string()
        mid = r.u16() if qos > 0 else None
        return Publish(
            topic=topic,
            payload=r.rest(),
            qos=qos,
            mid=mid,
            dup=bool(flags & 0x08),
            retain=bool(flags & 0x01),
        )
    if ptype == PUBACK:
        return Puback(mid=r.u16())
    if ptype == SUBSCRIBE:
        mid = r.u16()
        topics = []
        while r.remaining:
            t = r.string()
            topics.append((t, r.take(1)[0] & 0x03))
        if not topics:
            raise MqttCodecError("empty subscribe")
        return Subscribe(mid=mid, topics=topics)
    if ptype == SUBACK:
        mid = r.u16()
        return Suback(mid=mid, codes=list(r.rest()))
    if ptype == UNSUBSCRIBE:
        mid = r.u16()
        topics = []
        while r.remaining:
            topics.append(r.string())
        return Unsubscribe(mid=mid, topics=topics)
    if ptype == UNSUBACK:
        return Unsuback(mid=r.u16())
    if ptype == PINGREQ:
        return Pingreq()
    if ptype == PINGRESP:
        return Pingresp()
    if ptype == DISCONNECT:
        return Disconnect()
    raise MqttCodecError(f"unsupported packet type {ptype}")


# -- dpow data-plane payload helpers ---------------------------------------
#
# The topic contract's comma-separated payloads (docs/specification.md:
# work = "hash,difficulty", result = "hash,work,client") gain OPTIONAL
# trailing fields: a 16-hex trace id stamping the request through the
# pipeline (tpu_dpow.obs.trace, PR 1), and — on work messages only — a
# nonce-range assignment "start+length" (two 16-hex words joined by '+',
# tpu_dpow.fleet sharded dispatch). Encoding/parsing lives here, next to
# the wire format it extends, so every face (server, client, probes) agrees
# on the grammar. Backward/forward compatible by construction: absent
# fields => None; a peer that predates tracing/sharding parses the leading
# fields unchanged and an unrecognized trailing token is ignored rather
# than rejected — the MQTT packet encoding above is untouched (byte
# goldens hold), and range-free payloads are byte-identical to pre-fleet
# ones. The two trailing tokens are distinguishable by shape alone (16 hex
# chars vs 33 chars with a '+'), so their order on the wire is free.


def _opt_trace(fields: List[str], at: int) -> Optional[str]:
    from ..obs.trace import is_trace_id

    if len(fields) > at and is_trace_id(fields[at]):
        return fields[at]
    return None


#: A nonce-range token: start and length as 16-hex u64 words joined by '+'.
#: length 0 encodes the full 2^64 space (a 2^64 span does not fit a u64).
_RANGE_RE = re.compile(r"^([0-9a-f]{16})\+([0-9a-f]{16})$")

#: (start, length) with length == 0 meaning the full 2^64 span.
NonceRange = Tuple[int, int]


def encode_nonce_range(nonce_range: NonceRange) -> str:
    start, length = nonce_range
    if not (0 <= start < 1 << 64) or not (0 <= length < 1 << 64):
        raise ValueError(f"nonce range out of u64: {nonce_range}")
    return f"{start:016x}+{length:016x}"


def parse_nonce_range(token: str) -> Optional[NonceRange]:
    m = _RANGE_RE.match(token)
    if m is None:
        return None
    return int(m.group(1), 16), int(m.group(2), 16)


def encode_work_payload(
    block_hash: str,
    difficulty: int,
    trace_id: Optional[str] = None,
    nonce_range: Optional[NonceRange] = None,
) -> str:
    base = f"{block_hash},{difficulty:016x}"
    if trace_id:
        base = f"{base},{trace_id}"
    if nonce_range is not None:
        base = f"{base},{encode_nonce_range(nonce_range)}"
    return base


def parse_work_payload(
    payload: str,
) -> Tuple[str, str, Optional[str], Optional[NonceRange]]:
    """-> (block_hash, difficulty_hex, trace_id or None, nonce_range or
    None). Raises ValueError on fewer than two fields (the pre-trace
    contract's minimum). Trailing tokens that are neither a trace id nor a
    range are ignored (forward compatibility, same policy as PR 1)."""
    fields = payload.split(",")
    if len(fields) < 2:
        raise ValueError(f"work payload needs hash,difficulty: {payload!r}")
    from ..obs.trace import is_trace_id

    trace_id: Optional[str] = None
    nonce_range: Optional[NonceRange] = None
    for token in fields[2:]:
        if trace_id is None and is_trace_id(token):
            trace_id = token
        elif nonce_range is None:
            nonce_range = parse_nonce_range(token)
    return fields[0], fields[1], trace_id, nonce_range


def encode_result_payload(
    block_hash: str, work: str, client: str, trace_id: Optional[str] = None
) -> str:
    base = f"{block_hash},{work},{client}"
    return f"{base},{trace_id}" if trace_id else base


def parse_result_payload(payload: str) -> Tuple[str, str, str, Optional[str]]:
    """-> (block_hash, work, client, trace_id or None). Raises ValueError
    on fewer than three fields."""
    fields = payload.split(",")
    if len(fields) < 3:
        raise ValueError(f"result payload needs hash,work,client: {payload!r}")
    return fields[0], fields[1], fields[2], _opt_trace(fields, 3)


async def read_packet(reader: asyncio.StreamReader, first_byte: Optional[bytes] = None):
    """One packet off an asyncio stream; returns None on clean EOF.

    ``first_byte`` lets a protocol-sniffing server hand over the byte it
    already consumed (transport/tcp.py auto-detects MQTT vs JSON-lines on
    one port).
    """
    if first_byte is None:
        first_byte = await reader.read(1)
        if not first_byte:
            return None
    # Remaining-length varint: up to 4 bytes.
    mult, length = 1, 0
    for _ in range(4):
        b = await reader.readexactly(1)
        length += (b[0] & 0x7F) * mult
        if not b[0] & 0x80:
            break
        mult *= 128
    else:
        raise MqttCodecError("malformed remaining length")
    if length > MAX_REMAINING_LEN:
        raise MqttCodecError(f"packet too large ({length} bytes)")
    body = await reader.readexactly(length) if length else b""
    return decode(first_byte[0], body)
