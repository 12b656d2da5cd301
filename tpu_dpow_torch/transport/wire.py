"""Binary wire codec v1 for the dpow data-plane payloads.

The v0 payload grammar (transport/mqtt_codec.py) is comma-separated ASCII:
every work/result message re-renders 64-bit integers as hex strings and
every consumer re-parses them with ``str.split`` + ``int(x, 16)`` — per
message, on the dispatch hot path, once per worker lane per tick. This
module is the versioned binary layer behind it (ROADMAP item 5): fixed
width where the field is fixed width (hash, nonce, difficulty, range),
length-prefixed where it is not (payout account), and a one-byte
version/kind header chosen so that the two generations are distinguishable
from the FIRST byte alone:

  * every legacy v0 payload starts with ``[0-9a-fA-F]`` (a hash/nonce hex
    digit) or ``,`` — byte values 0x2C, 0x30-0x39, 0x41-0x46, 0x61-0x66;
  * every v1 frame starts with ``0x10 | kind`` — the 0x10-0x1F control
    range, which no v0 payload can begin with.

So a receiver needs no negotiation to PARSE: ``decode_work_any`` /
``decode_result_any`` route on the first byte and fall through to the v0
parser byte-for-byte unchanged (the v0 goldens in tests/test_wire.py pin
that). Negotiation exists only for SENDING: a fleet worker advertises
``codec: 1`` on its announce (fleet/registry.py records it), the server
emits v1 on that worker's private lane and v0 everywhere the audience is
unknown (broadcast topics), and the worker replies in the codec the
dispatch spoke. Mixed old/new fleets interoperate with zero configuration.

Frames ride the existing ``str``-typed transports as latin-1 byte strings
(every char in U+0000-U+00FF): the in-proc broker passes them through, the
TCP face JSON-escapes them losslessly, and the MQTT face's UTF-8
encode/decode round-trips them exactly.

The WORK_BATCH kind carries up to 255 work items in one frame — one
publish per worker per coordinator flush instead of one per item — and the
client work handler unbatches into the existing engine API. The frame
grammar below is machine-checked against docs/specification.md
(``python -m tpu_dpow.analysis``, DPOW605/606).

Encoding/decoding primitives are deliberately pure and uninstrumented
(benchmarks/codec.py measures them); the ``*_any`` routing helpers and the
senders count into ``dpow_codec_*`` (docs/observability.md).
"""

from __future__ import annotations

import struct
from typing import List, Optional, Sequence, Tuple

from .. import obs
from .mqtt_codec import (
    NonceRange,
    parse_result_payload,
    parse_work_payload,
)

#: One decoded work item: (block_hash, difficulty, trace_id or None,
#: nonce_range or None) — the same field order as parse_work_payload. The
#: difficulty slot is an INT out of the v1 decoder (the wire carries a
#: u64; re-rendering it as hex just for the consumer to re-parse is the
#: exact overhead this codec removes) and a 16-hex STR out of the v0
#: parser; the hash is canonical-lowercase hex out of v1 and as-sent out
#: of v0. Consumers normalize through the models layer
#: (nc.validate_block_hash uppercases; WorkRequest takes the int).
WorkItem = Tuple[str, object, Optional[str], Optional[NonceRange]]

V0 = 0
V1 = 1

#: Version nibble of the v1 header byte (high nibble = 1 ⇒ 0x10-0x1F, the
#: ASCII control range — disjoint from every legacy first byte).
V1_BASE = 0x10

#: v1 frame grammar: kind name → (header byte, body layout). This literal
#: is the code side of the DPOW605/606 contract — the table in
#: docs/specification.md must match it field-for-field, both directions.
#: Layout vocabulary: ``name:N`` = N raw bytes, ``name:u64`` = big-endian
#: 64-bit, ``name:u8`` = one byte, ``name:len8`` = u8 length + that many
#: UTF-8 bytes, ``[...]`` = present iff its flag bit is set,
#: ``work-item{count}`` = ``count`` repetitions of the work body.
FRAME_GRAMMAR = {
    "work": (0x11, "hash:32 difficulty:u64 flags:u8 [trace:8] [start:u64 length:u64]"),
    "work_batch": (0x12, "count:u8 work-item{count}"),
    "result": (0x13, "hash:32 nonce:u64 flags:u8 client:len8 [trace:8]"),
}

KIND_WORK = FRAME_GRAMMAR["work"][0]
KIND_WORK_BATCH = FRAME_GRAMMAR["work_batch"][0]
KIND_RESULT = FRAME_GRAMMAR["result"][0]

#: flags byte bits (work and result bodies share bit 0)
FLAG_TRACE = 0x01
FLAG_RANGE = 0x02

MAX_BATCH_ITEMS = 255

_U64 = struct.Struct(">Q")
_U64U64 = struct.Struct(">QQ")

#: Per-flags work-body layouts, ONE precompiled unpack each (the flags
#: byte at a fixed offset selects the layout; everything else — hash,
#: difficulty, optionals — comes out of a single struct call). Index =
#: flags value; None = unknown flag bits (reject: a future field this
#: decoder cannot size must not be silently mis-sliced).
_WORK_BODY = [
    struct.Struct(">32sQB"),        # 0: no optionals
    struct.Struct(">32sQB8s"),      # FLAG_TRACE
    struct.Struct(">32sQBQQ"),      # FLAG_RANGE
    struct.Struct(">32sQB8sQQ"),    # FLAG_TRACE | FLAG_RANGE
]

# -- metrics (module-level families; senders/routers count, primitives
# stay pure for the micro-bench) ---------------------------------------

_reg = obs.get_registry()
M_FRAMES = _reg.counter(
    "dpow_codec_frames_total",
    "Data-plane payload frames by operation, wire version and kind",
    ("op", "version", "kind"))
M_DOWNGRADE = _reg.counter(
    "dpow_codec_downgrade_total",
    "Lane publishes downgraded to ASCII v0 because the peer did not "
    "advertise the v1 capability")
M_BATCH = _reg.histogram(
    "dpow_codec_batch_occupancy",
    "Work items packed per encoded v1 work frame",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128, 255))


class WireError(ValueError):
    """Malformed v1 frame (a subclass of ValueError so call sites that
    already catch the v0 parsers' ValueError need no second except)."""


def wire_version(payload: str) -> int:
    """0 (legacy ASCII) or 1, decided by the first byte alone. An empty
    payload is v0 (the v0 parsers own the error message for it)."""
    if payload and V1_BASE <= ord(payload[0]) <= V1_BASE | 0x0F:
        return V1
    return V0


# -- encoding ----------------------------------------------------------


def _require_hex(value: str, width: int, what: str) -> bytes:
    if len(value) != width:
        raise WireError(f"{what} must be {width} hex chars: {value!r}")
    try:
        return bytes.fromhex(value)
    except ValueError as e:
        raise WireError(f"{what} is not hex: {value!r}") from e


def _work_body(item, out: bytearray) -> None:
    """``item`` is a WorkItem; the difficulty slot also accepts a plain
    int so senders (which hold u64 targets, not hex strings) need no
    round-trip through hex just to encode."""
    block_hash, difficulty_hex, trace_id, nonce_range = item
    out += _require_hex(block_hash, 64, "block hash")
    difficulty = (
        int(difficulty_hex, 16) if isinstance(difficulty_hex, str)
        else int(difficulty_hex)
    )
    if not 0 <= difficulty < 1 << 64:
        raise WireError(f"difficulty out of u64: {difficulty_hex!r}")
    flags = (FLAG_TRACE if trace_id else 0) | (
        FLAG_RANGE if nonce_range is not None else 0
    )
    out += _U64.pack(difficulty)
    out.append(flags)
    if trace_id:
        out += _require_hex(trace_id, 16, "trace id")
    if nonce_range is not None:
        start, length = nonce_range
        if not (0 <= start < 1 << 64) or not (0 <= length < 1 << 64):
            raise WireError(f"nonce range out of u64: {nonce_range!r}")
        out += _U64U64.pack(start, length)


def encode_work_items(items: Sequence[WorkItem]) -> str:
    """One v1 frame: a WORK frame for a single item, a WORK_BATCH for
    several (≤255). Raises WireError (a ValueError) on malformed fields —
    senders catch it and fall back to v0."""
    n = len(items)
    if n == 0:
        raise WireError("empty work frame")
    if n > MAX_BATCH_ITEMS:
        raise WireError(f"work batch too large: {n} > {MAX_BATCH_ITEMS}")
    out = bytearray()
    if n == 1:
        out.append(KIND_WORK)
    else:
        out.append(KIND_WORK_BATCH)
        out.append(n)
    for item in items:
        _work_body(item, out)
    return out.decode("latin-1")


def encode_result(
    block_hash: str, work: str, client: str, trace_id: Optional[str] = None
) -> str:
    """One v1 RESULT frame. The nonce travels as a u64, the payout account
    as a length-prefixed UTF-8 field."""
    out = bytearray([KIND_RESULT])
    out += _require_hex(block_hash, 64, "block hash")
    out += _require_hex(work, 16, "work nonce")
    out.append(FLAG_TRACE if trace_id else 0)
    cb = client.encode("utf-8")
    if len(cb) > 255:
        raise WireError(f"client field too long: {len(cb)} bytes")
    out.append(len(cb))
    out += cb
    if trace_id:
        out += _require_hex(trace_id, 16, "trace id")
    return out.decode("latin-1")


# -- decoding ----------------------------------------------------------


def _raw(payload: str) -> bytes:
    try:
        return payload.encode("latin-1")
    except UnicodeEncodeError as e:
        raise WireError(f"payload is not a byte string: {e}") from e


def decode_work_frame(payload: str) -> List[WorkItem]:
    """v1 WORK / WORK_BATCH frame → its items (difficulty as a native int,
    hash as lowercase hex — see WorkItem). Raises WireError on anything
    that is not a well-formed v1 work frame. The body loop is deliberately
    inlined and does one bounds check per item: this is the per-message
    cost benchmarks/codec.py prices against the ASCII parser."""
    raw = _raw(payload)
    n = len(raw)
    if not n:
        raise WireError("empty frame")
    kind = raw[0]
    if kind == KIND_WORK:
        count, off = 1, 1
    elif kind == KIND_WORK_BATCH:
        if n < 2:
            raise WireError("truncated batch header")
        count, off = raw[1], 2
        if count == 0:
            raise WireError("empty work batch")
    else:
        raise WireError(f"not a work frame (kind 0x{kind:02x})")
    items: List[WorkItem] = []
    append = items.append
    bodies = _WORK_BODY
    if count > 1 and len(raw) > off + 40:
        # Uniform-batch fast path: the coordinator encodes one lane's items
        # with identical optional fields, making the frame a regular record
        # array — iterate it in one C-level pass. Falls through to the
        # general loop whenever the geometry or any record's flags differ.
        flags = raw[off + 40]
        if flags <= 3:
            st = bodies[flags]
            if n - off == count * st.size:
                if flags == 3:
                    for h, difficulty, f, trace, start, length in (
                        st.iter_unpack(memoryview(raw)[off:])
                    ):
                        if f != 3:
                            items.clear()
                            break
                        append((h.hex(), difficulty, trace.hex(),
                                (start, length)))
                    else:
                        return items
                elif flags == 0:
                    for h, difficulty, f in st.iter_unpack(
                        memoryview(raw)[off:]
                    ):
                        if f != 0:
                            items.clear()
                            break
                        append((h.hex(), difficulty, None, None))
                    else:
                        return items
    for _ in range(count):
        flags_at = off + 40  # hash 32 + difficulty 8
        if flags_at >= n:
            raise WireError("truncated work body")
        flags = raw[flags_at]
        if flags > 3:
            raise WireError(f"unknown work flags 0x{flags:02x}")
        st = bodies[flags]
        end = off + st.size
        if n < end:
            raise WireError("truncated work body")
        vals = st.unpack_from(raw, off)
        if flags == 3:
            h, difficulty, _, trace, start, length = vals
            append((h.hex(), difficulty, trace.hex(), (start, length)))
        elif flags == 1:
            h, difficulty, _, trace = vals
            append((h.hex(), difficulty, trace.hex(), None))
        elif flags == 2:
            h, difficulty, _, start, length = vals
            append((h.hex(), difficulty, None, (start, length)))
        else:
            append((vals[0].hex(), vals[1], None, None))
        off = end
    if off != n:
        raise WireError(f"{n - off} trailing bytes after work frame")
    return items


def decode_result_frame(payload: str) -> Tuple[str, str, str, Optional[str]]:
    """v1 RESULT frame → (block_hash, work_hex, client, trace_id or None),
    the exact tuple parse_result_payload returns."""
    raw = _raw(payload)
    if not raw or raw[0] != KIND_RESULT:
        raise WireError("not a result frame")
    if len(raw) < 43:  # kind 1 + hash 32 + nonce 8 + flags 1 + len 1
        raise WireError("truncated result frame")
    block_hash = raw[1:33].hex().upper()
    (nonce,) = _U64.unpack_from(raw, 33)
    flags = raw[41]
    clen = raw[42]
    end = 43 + clen
    if len(raw) < end:
        raise WireError("truncated client field")
    try:
        client = raw[43:end].decode("utf-8")
    except UnicodeDecodeError as e:
        raise WireError(f"client field is not UTF-8: {e}") from e
    trace_id = None
    if flags & FLAG_TRACE:
        if len(raw) < end + 8:
            raise WireError("truncated trace id")
        trace_id = raw[end : end + 8].hex()
        end += 8
    if end != len(raw):
        raise WireError(f"{len(raw) - end} trailing bytes after result frame")
    return block_hash, f"{nonce:016x}", client, trace_id


# -- version routing (the receivers' entry points) ---------------------


def decode_work_any(payload: str) -> List[WorkItem]:
    """Route a work payload by wire version: v1 frames unbatch into their
    items, v0 ASCII parses byte-for-byte as before (one item). Raises
    ValueError either way on garbage. Counts dpow_codec_frames_total."""
    if wire_version(payload) == V1:
        items = decode_work_frame(payload)
        M_FRAMES.inc(1, "decode", "v1", "work" if len(items) == 1 else "work_batch")
        return items
    item = parse_work_payload(payload)
    M_FRAMES.inc(1, "decode", "v0", "work")
    return [item]


def decode_result_any(payload: str) -> Tuple[str, str, str, Optional[str]]:
    """Route a result payload by wire version (same tuple both ways)."""
    if wire_version(payload) == V1:
        out = decode_result_frame(payload)
        M_FRAMES.inc(1, "decode", "v1", "result")
        return out
    out = parse_result_payload(payload)
    M_FRAMES.inc(1, "decode", "v0", "result")
    return out


def count_encoded(version: str, kind: str, items: int = 1) -> None:
    """Sender-side accounting: one frame of ``kind`` at ``version`` left
    this process; v1 work frames also record their batch occupancy."""
    M_FRAMES.inc(1, "encode", version, kind)
    if version == "v1" and kind in ("work", "work_batch"):
        M_BATCH.observe(float(items))
