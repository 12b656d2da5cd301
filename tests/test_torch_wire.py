"""The port's work/result codecs (transport/mqtt_codec.py, transport/wire.py)
against tpu_dpow's, in both directions.

The same seeded items, made with numpy, are encoded by both packages: the
payloads must be byte-identical, and each package must decode what the
other encoded to the same fields (tolerance: exact). The MQTT 3.1.1 packet
codec is held the same way, packet type by packet type.
"""

import numpy as np
import pytest

from tpu_dpow import obs as jobs
from tpu_dpow.transport import mqtt_codec as jcodec
from tpu_dpow.transport import wire as jwire
from tpu_dpow_torch import obs as tobs
from tpu_dpow_torch.transport import mqtt_codec as tcodec
from tpu_dpow_torch.transport import wire as twire

RNG = np.random.default_rng(51)
PACKAGES = [pytest.param((twire, jwire), id="port_to_jax"),
            pytest.param((jwire, twire), id="jax_to_port")]


def hexs(n: int) -> str:
    return RNG.bytes(n).hex()


def seeded_item(i: int):
    """A WorkItem: the hash lowercase or uppercase, the difficulty as hex
    or int, with and without a trace id and a nonce range (0 = full span)."""
    h = hexs(32)
    h = h.upper() if i % 2 else h
    diff = int(RNG.integers(0, 1 << 63)) | (1 << 63)
    difficulty = f"{diff:016x}" if i % 3 else diff
    trace = hexs(8) if i % 4 in (1, 3) else None
    rng = (int(RNG.integers(0, 1 << 63)), int(RNG.integers(0, 1 << 40)) * (i % 5 != 0)) \
        if i % 4 >= 2 else None
    return (h, difficulty, trace, rng)


ITEMS = [seeded_item(i) for i in range(24)]


@pytest.mark.parametrize("pkgs", PACKAGES)
@pytest.mark.parametrize("n", [1, 2, 7, 24])
def test_work_frames_byte_identical_and_cross_decoded(pkgs, n):
    enc, dec = pkgs
    items = ITEMS[:n]
    frame = enc.encode_work_items(items)
    other = dec.encode_work_items(items)
    assert frame == other and frame.encode("latin-1") == other.encode("latin-1")
    assert dec.wire_version(frame) == enc.wire_version(frame) == enc.V1
    assert dec.decode_work_frame(frame) == enc.decode_work_frame(frame)
    assert dec.decode_work_any(frame) == enc.decode_work_any(frame)


@pytest.mark.parametrize("pkgs", PACKAGES)
@pytest.mark.parametrize("trace", [None, "0123456789abcdef"])
def test_result_frames_byte_identical_and_cross_decoded(pkgs, trace):
    enc, dec = pkgs
    args = (hexs(32).upper(), hexs(8), "nano_" + "3" * 60, trace)
    frame = enc.encode_result(*args)
    assert frame == dec.encode_result(*args)
    assert dec.decode_result_frame(frame) == enc.decode_result_frame(frame)
    assert dec.decode_result_any(frame) == enc.decode_result_any(frame)


@pytest.mark.parametrize("pkgs", [pytest.param((tcodec, jcodec), id="port_to_jax"),
                                  pytest.param((jcodec, tcodec), id="jax_to_port")])
@pytest.mark.parametrize("i", range(8))
def test_v0_payloads_byte_identical_and_cross_parsed(pkgs, i):
    enc, dec = pkgs
    h, difficulty, trace, rng = ITEMS[i]
    diff = int(difficulty, 16) if isinstance(difficulty, str) else difficulty
    payload = enc.encode_work_payload(h, diff, trace, rng)
    assert payload == dec.encode_work_payload(h, diff, trace, rng)
    assert dec.parse_work_payload(payload) == enc.parse_work_payload(payload)
    result = enc.encode_result_payload(h, hexs(8), "nano_x", trace)
    assert result == dec.encode_result_payload(*dec.parse_result_payload(result))
    assert dec.parse_result_payload(result) == enc.parse_result_payload(result)


@pytest.mark.parametrize("bad", ["", "x", "abc", "\x11\x00", "\x12", "\x13" + "\x00" * 3])
def test_malformed_payloads_fail_alike(bad):
    for pkg in (twire, jwire):
        with pytest.raises(ValueError):
            pkg.decode_work_any(bad)
        with pytest.raises(ValueError):
            pkg.decode_result_any(bad if bad else "a,b")
    for pkg in (twire, jwire):
        with pytest.raises(ValueError):
            pkg.encode_work_items([])
        with pytest.raises(ValueError):
            pkg.encode_work_items([("zz", 1, None, None)])


def mqtt_packets(codec):
    return [
        codec.Connect("client-1", "client", "pw", clean_session=False, keepalive=30),
        codec.Connect("c2"),
        codec.Connack(0, session_present=True),
        codec.Publish("work/ondemand", b"\x10abc,def", qos=1, mid=7),
        codec.Publish("heartbeat", b"", qos=0),
        codec.Puback(7),
        codec.Subscribe(3, [("work/#", 0), ("cancel/+", 1)]),
        codec.Suback(3, [0, 1, 0x80]),
        codec.Unsubscribe(4, ["work/#"]),
        codec.Unsuback(4),
        codec.Pingreq(),
        codec.Pingresp(),
        codec.Disconnect(),
    ]


@pytest.mark.parametrize("k", range(13))
def test_mqtt_packets_byte_identical_and_cross_decoded(k):
    tp, jp = mqtt_packets(tcodec)[k], mqtt_packets(jcodec)[k]
    raw = tcodec.encode(tp)
    assert raw == jcodec.encode(jp)
    body = raw[1:]
    while body and body[0] & 0x80:  # skip the remaining-length varint
        body = body[1:]
    body = body[1:]
    got, want = tcodec.decode(raw[0], body), jcodec.decode(raw[0], body)
    assert type(got).__name__ == type(want).__name__
    assert vars(got) == vars(want)


def test_codec_counters_land_on_the_ports_registry_only():
    tobs.reset()
    jobs.reset()
    twire.decode_work_any(twire.encode_work_items(ITEMS[:3]))
    twire.count_encoded("v1", "result")
    snap = tobs.snapshot()
    assert snap["dpow_codec_frames_total"]["series"]
    assert "dpow_codec_frames_total" not in jobs.snapshot() or not jobs.snapshot()[
        "dpow_codec_frames_total"]["series"]
