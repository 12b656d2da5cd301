"""The yardstick's parts on the CPU: the reference, the roofline's constant,
the trace reduction, the generator's determinism, the request bodies and the
account-chained loop."""

from __future__ import annotations

import asyncio
import json
import random
import time

import pytest

from dpowbench import devtrace, drive, feed, loadgen, prom, reference, roofline

HASH = "718CC2121C3E641059BC1C2CFC45666C99E8AE922F7A807B7D07B62C995D79E2"
LOW = 0xFFF0000000000000


def test_dpowbench_reference_accepts_work_that_meets_the_threshold():
    work = reference.solve(HASH, LOW)
    assert reference.valid(HASH, work, LOW)
    assert reference.work_value(HASH, work) >= LOW
    # the same value as the nonce's little-endian bytes hashed by hand
    assert reference.valid("00" * 32, reference.solve("00" * 32, LOW), LOW)


def test_dpowbench_reference_rejects_a_corrupted_nonce_and_weak_work():
    work = reference.solve(HASH, LOW)
    corrupted = work[:-1] + ("0" if work[-1] != "0" else "1")
    assert reference.work_value(HASH, corrupted) < LOW  # a flipped nonce misses
    assert not reference.valid(HASH, corrupted, LOW)
    # valid at a lower threshold, judged at one it does not meet
    weak = reference.solve(HASH, 0xF000000000000000)
    strict = reference.work_value(HASH, weak) + 1
    assert not reference.valid(HASH, weak, strict)
    for bad in (None, "", "xyz", work + "0", 12345):
        assert not reference.valid(HASH, bad, LOW)


def test_dpowbench_roofline_constant_is_below_the_kernels_sass_count():
    h100, mhz = "NVIDIA H100 80GB HBM3", 1980
    # 96 G of 8 XOR, 6 rotate and 8 add instructions, less what the
    # derivation removes
    assert roofline.XOR_OPS_PER_HASH == 96 * 8 - 5 * 8 - 4 - 2 - 4 + 2
    assert roofline.ROTATE_OPS_PER_HASH == 96 * 6 - 5 * 6 - 4 - 2 - 4
    assert roofline.ADD_OPS_PER_HASH == 96 * 8 - 5 * 8 - 2
    assert roofline.XOR_OPS_PER_HASH + roofline.ROTATE_OPS_PER_HASH == 1256

    def share_of(alu: int, fma: int) -> float:
        # a kernel issuing alu + fma instructions per hash at both pipes' peak
        hashes = 1e9
        seconds = hashes * max(alu, fma) / (132 * 64 * mhz * 1e6)
        return roofline.share_pct(hashes, seconds, h100, mhz)

    # chip_smoke.py reads 1,324 ALU- and 1,028 FMA-pipe instructions per
    # nonce from the search kernel's SASS today, 1,687 and 304 from the
    # kernel before its byte rotations moved to the FMA pipe: both read under
    # the roofline
    assert share_of(1324, 1028) < 100
    assert share_of(1687, 304) < 100
    # every rotate moved to the FMA pipe as IMAD.HI + IMAD still reads under
    # (a floor only: IMAD.HI issues at half rate on the H100)
    assert share_of(720, 2 * 536 + 726) < 100
    assert share_of(720 + 536, 726) < 100
    # the least work, evenly over both pipes, reads 100 %
    even = roofline.INT_OPS_PER_HASH // 2
    assert share_of(even, roofline.INT_OPS_PER_HASH - even) == pytest.approx(100)
    assert share_of(1687, 304) == pytest.approx(100 * 991 / 1687)
    assert roofline.share_pct(1e9, 1.0, "another card", mhz) is None
    assert roofline.share_pct(0, 1.0, h100, mhz) is None


def _kernel(name, ts, dur, corr, stream=7):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur,
            "args": {"stream": stream, "correlation": corr}}


def test_dpowbench_devtrace_reduces_the_window_between_the_marks(tmp_path):
    spin = "at::cuda::(anonymous namespace)::spin_kernel(long)"
    search = "(anonymous namespace)::b2_search_kernel(unsigned int const*, unsigned int*)"
    events = [
        _kernel(spin, 1000.0, 1.0, 1, stream=17),            # the window opens at 1001
        _kernel(search, 500.0, 1001.0, 2),                   # clipped to [1001, 1501)
        _kernel(search, 1400.0, 400.0, 3, stream=9),          # overlaps: union to 1800
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 2500.0,
         "dur": 5.0, "args": {"correlation": 4}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pageable -> Device)",
         "ts": 2600.0, "dur": 100.0, "args": {"correlation": 4}},
        _kernel(spin, 3001.0, 1.0, 5, stream=17),            # and closes at 3001
        _kernel(search, 3100.0, 50.0, 6),                    # after the window
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    out = devtrace.reduce(str(path))
    assert out["window_s"] == pytest.approx(2000e-6)
    assert out["busy_s"] == pytest.approx((1800 - 1001 + 100) * 1e-6)
    assert out["kernel_busy_s"] == {"b2_search_kernel": pytest.approx(799e-6),
                                    "Memcpy HtoD (Pageable -> Device)": pytest.approx(100e-6)}
    assert dict(out["ops"])["b2_search_kernel"] == pytest.approx((500 + 400) * 1e-6)
    (first, s1), (second, s2) = out["gaps"][:2]
    assert s1 == pytest.approx(800e-6) and "issued inside the gap" in first
    assert s2 == pytest.approx(301e-6) and first.startswith("b2_search_kernel -> Memcpy")
    assert second.endswith("window end")


def test_dpowbench_devtrace_without_marks_reads_nothing(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": [_kernel("k", 0.0, 1.0, 1)]}))
    assert devtrace.reduce(str(path)) is None


def test_dpowbench_generator_is_fixed_by_the_seed():
    def draw(seed):
        times = loadgen.arrival_times(150.0, 10.0, random.Random(f"arrivals:{seed}"))
        pop = loadgen.ServicePopulation(profile_seed=2040, stream_seed=seed)
        return times, [pop.spec(t) for t in times]

    big = 2**31 + 977
    assert draw(big) == draw(big)
    a, b = draw(big), draw(big + 1)
    assert a != b
    assert len(a[0]) == len(b[0]) == 1500  # every seed offers the same count
    assert all(0 <= t < 10.0 for t in a[0])


def test_dpowbench_prom_deltas():
    before = prom.parse_text('x_sum{stage="q"} 1.0\nx_count{stage="q"} 2\nc{e="t"} 5\n')
    after = prom.parse_text('x_sum{stage="q"} 4.0\nx_count{stage="q"} 5\nc{e="t"} 9\n')
    assert prom.mean_delta(before, after, "x", {"stage": "q"}) == pytest.approx(1.0)
    assert prom.mean_delta(before, before, "x", {"stage": "q"}) is None
    assert prom.delta(before, after, "c", {"e": "t"}) == 4


#: the bytes of the service faces' bodies for a request that names no
#: account, as they have always been sent
PLAIN_HTTP_BODY = '{"user": "svc-00003", "api_key": "key-00003", "hash": "%s", "timeout": 30.0}'
PLAIN_WS_BODY = ('{"user": "svc-00003", "api_key": "key-00003", "hash": "%s", "timeout": 30.0,'
                  ' "id": 7}')


class _Faces:
    """Stands in for the hub's faces: records each request's spec and the
    body it would send, and serves it at once (``ok`` unless ``fail`` names
    its hash)."""

    def __init__(self, fail=()):
        self.sent, self.fail = [], set(fail)
        self.due, self.end = {}, {}
        self._rng = random.Random("faces:1")

    def pick(self):
        return "ws" if self._rng.random() < 0.1 else "http"

    async def issue(self, spec, face, phase, due):
        self.sent.append((spec, face, json.dumps(loadgen.request_body(spec))))
        await asyncio.sleep(0.001)
        outcome = "error" if spec.hash in self.fail else "ok"
        self.due[spec.hash], self.end[spec.hash] = due, time.perf_counter()
        return {"phase": phase, "face": face, "hash": spec.hash, "due": due, "sent": due,
                "end": self.end[spec.hash], "outcome": outcome, "work": None}


class _Feed:
    def __init__(self):
        self.confirmed = []

    def confirm(self, account, block_hash, previous, at):
        self.confirmed.append((account, block_hash, previous, at))


def _closed(faces, seed, *, chain=None, node=None, callers=3, seconds=0.2):
    population = loadgen.ServicePopulation(n_services=8, profile_seed=2040, stream_seed=seed)
    asyncio.run(drive.closed_loop(faces, population, callers=callers, timeout=30.0, warm_s=0.0,
                                  seconds=seconds, seed=seed, start=time.perf_counter(),
                                  chain=chain, feed=node))


def test_dpowbench_unchained_loop_sends_the_bodies_and_hashes_it_always_sent():
    """A mix without ``chain``: no ``account`` in any body, the bytes of
    each body as before, and caller i's hashes the draws of its own seeded
    stream in order, as before."""
    seed = 2**31 + 99
    faces = _Faces()
    _closed(faces, seed)
    assert faces.sent
    by_caller = {}
    for spec, face, body in faces.sent:
        assert spec.account is None and "account" not in body
        assert body == PLAIN_HTTP_BODY.replace("svc-00003", spec.service).replace(
            "key-00003", spec.api_key) % spec.hash
        by_caller.setdefault(spec.service, []).append(spec.hash)
    for i in range(3):
        rng = random.Random(f"caller:{seed}:{i}")
        hashes = by_caller[f"svc-{i:05d}"]
        assert hashes == [f"{rng.getrandbits(256):064X}" for _ in hashes]
    # the faces' pick draws in the order of issue, as before
    rng = random.Random("faces:1")
    assert [f for _s, f, _b in faces.sent] == [
        "ws" if rng.random() < 0.1 else "http" for _ in faces.sent]


def test_dpowbench_request_body_names_the_account_only_when_set():
    h = "AB" * 32
    spec = loadgen.RequestSpec(0.0, "svc-00003", "key-00003", h, 30.0)
    assert json.dumps(loadgen.request_body(spec)) == PLAIN_HTTP_BODY % h
    assert json.dumps({**loadgen.request_body(spec), "id": 7}) == PLAIN_WS_BODY % h
    account = drive.chain_account(5, 0)
    named = loadgen.RequestSpec(0.0, "svc-00003", "key-00003", h, 30.0, account=account)
    assert loadgen.request_body(named) == {**json.loads(PLAIN_HTTP_BODY % h),
                                           "account": account}


def test_dpowbench_nano_account_matches_the_published_address():
    key = bytes.fromhex("E89208DD038FBB269987689621D52292AE9C35941A7484756ECCED92A65093BA")
    assert loadgen.nano_account(key) == (
        "nano_3t6k35gi95xu6tergt6p69ck76ogmitsa8mnijtpxm9fkcm736xtoncuohr3")
    from tpu_dpow_torch.utils import nanocrypto

    accounts = {drive.chain_account(2**31 + 7, i) for i in range(32)}
    assert len(accounts) == 32
    for a in accounts:
        assert nanocrypto.validate_account(a) == a
    assert drive.chain_account(1, 0) == drive.chain_account(1, 0) != drive.chain_account(2, 0)
    with pytest.raises(ValueError):
        loadgen.nano_account(b"\0" * 31)


def test_dpowbench_draw_seconds_takes_a_number_or_a_small_distribution():
    rng = random.Random(3)
    assert loadgen.draw_seconds(0.25, rng) == 0.25
    assert loadgen.draw_seconds(2, rng) == 2.0
    logn = sorted(loadgen.draw_seconds({"lognormal": [0.5, 0.3]}, rng) for _ in range(2001))
    assert logn[1000] == pytest.approx(0.5, rel=0.1) and logn[0] > 0
    for unknown in ({"pareto": [1.0]}, {"uniform": [0.4, 0.6]}):
        with pytest.raises(ValueError):
            loadgen.draw_seconds(unknown, rng)


def test_dpowbench_chained_loop_asks_for_each_confirmed_block_next():
    """With ``chain``: every request names the caller's account; after an
    answer for H the feed confirms a fresh B on H ``confirm_s`` after the
    answer, and the next request asks for B ``think_s`` after it; a request
    that is not served starts again from a fresh hash."""
    seed = 2**31 + 5
    rng = random.Random(f"caller:{seed}:0")
    first = f"{rng.getrandbits(256):064X}"
    faces, node = _Faces(fail={first}), _Feed()
    _closed(faces, seed, chain={"confirm_s": 0.01, "think_s": 0.025},
            node=node, callers=2, seconds=0.4)
    confirmed = {b: (a, prev, at) for a, b, prev, at in node.confirmed}
    for i in range(2):
        specs = [s for s, _f, _b in faces.sent if s.service == f"svc-{i:05d}"]
        assert len(specs) >= 3
        account = drive.chain_account(seed, i)
        assert {s.account for s in specs} == {account}
        assert all(f'"account": "{account}"' in b for s, _f, b in faces.sent
                   if s.service == specs[0].service)
        for prev, nxt in zip(specs, specs[1:]):
            if prev.hash in faces.fail:
                # asked again at once, for a fresh hash and not a block
                assert nxt.hash not in confirmed
                assert faces.due[nxt.hash] - faces.end[prev.hash] < 0.01
                continue
            assert confirmed[nxt.hash][:2] == (account, prev.hash)
            assert confirmed[nxt.hash][2] - faces.end[prev.hash] == pytest.approx(0.01)
            assert faces.due[nxt.hash] - faces.end[prev.hash] == pytest.approx(0.025)
    # caller 0's first request failed, so its second is its stream's next draw
    assert [s.hash for s, _f, _b in faces.sent if s.service == "svc-00000"][:2] == [
        first, f"{rng.getrandbits(256):064X}"]


def test_dpowbench_node_feed_posts_the_nodes_callback_shape():
    body = feed.callback_body("nano_x", "B" * 64, "A" * 64)
    assert set(body) == {"account", "hash", "block"}
    assert isinstance(body["block"], str)
    assert json.loads(body["block"]) == {"type": "state", "account": "nano_x",
                                         "previous": "A" * 64}
