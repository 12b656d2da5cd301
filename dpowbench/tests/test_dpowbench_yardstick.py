"""The yardstick's parts on the CPU: the reference, the roofline's constant,
the trace reduction and the generator's determinism."""

from __future__ import annotations

import json
import random

import pytest

from dpowbench import devtrace, loadgen, prom, reference, roofline

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

    # chip_smoke.py read 1,687 ALU- and 304 FMA-pipe instructions per nonce
    # from the search kernel's SASS: it reads under its roofline
    assert share_of(1687, 304) < 100
    # every rotate moved to the FMA pipe as IMAD.HI + IMAD still reads under
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
