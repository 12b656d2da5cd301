"""The benchmark's ``send_v2_persistent`` deployment and what it reads.

* The persistent engine, at the cell's flags, returns for pinned-start
  requests exactly the lowest nonce from the start that hashlib finds
  (``dpowbench/reference.py``), and ``dpow_engine_hashes_total`` counts the
  nonces the rows ran up to their hits. On a card (marker ``cuda``) the
  same with 16 rows at a lowered threshold, and with rows whose first hits
  lie spans apart, which the run kernel scans with the finished rows'
  blocks re-granted to the late ones.
* A scripted persistent launch whose rows the device reports done at known
  polls counts the expected live and done row-windows
  (``dpow_backend_persistent_row_windows_total``), returns for the expected
  cause (``dpow_backend_persistent_returns_total``), and its launch span
  carries both.
* A launch's out words, laid out as the run library's ``b2_run_out_words``
  gives them, count its windows dealt evenly and re-granted
  (``dpow_backend_persistent_grid_windows_total``); chunked launches count
  none.
* The cell's readers, ``persistent_live_rows_pct``,
  ``run_kernel_roofline_pct`` and ``persistent_regrant_pct``, on canned
  pages and traces.
* A whole CPU run of ``send_v2_persistent.closed32`` at a tiny threshold
  comes out correct, and its control run does not.
"""

import asyncio
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from dpowbench import prom, reference
from dpowbench.run import for_cell, load_reader
from dpowbench.stack import ROOT
from tpu_dpow_torch import obs
from tpu_dpow_torch.backend.torch_backend import PERSISTENT_RETURNS, TorchWorkBackend, _Job
from tpu_dpow_torch.models import WorkRequest
from tpu_dpow_torch.obs import LEDGER
from tpu_dpow_torch.ops import control, cuda_kernel, search

torch.set_num_threads(1)

CELL = "send_v2_persistent.closed32"
TINY = 0xFFF0000000000000  # 2^12 expected hashes: a CPU window or two
ROW_WINDOWS = "dpow_backend_persistent_row_windows_total"
RETURNS = "dpow_backend_persistent_returns_total"
GRID_WINDOWS = "dpow_backend_persistent_grid_windows_total"
H100 = "NVIDIA H100 80GB HBM3"


def run(coro, timeout=120):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def cell_engine(device: str) -> TorchWorkBackend:
    """The engine as the cell's worker flags make it."""
    with open(os.path.join(ROOT, "dpowbench", "configs", "send_v2_persistent.json")) as f:
        flags = json.load(f)["worker_flags"]
    opts = dict(zip(flags[::2], flags[1::2]))
    return TorchWorkBackend(
        device=device, run_mode=opts["--run_mode"], max_batch=int(opts["--max_batch"]),
        run_steps=int(opts["--run_steps"]), pipeline=int(opts["--pipeline"]))


def solve_pinned(device: str, n: int, threshold: int, seed: int) -> None:
    rng = np.random.default_rng(seed)
    reqs = [(rng.bytes(32).hex().upper(), int(rng.integers(0, 1 << 62))) for _ in range(n)]
    b = cell_engine(device)

    def hashes() -> int:
        return obs.snapshot()["dpow_engine_hashes_total"]["series"].get("torch", 0)

    async def go():
        await b.setup()
        before = hashes()
        try:
            works = await asyncio.gather(*(
                b.generate(WorkRequest(h, threshold, nonce_range=(start, 0)))
                for h, start in reqs))
            while b._inflight:
                await asyncio.sleep(0.01)
            return works, hashes() - before
        finally:
            await b.close()

    works, scanned = run(go(), timeout=600)
    want = [reference.solve(h, threshold, start) for h, start in reqs]
    assert works == want
    # each job solved in its one launch: its row ran from its start to its hit
    assert scanned == sum(int(w, 16) - start + 1 for w, (_h, start) in zip(want, reqs))


def test_persistent_engine_returns_the_references_lowest_nonce():
    assert cell_engine("cpu").persistent_steps == 256
    solve_pinned("cpu", 8, TINY, seed=18)


@pytest.mark.cuda
def test_persistent_engine_returns_the_references_lowest_nonce_on_the_card():
    """16 pinned-start rows at the cell's geometry (run on the card with
    ``python -m pytest --noconftest tests/test_torch_persistent_cell.py -m cuda``)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    b = cell_engine("cuda")
    assert (b.chunk, b.persistent_steps, b.control_poll_steps) == (1 << 25, 256, 2)
    solve_pinned("cuda", 16, 0xFFFFF00000000000, seed=1818)


@pytest.mark.cuda
def test_rows_that_finish_spans_apart_on_the_card():
    """At the cell's geometry, 15 rows pinned to hit in the launch's first
    span and one pinned to hit at least four spans (2^28 nonces) later: the
    engine returns each row's first hit, found beforehand by the search
    kernel, the hashes counted are the nonces up to the hits, and the run
    kernel ran the late row's spans with the grid re-granted to it."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    threshold = 0xFFFFFFF000000000  # 2^28 expected hashes
    b = cell_engine("cuda")
    geo = dict(sublanes=b.sublanes, iters=b.iters, nblocks=b.nblocks, group=b.group)
    span = b.chunk * b.control_poll_steps  # a live row's nonces between polls
    rng = np.random.default_rng(1819)
    for _attempt in range(4):
        cands = [(rng.bytes(32), int(rng.integers(0, 1 << 62))) for _ in range(24)]
        params = np.stack([search.pack_params(h, threshold, start) for h, start in cands])
        # each row's first hit in 32 windows (2^30 nonces) from its start
        offs = search.offsets_to_numpy(cuda_kernel.cuda_search_chunk_batch(
            search.params_from_numpy(params, "cuda"), **{**geo, "nblocks": b.nblocks * 32}))
        hit = sorted(((int(o), h, start) for (h, start), o in zip(cands, offs)
                      if o != search.SENTINEL), reverse=True)
        if len(hit) >= 16 and hit[0][0] >= 4 * span:
            break
    else:
        pytest.fail("no seed gave 16 rows with a first hit and one 4 spans in")
    # No hit lies in [start, start + off): from start + off - t the first hit
    # is at offset t, for any t <= off.
    # The late row last: a launch dispatched with the first job alone has
    # one row and never re-grants.
    late = hit[0]
    early = [(off % span, h, start + off - off % span) for off, h, start in hit[1:16]]
    rows = [(h.hex().upper(), start, t) for t, h, start in early + [late]]

    def series(name):
        return dict(obs.snapshot()[name]["series"])

    async def go():
        await b.setup()
        before = (series("dpow_engine_hashes_total").get("torch", 0), series(GRID_WINDOWS))
        try:
            works = await asyncio.gather(*(
                b.generate(WorkRequest(h, threshold, nonce_range=(start, 0)))
                for h, start, _t in rows))
            while b._inflight:
                await asyncio.sleep(0.01)
            grid = series(GRID_WINDOWS)
            return (works, series("dpow_engine_hashes_total").get("torch", 0) - before[0],
                    {k: grid[k] - before[1][k] for k in grid})
        finally:
            await b.close()

    works, scanned, grid = run(go(), timeout=600)
    want = [f"{start + t:016x}" for _h, start, t in rows]
    assert works == want
    for (h, _start, _t), w in zip(rows, works):
        assert reference.work_value(h, w) >= threshold
    assert scanned == sum(t + 1 for _h, _start, t in rows)
    assert grid["regranted"] >= late[0] // b.chunk - 2 * b.control_poll_steps


# -- a scripted persistent launch ------------------------------------------

EASY = 0xFF00000000000000


def _polls(control, script: dict, rows: int, done=None) -> np.ndarray:
    """Serve the launch's polls as the device makes them: ``script`` maps a
    poll's window index to the rows the device reports done there; a row
    the host cancelled before a poll stops at it. Returns the done mask."""
    done = np.zeros(rows, dtype=bool) if done is None else done
    for k in sorted(script):
        done[list(script[k])] = True
        control.poll(0, k, done)
        done |= np.array([(i, 0) in control.done_at_k for i in range(rows)])
    return done


# (jobs, batch, polls: {k: rows done there}, rows hit after the last poll,
#  rows the host cancels before the last poll, live, done, windows, cause)
SCRIPTS = {
    # rows 0 and 1 seen done at polls 2 and 6; rows 2 and 3 hit in the last
    # block, [8, 10), so the loop ends at its fold without another poll
    "all_done": (4, 4, {0: (), 2: (1,), 4: (), 6: (0,), 8: ()}, (2, 3), (), 2 + 6 + 10 + 10,
                 8 + 4, 10, "all_done"),
    # three jobs and one pad row, which drains in the first block: it counts
    # in neither state
    "pad_row": (3, 4, {0: (), 2: (3,), 4: (1,)}, (0, 2), (), 6 + 4 + 6, 2, 6, "all_done"),
    # row 1 never hits: the launch runs its 64 windows
    "span_end": (2, 2, {**{k: () for k in range(0, 64, 2)}, 4: (0,)}, (), (), 4 + 64, 60,
                 64, "span_end"),
    # row 0 hits before poll 4, rows 1 and 2 are cancelled at poll 6: every
    # row is seen done at a poll, and the loop ends there
    "killed": (3, 4, {0: (), 2: (3,), 4: (0,), 6: ()}, (), (1, 2), 4 + 6 + 6, 2 + 0 + 0, 6,
               "killed"),
}


# (batch, windows the kernel ran, of those re-granted): a full launch whose
# first row is done after its first span, a padded one that re-grants from
# its second span, and a 1-row launch, which never re-grants.
GRID_CASES = {"full": (4, 10, 8), "padded": (4, 6, 4), "one_row": (1, 6, 0)}


@pytest.mark.parametrize("name", list(GRID_CASES))
def test_launch_out_words_count_grid_windows(monkeypatch, name):
    """The run library's out words for a launch (their length from the
    faked library's ``b2_run_out_words``, its ABI the wrapper's) reach the
    launch's control slot through ``take_out_stats``, and the engine counts
    them at apply as ``even`` and ``regranted`` windows; a released slot
    drops them."""
    from test_torch_package import _FakeLib

    batch, windows, regranted = GRID_CASES[name]
    monkeypatch.setattr(cuda_kernel, "build_libraries", lambda names: {n: n for n in names})
    monkeypatch.setattr(cuda_kernel.ctypes, "CDLL", _FakeLib)
    monkeypatch.setattr(cuda_kernel, "_libs", {})
    monkeypatch.setattr(cuda_kernel, "_lib_paths", {})
    lib = cuda_kernel.load_run_library()
    obs.reset()
    LEDGER.reset()
    b = TorchWorkBackend(device="cpu", run_mode="persistent", max_batch=batch, run_steps=4,
                         control_poll_steps=2)
    rng = np.random.default_rng(19)

    async def go():
        loop = asyncio.get_running_loop()
        b._submit_launch = lambda params, steps, slot=0, **kw: loop.create_future()
        for h in [rng.bytes(32).hex().upper() for _ in range(min(batch, 3))]:
            b._jobs[h] = _Job(h, EASY, search.pack_params(bytes.fromhex(h), EASY, 0),
                              loop.create_future(), 0)
        rec = b._dispatch_next()
        _polls(rec.control, {k: () for k in range(0, windows, 2)}, rec.batch)
        words = np.zeros(lib.b2_run_out_words(rec.batch), dtype=np.uint32)
        for i, job in enumerate(rec.jobs):
            nonce = int(reference.solve(job.block_hash, EASY, rec.bases[i]), 16)
            words[i], words[rec.batch + i] = nonce & 0xFFFFFFFF, nonce >> 32
        stats = words[2 * rec.batch:]
        stats[0], stats[5], stats[6] = rec.control.polls, windows, regranted
        cuda_kernel.take_out_stats(stats, rec.slot, 0, 0)
        control.release(rec.slot)
        cuda_kernel.take_out_stats(stats, rec.slot, 0, 0)  # released: dropped
        b._apply_results(rec, words[:rec.batch], words[rec.batch:2 * rec.batch])

    run(go())
    assert obs.snapshot()[GRID_WINDOWS]["series"] == {"even": windows - regranted,
                                                      "regranted": regranted}


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_scripted_launch_counts_live_and_done_row_windows(name):
    jobs, batch, polls, hit_last, cancel, live, done, windows, cause = SCRIPTS[name]
    obs.reset()
    LEDGER.reset()
    tracer = obs.get_tracer()
    b = TorchWorkBackend(device="cpu", run_mode="persistent", max_batch=batch, run_steps=4,
                         control_poll_steps=2)
    assert b.persistent_steps == 64
    rng = np.random.default_rng(len(name))

    async def go():
        loop = asyncio.get_running_loop()
        b._submit_launch = lambda params, steps, slot=0, **kw: loop.create_future()
        hashes = [rng.bytes(32).hex().upper() for _ in range(jobs)]
        for h in hashes:
            b._jobs[h] = _Job(h, EASY, search.pack_params(bytes.fromhex(h), EASY, 0),
                              loop.create_future(), 0)
        rec = b._dispatch_next()
        assert rec.batch == batch and len(rec.jobs) == jobs
        last = max(polls)
        done = _polls(rec.control, {k: v for k, v in polls.items() if k < last}, batch)
        for i in cancel:
            rec.control.cancel(i)
        _polls(rec.control, {last: polls[last]}, batch, done)
        lo = np.full(batch, 0xFFFFFFFF, dtype=np.uint32)
        hi = lo.copy()
        hit_rows = set(hit_last) | {i for k in polls for i in polls[k] if i < jobs}
        for i in hit_rows - set(cancel):
            nonce = int(reference.solve(rec.jobs[i].block_hash, EASY, rec.bases[i]), 16)
            lo[i], hi[i] = nonce & 0xFFFFFFFF, nonce >> 32
        b._apply_results(rec, lo, hi)
        return rec

    rec = run(go())
    snap = obs.snapshot()
    assert snap[ROW_WINDOWS]["series"] == {"live": live, "done": done}
    returns = snap[RETURNS]["series"]
    assert returns == {c: int(c == cause) for c in PERSISTENT_RETURNS}
    (span,) = [r for r in tracer.ring() if r[0] == "launch"]
    args = span[6]
    assert (args["windows_ran"], args["live_row_windows"], args["cause"]) == (windows, live,
                                                                             cause)
    assert live + done == windows * jobs
    assert rec.control.polls == len(polls)


def test_chunked_launches_count_no_row_windows():
    """The chunked path pays nothing: its span has no persistent fields and
    the families stay at 0."""
    obs.reset()
    tracer = obs.get_tracer()
    b = TorchWorkBackend(device="cpu", sublanes=8, iters=8)

    async def go():
        await b.setup()
        try:
            h = np.random.default_rng(3).bytes(32).hex().upper()
            await b.generate(WorkRequest(h, TINY))
            while b._inflight:
                await asyncio.sleep(0.01)
        finally:
            await b.close()

    run(go())
    snap = obs.snapshot()
    assert snap[ROW_WINDOWS]["series"] == {"live": 0, "done": 0}
    assert snap[GRID_WINDOWS]["series"] == {"even": 0, "regranted": 0}
    assert set(snap[RETURNS]["series"].values()) == {0}
    spans = [r[6] for r in tracer.ring() if r[0] == "launch"]
    assert spans and not any("cause" in a or "windows_ran" in a for a in spans)


# -- the cell's readers -----------------------------------------------------

def page(live=0.0, done=0.0, hashes=0.0, counts=True, even=0.0, regranted=0.0) -> prom.Page:
    text = f'dpow_engine_hashes_total{{engine="torch"}} {hashes}\n'
    if counts:
        text += (f'{ROW_WINDOWS}{{state="live"}} {live}\n'
                 f'{ROW_WINDOWS}{{state="done"}} {done}\n'
                 f'{GRID_WINDOWS}{{grid="even"}} {even}\n'
                 f'{GRID_WINDOWS}{{grid="regranted"}} {regranted}\n')
    return prom.parse_text(text)


def src(before, after, trace=None, clocks=None, kind=H100) -> dict:
    return {"worker": (before, after), "trace": trace, "clocks": clocks, "kind": kind}


def test_live_rows_reader():
    read = load_reader("persistent_live_rows_pct")
    assert read(src(page(10, 5), page(40, 95))) == pytest.approx(100.0 * 30 / 120)
    # the parent's worker counts no row-windows; a chunked cell applies none
    assert read(src(page(counts=False), page(counts=False))) is None
    assert read(src(page(10, 5), page(10, 5))) is None


def test_regrant_reader():
    read = load_reader("persistent_regrant_pct")
    assert read(src(page(even=4, regranted=6), page(even=10, regranted=60))) == pytest.approx(
        100.0 * 54 / 60)
    # the parent's worker counts no grid windows; a chunked cell applies none
    assert read(src(page(counts=False), page(counts=False))) is None
    assert read(src(page(even=4, regranted=6), page(even=4, regranted=6))) is None


def test_run_kernel_roofline_reader():
    read = load_reader("run_kernel_roofline_pct")
    clocks = {"max_sm_clock_mhz": 1980.0}
    hashes = 1e11
    # the least time of 1e11 hashes: 15.48 lane-clocks each over 132 SMs
    bound = hashes * 1982 / 128 / (132 * 1980e6)
    trace = {"kernel_busy_s": {"b2_run_kernel": 4 * bound, "b2_search_kernel": bound}}
    got = read(src(page(hashes=5e10), page(hashes=5e10 + hashes), trace, clocks))
    assert got == pytest.approx(25.0)
    assert read(src(page(), page(hashes=hashes), None, clocks)) is None
    assert read(src(page(), page(hashes=hashes), trace, None)) is None
    # a chunked run's trace holds no run kernel, and an idle window no hashes
    chunked = {"kernel_busy_s": {"b2_search_kernel": 1.0}}
    assert read(src(page(), page(hashes=hashes), chunked, clocks)) is None
    assert read(src(page(hashes=7), page(hashes=7), trace, clocks)) is None
    assert read(src(page(), page(hashes=hashes), trace, clocks, kind="cpu")) is None


def test_the_cell_reads_its_metrics():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    assert {m["name"] for m in for_cell(bench["end_to_end"], CELL)} == {"served_per_s",
                                                                         "setup_s"}
    assert {m["name"] for m in for_cell(bench["per_layer"], CELL)} == {
        "persistent_live_rows_pct", "run_kernel_roofline_pct", "persistent_regrant_pct"}


# -- a whole CPU run of the cell -------------------------------------------

def make_bench(tmp_path) -> str:
    """BENCHMARK.json beside copies of the cell's configuration and mix, at
    a tiny threshold and four callers (as dpowbench/tests'
    ``make_bench`` builds its copies)."""
    base = tmp_path / "bench"
    (base / "dpowbench" / "configs").mkdir(parents=True)
    (base / "dpowbench" / "traffic").mkdir(parents=True)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for entry in bench["configs"]:
        with open(os.path.join(ROOT, entry["file"])) as f:
            cfg = json.load(f)
        cfg.update(difficulty="fff0000000000000", control_difficulty="ff00000000000000")
        (base / entry["file"]).write_text(json.dumps(cfg))
    with open(os.path.join(ROOT, "dpowbench", "traffic", "closed32.json")) as f:
        mix = json.load(f)
    mix.update(warm_s=1.0, callers=4)
    (base / "dpowbench" / "traffic" / "closed32.json").write_text(json.dumps(mix))
    (base / "BENCHMARK.json").write_text(json.dumps(bench))
    return str(base / "BENCHMARK.json")


@pytest.mark.parametrize("control", [False, True], ids=["judged", "control"])
def test_cpu_run_of_the_cell(tmp_path, control):
    proc = subprocess.run(
        [sys.executable, "-m", "dpowbench.run", "--bench", make_bench(tmp_path),
         "--workload", CELL, "--seed", str(2**31 + 1818), "--seconds", "4", "--trace", "0",
         "--device", "cpu", *(["--control"] if control else [])],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    checks = line["checks"]
    if control:
        assert line["correct"] is False
        assert checks["invalid_work"]["value"] > 0
    else:
        assert line["correct"] is True, checks
        assert line["attempted"] > 0 and line["failed"] == 0
        assert {k: checks[k]["value"] for k in ("invalid_work", "hashes_with_two_works",
                                                "never_answered")} == dict.fromkeys(
            ("invalid_work", "hashes_with_two_works", "never_answered"), 0)
        assert checks["served_min"]["value"] >= 1
        assert set(line["metrics"]) == {"served_per_s", "setup_s"}
