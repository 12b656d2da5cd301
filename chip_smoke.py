#!/usr/bin/env python3
"""Run the PyTorch + CUDA port on one GPU: build, check, drive, time.

    python3 chip_smoke.py [--phases build,kernel_vs_plain,run_vs_plain,engine,persistent,kernel_time]

Drives ``tpu_dpow_torch`` only (never the JAX package). Each phase prints one
JSON line; a failed phase raises, and the script exits nonzero without its
result lines.

  build            nvcc-builds both kernels (the Blake2b search kernel and the
                   persistent run kernel) from the checkout's sources, one
                   nvcc per source started together; prints ptxas'
                   register/spill report and each kernel's per-nonce
                   integer-instruction count from its SASS.
  kernel_vs_plain  16 seeded rows (pads, 2^32 and 2^64 carries, hits planted
                   in different windows, one dry row) through the kernel and
                   its plain PyTorch version on the card, at every launch
                   shape the engine emits (1-16 rows x 1, 4, 16 windows), a
                   lone hard request, and nblocks=1: bit-equal or fail.
  run_vs_plain     the persistent run kernel against the plain run_loop_core
                   on the card, on 16 and 1 seeded rows over 2^22-nonce
                   windows: no control, a cancel at k >= 2, a raise at k = 0,
                   a rebase at k = 1 and a killed row, each at poll steps 1
                   and 4, plus the uncontrolled launch with and without an
                   active mask, and one row at the engine's 2^25 window with
                   its first hit past window 2. Bit-equal (lo, hi) and
                   identical LaunchControl bookkeeping, or fail.
  engine           TorchWorkBackend at mainnet difficulty: 8 single requests,
                   a 16+16 concurrent burst at two difficulties, a cancel and
                   a raise_difficulty; then the work server (HTTP on
                   127.0.0.1) answers 4 concurrent work_generate requests and
                   a work_validate. Every work string is checked with
                   hashlib. The kernel's launch count is reset just before
                   and read just after, and must be > 0.
  persistent       TorchWorkBackend(run_mode="persistent"): 8 single requests,
                   the 16+16 burst, a mid-launch raise_difficulty and a
                   mid-launch cover_range, every work string checked with
                   hashlib; the run kernel's launch count (reset just before,
                   read just after) must be > 0, with the polls and their
                   round trip. Then the cancel A/B in both run modes (n=5):
                   cancel_to_stop and post_cancel, after
                   benchmarks/cancel_latency.py.
  kernel_time      each kernel alone and its plain version: the search kernel
                   at one engine launch shape (max_batch rows, one window),
                   the run kernel at max_batch rows x 2 windows without
                   control; unreachable difficulty so every row scans it all;
                   CUDA events, beside the integer-issue bound.

The last lines are the kernel table as JSON, then
``{"ok": true, "device": {...}}``. Exits 2 without a result when no CUDA
device is visible.
"""

from __future__ import annotations

import argparse
import asyncio
import hashlib
import json
import os
import re
import shutil
import struct
import subprocess
import sys
import time

PHASES = ("build", "kernel_vs_plain", "run_vs_plain", "engine", "persistent", "kernel_time")
MAINNET = 0xFFFFFFF800000000  # send/change blocks
RECEIVE = 0xFFFFFE0000000000  # receive blocks
MAX_U64 = (1 << 64) - 1
SEED = 2026
# Windows per row of the run kernel's timed launch (kernel_time phase).
RUN_TIME_STEPS = 2

# H100 SXM integer issue: each SM has 4 sub-partitions, each issuing one
# warp instruction (32 lanes) per clock. Integer add, logic, shift and
# compare run on the ALU pipe, integer multiply-add (IMAD, which the compiler
# also uses for moves and adds) on the FMA pipe; each pipe retires 64 lanes
# per SM per clock (compute capability 9.0 throughput table). HBM rate from
# the data sheet. Published figures at the 700 W limit.
ISSUE_LANES_PER_SM = 128
PIPE_LANES_PER_SM = 64
HBM_BYTES_PER_S = 3.35e12
# Per-thread integer opcodes counted from the SASS, by pipe (uniform-datapath
# U* ops run once per warp and are not counted).
ALU_OPS = {
    "IADD3", "IADD", "LOP3", "LOP", "SHF", "SHL", "SHR", "PRMT", "ISETP", "ICMP",
    "SEL", "LEA", "IMNMX", "VIMNMX", "MOV", "IABS", "POPC", "FLO", "BREV", "BMSK",
    "SGXT",
}
FMA_OPS = {"IMAD", "IMUL"}

REPO = os.path.dirname(os.path.abspath(__file__))


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def ref_value(nonce: int, block_hash: bytes) -> int:
    digest = hashlib.blake2b(
        struct.pack("<Q", nonce & MAX_U64) + block_hash, digest_size=8
    ).digest()
    return int.from_bytes(digest, "little")


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0].strip()


_SASS_LINE = re.compile(r"\s*/\*([0-9a-f]+)\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z0-9_]+)([^;]*);")
_SASS_TARGET = re.compile(r"(0x[0-9a-f]+|\.L_x_\d+)")


def sass_int_instructions(lib_path: str, kernel: str = "b2_search_kernel") -> dict:
    """Per-nonce integer instructions of ``kernel``, by opcode: the static
    count inside its scan loop (the smallest loop, from a backward branch's
    target to that branch, that holds the Blake2b body's 1,000+ integer
    instructions), so the prologue (row loads, grid setup), the exit and, in
    the run kernel, the poll and fold around the scan are left out. The
    body is straight-line (12 unrolled rounds), so each opcode in the loop
    runs once per nonce. Returns {"loop": counts, "function": counts,
    "loop_range": [first, last] byte addresses}."""
    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(cuobjdump):
        cuobjdump = shutil.which("cuobjdump") or cuobjdump
    sass = subprocess.run(
        [cuobjdump, "-sass", lib_path], capture_output=True, text=True, check=True,
        timeout=120,
    ).stdout
    instrs, labels, pending, inside = [], {}, [], False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = kernel in line
            continue
        if not inside:
            continue
        label = re.match(r"\s*(\.L_x_\d+):", line)
        if label:
            pending.append(label.group(1))
            continue
        m = _SASS_LINE.match(line)
        if m:
            addr = int(m.group(1), 16)
            for name in pending:
                labels[name] = addr
            pending = []
            instrs.append((addr, m.group(2), m.group(3)))
    def count(pred) -> dict:
        out = {}
        for addr, op, _ in instrs:
            if op in ALU_OPS | FMA_OPS and pred(addr):
                out[op] = out.get(op, 0) + 1
        return out

    loop = None  # (target, branch address) of the smallest loop holding the body
    for addr, op, operands in instrs:
        t = _SASS_TARGET.findall(operands) if op == "BRA" else []
        if not t:
            continue
        target = labels.get(t[-1]) if t[-1].startswith(".") else int(t[-1], 16)
        if target is None or target >= addr:
            continue
        if loop is not None and addr - target >= loop[1] - loop[0]:
            continue
        if sum(count(lambda a: target <= a <= addr).values()) >= 1000:
            loop = (target, addr)
    if loop is None:
        raise RuntimeError(f"no scan loop found in the SASS of {kernel}")

    result = {
        "loop": count(lambda a: loop[0] <= a <= loop[1]),
        "function": count(lambda a: True),
        "loop_range": [loop[0], loop[1]],
        # Spilled registers are read and written with LDL/STL: any inside
        # the loop would cost memory traffic per nonce.
        "local_memory_ops_in_loop": sum(
            1 for addr, op, _ in instrs if op in ("LDL", "STL") and loop[0] <= addr <= loop[1]
        ),
    }
    if not result["loop"]:
        raise RuntimeError(f"no integer instructions found in the scan loop of {kernel}")
    return result


def op_bound_seconds(counts: dict, nonces: int, sms: int, mhz: float) -> float:
    """Least time the card's integer issue allows for ``nonces`` nonces: the
    slower of the sub-partitions' issue rate over all integer instructions
    and each pipe's rate over its own."""
    fma = sum(n for op, n in counts.items() if op in FMA_OPS)
    alu = sum(counts.values()) - fma
    lanes_per_s = sms * mhz * 1e6
    return nonces * max(
        (alu + fma) / (ISSUE_LANES_PER_SM * lanes_per_s),
        alu / (PIPE_LANES_PER_SM * lanes_per_s),
        fma / (PIPE_LANES_PER_SM * lanes_per_s),
    )


def card() -> dict:
    import torch

    props = torch.cuda.get_device_properties(0)
    return {
        "name": torch.cuda.get_device_name(0),
        "smi": nvidia_smi("name,power.limit"),
        "sms": props.multi_processor_count,
        "max_sm_mhz": float(nvidia_smi("clocks.max.sm").split()[0]),
    }


# -- phases -------------------------------------------------------------------


def _kernel_report(cuda_kernel, name: str, kernel: str) -> tuple:
    """(SASS loop counts, report dict) for one library's kernel."""
    log = cuda_kernel.build_log(name)
    regs = [int(x) for x in re.findall(r"Used (\d+) registers", log)]
    spills = [int(x) for x in re.findall(r"(\d+) bytes spill (?:stores|loads)", log)]
    stack = [int(x) for x in re.findall(r"(\d+) bytes stack frame", log)]
    sass = sass_int_instructions(cuda_kernel.library_path(name), kernel)
    counts = sass["loop"]
    fma = sum(n for op, n in counts.items() if op in FMA_OPS)
    return counts, {
        "library": os.path.relpath(cuda_kernel.library_path(name), REPO),
        "registers": max(regs) if regs else None,
        "spill_bytes": sum(spills) if spills else None,
        "stack_frame_bytes": max(stack) if stack else None,
        "sass_int_instructions_per_nonce": sum(counts.values()),
        "sass_alu_pipe": sum(counts.values()) - fma, "sass_fma_pipe": fma,
        "sass_opcodes": dict(sorted(counts.items())),
        "sass_loop_bytes": [hex(a) for a in sass["loop_range"]],
        "sass_int_instructions_whole_kernel": sum(sass["function"].values()),
        "sass_local_memory_ops_in_loop": sass["local_memory_ops_in_loop"],
    }


def phase_build(state: dict) -> None:
    from tpu_dpow_torch.ops import cuda_kernel

    t0 = time.perf_counter()
    libs = cuda_kernel.load_libraries()
    build_s = time.perf_counter() - t0
    state["sass"], search_report = _kernel_report(cuda_kernel, "search", "b2_search_kernel")
    state["sass_run"], run_report = _kernel_report(cuda_kernel, "run", "b2_run_kernel")
    emit({
        "phase": "build", "ok": True, "seconds": build_s,
        **search_report,
        "blocks_per_row_b1": libs["search"].b2_blocks_per_row(1, 1 << 25),
        "run_kernel": {
            **run_report,
            "blocks_per_row": {b: libs["run"].b2_run_blocks_per_row(b) for b in (1, 16)},
        },
        "card": state["card"]["smi"],
    })


def _plant_rows(rng) -> list:
    """max_batch (16) (hash, difficulty, base) rows: 2 pads, a 2^32 and a
    2^64 carry, 11 rows whose expected first hit is 2^16 to 2^28 offsets in,
    and one dry row. The first rows are the cheap ones, so a batch of the
    first b rows stays cheap for the plain version."""
    def expect(k):  # difficulty whose expected first hit is ~2^k offsets in
        return (1 << 64) - (1 << (64 - k))

    rand_base = lambda: int(rng.integers(0, 1 << 63)) * 2 + int(rng.integers(0, 2))
    rows = [
        (rng.bytes(32), 0, rand_base()),  # pad
        (bytes(32), 0, 0),  # pad, as the engine packs it
        (rng.bytes(32), expect(14), (5 << 32) - 300),  # crosses 2^32
        (rng.bytes(32), expect(14), MAX_U64 - 300),  # crosses 2^64
    ]
    rows += [(rng.bytes(32), expect(k), rand_base())
             for k in (16, 18, 20, 21, 22, 23, 24, 25, 26, 27, 28)]
    rows.append((rng.bytes(32), MAX_U64, rand_base()))  # dry: scans the whole span
    return rows


def phase_kernel_vs_plain(state: dict) -> None:
    """The kernel against its plain version at every launch shape the
    engine emits: each padded batch size (the first b planted rows) at each
    run length's span (nblocks x steps windows), plus a lone hard request
    (one deep-hit row over the longest span) and the 16 rows at nblocks=1.
    The grid's blocks per row depend on the row count and the span, so each
    shape is its own check."""
    import numpy as np
    import torch

    from tpu_dpow_torch.backend.torch_backend import TorchWorkBackend
    from tpu_dpow_torch.ops import cuda_kernel, search

    eng = TorchWorkBackend()
    geo = dict(sublanes=eng.sublanes, iters=eng.iters, group=eng.group)
    rng = np.random.default_rng(SEED)
    rows = _plant_rows(rng)
    if len(rows) != eng.max_batch:
        raise AssertionError(f"{len(rows)} planted rows for max_batch {eng.max_batch}")
    host = np.stack([search.pack_params(h, d, b) for h, d, b in rows])
    params = search.params_from_numpy(host, "cuda")
    lib = cuda_kernel.load_library()
    cases = [(list(range(b)), eng.nblocks * steps)
             for steps in eng._step_counts() for b in eng._batch_sizes()]
    cases.append(([len(rows) - 2], eng.nblocks * eng.run_steps))  # lone hard request
    cases.append((list(range(len(rows))), 1))
    max_err, checks, full = 0, [], {}
    for idx, nblocks in cases:
        span = cuda_kernel.window(nblocks=nblocks, **geo)
        sub = params[idx].contiguous()
        t0 = time.perf_counter()
        got = search.offsets_to_numpy(
            cuda_kernel.cuda_search_chunk_batch(sub, nblocks=nblocks, **geo)
        )
        kernel_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = search.offsets_to_numpy(search.search_chunk_batch(sub, chunk_size=span))
        plain_s = time.perf_counter() - t0
        err = int(np.abs(got.astype(np.int64) - want.astype(np.int64)).max())
        max_err = max(max_err, err)
        if err:
            raise AssertionError(
                f"kernel != plain at rows {idx}, span {span}: {got} vs {want}"
            )
        for i, off in zip(idx, got):
            h, d, b = rows[i]
            if off != search.SENTINEL and ref_value(b + int(off), h) < d:
                raise AssertionError(f"offset {off} fails hashlib for row {i}")
            if d == 0 and off != 0:
                raise AssertionError(f"pad row {i} must hit at offset 0, got {off}")
            if d == MAX_U64 and off != search.SENTINEL:
                raise AssertionError(f"the dry row {i} found a solution")
        if len(idx) == len(rows):
            full[span] = [int(o) for o in got]
        checks.append({
            "rows": len(idx), "span": span,
            "blocks_per_row": lib.b2_blocks_per_row(len(idx), span),
            "hits": int((got != search.SENTINEL).sum()),
            "kernel_s": kernel_s, "plain_s": plain_s,
        })
    torch.cuda.synchronize()
    longest = full[max(full)]
    windows = sorted({o // eng.chunk for o in longest[4:-1] if o != search.SENTINEL})
    if len(windows) < 3:
        raise AssertionError(f"planted hits fell in too few engine windows: {windows}")
    # Carry rows really crossed their boundary.
    for i, bound in ((2, 5 << 32), (3, 1 << 64)):
        if rows[i][2] + longest[i] < bound:
            raise AssertionError(f"row {i} did not cross {bound:#x}")
    # The single-row wrapper against both, on every row, at nblocks=1.
    span1 = cuda_kernel.window(**geo)
    for i in range(len(rows)):
        k = int(search.offsets_to_numpy(cuda_kernel.cuda_search_chunk(params[i], **geo)))
        p = int(search.offsets_to_numpy(search.search_chunk(params[i], chunk_size=span1)))
        if not k == p == full[span1][i]:
            raise AssertionError(f"cuda_search_chunk row {i}: {k} vs plain {p}")
    state["max_abs_err"] = max_err
    emit({"phase": "kernel_vs_plain", "ok": True, "rows": len(rows), "max_abs_err": max_err,
          "tolerance": "bit-exact", "offsets": {str(k): v for k, v in sorted(full.items())},
          "hit_windows": windows, "checks": checks, "card": state["card"]["smi"]})


class TickClock:
    """Deterministic control stamps: every read advances 0.125 s, so the
    kernel's and the plain version's delivered latencies must agree."""

    def __init__(self):
        self.t = 0.0

    def time(self) -> float:
        self.t += 0.125
        return self.t


def scripted_control(rows: int, events: list):
    """A LaunchControl that fires each (k_min, action, row, arg) event at the
    first poll with k >= k_min, from inside the poll (delivery timing is then
    fixed by the loop, as tests/test_persistent.py scripts it)."""
    from tpu_dpow_torch.ops import control

    class Scripted(control.LaunchControl):
        def poll(self, dev, k, done):
            for i, (k_min, action, row, arg) in enumerate(events):
                if k >= k_min and i not in self.fired:
                    self.fired.add(i)
                    if action == "cancel":
                        self.cancel(row)
                    elif action == "kill":
                        self.kill(row)
                    elif action == "raise":
                        self.raise_difficulty(row, arg, epoch=1)
                    else:
                        self.rebase(row, arg, epoch=2)
            return super().poll(dev, k, done)

    c = Scripted(rows, clock=TickClock())
    c.fired = set()
    return c


def control_bookkeeping(c) -> dict:
    return {
        "polls": c.polls, "last_k": c.last_k,
        "done_at_k": sorted(c.done_at_k.items()), "delivered": list(c.delivered),
        "base": [c.effective_base(r) for r in range(c.rows)],
        "difficulty": [c.effective_difficulty(r) for r in range(c.rows)],
        "epoch": [c.effective_epoch(r, -1) for r in range(c.rows)],
    }


def _nonces(lo, hi) -> list:
    from tpu_dpow_torch.ops import search

    lo, hi = search.offsets_to_numpy(lo), search.offsets_to_numpy(hi)
    return [(int(h) << 32) | int(x) for x, h in zip(lo, hi)]


def _run_pair(params, *, window: int, geo: dict, max_steps: int, poll_steps=None,
              events=None, active=None) -> dict:
    """One launch of the run kernel and one of the plain run_loop_core on the
    same rows (and, with ``poll_steps``, the same scripted control) → their
    nonces, bookkeeping and times."""
    import torch

    from tpu_dpow_torch.ops import control, runloop

    out = {}
    for side in ("kernel", "plain"):
        c = slot = None
        if poll_steps is not None:
            c = scripted_control(params.shape[0], events or [])
            slot = control.register(c)
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if side == "kernel" and slot is None:
                lo, hi = runloop.search_run_batch(params, active, max_steps=max_steps, **geo)
            elif side == "kernel":
                lo, hi = runloop.search_run_batch_controlled(
                    params, active, slot, max_steps=max_steps, poll_steps=poll_steps, **geo)
            else:
                lo, hi = runloop.run_loop_core(
                    params, active, launch=runloop.plain_launch(window), window=window,
                    max_steps=max_steps, poll_steps=poll_steps or 0,
                    control_poll=None if slot is None else runloop.make_control_poll(slot))
            got = _nonces(lo, hi)
            seconds = time.perf_counter() - t0
        finally:
            if slot is not None:
                control.release(slot)
        out[side] = {"nonces": got, "seconds": seconds,
                     "control": None if c is None else control_bookkeeping(c)}
    return out


def _run_rows(rng) -> list:
    """16 (hash, difficulty, base) rows for the run loop over 2^22 windows:
    2 pads, a 2^64 carry, 12 rows whose expected first hit is 2^14 to 2^27
    offsets in (windows 0 to ~32), and one dry row."""
    def expect(k):
        return (1 << 64) - (1 << (64 - k))

    rand_base = lambda: int(rng.integers(0, 1 << 63)) * 2 + int(rng.integers(0, 2))
    rows = [
        (rng.bytes(32), 0, rand_base()),  # pad
        (bytes(32), 0, 0),  # pad, as the engine packs it
        (rng.bytes(32), expect(14), MAX_U64 - 300),  # crosses 2^64
    ]
    rows += [(rng.bytes(32), expect(k), rand_base())
             for k in (16, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 27)]
    rows.append((rng.bytes(32), MAX_U64, rand_base()))  # dry
    return rows


def phase_run_vs_plain(state: dict) -> None:
    """The persistent kernel against the plain run_loop_core on the card:
    bit-equal nonces and identical LaunchControl bookkeeping, for every
    scripted control, at poll steps 1 and 4, on 16 rows and on 1 row of
    2^22-nonce windows; then at every launch shape the persistent engine
    makes (1, 2, 4, 8 and 16 rows at its window, poll cadence and launch
    length), and once with a poll block past 2^30 offsets."""
    import numpy as np

    from tpu_dpow_torch.backend.torch_backend import TorchWorkBackend
    from tpu_dpow_torch.ops import cuda_kernel, search

    eng = TorchWorkBackend(run_mode="persistent")
    rng = np.random.default_rng(SEED + 3)
    rows = _run_rows(rng)
    host = np.stack([search.pack_params(h, d, b) for h, d, b in rows])
    small = dict(sublanes=32, iters=1024, nblocks=1, group=8)  # 2^22-nonce windows
    window = cuda_kernel.window(**small)
    harder = (1 << 64) - (1 << 39)  # expected first hit 2^25 offsets in
    rebase_to = int(rng.integers(0, 1 << 63))
    # (name, events for 16 rows, events for 1 row); row 9 is the 1-row set.
    scenarios = [
        ("none", [], []),
        ("cancel_k2", [(2, "cancel", 15, None), (2, "cancel", 12, None)],
         [(2, "cancel", 0, None)]),
        ("raise_k0", [(0, "raise", 6, harder)], [(0, "raise", 0, harder)]),
        ("rebase_k1", [(1, "rebase", 11, rebase_to)], [(1, "rebase", 0, rebase_to)]),
        ("kill", [(1, "kill", 14, None), (3, "rebase", 14, rebase_to)],
         [(1, "kill", 0, None)]),
    ]
    sets = {"rows16": host, "rows1": host[9:10]}
    max_steps, checks, max_err, plain_s = 5, [], 0, 0.0

    def check(label, pair, rows_host, extra=None):
        nonlocal max_err, plain_s
        k, p = pair["kernel"], pair["plain"]
        err = max(abs(a - b) for a, b in zip(k["nonces"], p["nonces"]))
        max_err = max(max_err, err)
        plain_s += p["seconds"]
        if err or k["control"] != p["control"]:
            raise AssertionError(f"run kernel != plain ({label}): {k} vs {p}")
        for i, n in enumerate(k["nonces"]):
            if n == MAX_U64:
                continue
            d = int(rows_host[i, search.DIFF_HI]) << 32 | int(rows_host[i, search.DIFF_LO])
            if k["control"] is not None and k["control"]["difficulty"][i] is not None:
                d = k["control"]["difficulty"][i]
            if ref_value(n, search_hash(rows_host[i])) < d:
                raise AssertionError(f"{label}: nonce {n:016x} of row {i} fails hashlib")
        checks.append({"case": label, "hits": sum(n != MAX_U64 for n in k["nonces"]),
                       "polls": None if k["control"] is None else k["control"]["polls"],
                       "kernel_s": k["seconds"], "plain_s": p["seconds"], **(extra or {})})

    for set_name, rows_host in sets.items():
        params = search.params_from_numpy(rows_host, "cuda")
        check(f"{set_name}/no_control", _run_pair(
            params, window=window, geo=small, max_steps=max_steps), rows_host)
        for poll_steps in (1, 4):
            for name, ev16, ev1 in scenarios:
                events = ev16 if set_name == "rows16" else ev1
                check(f"{set_name}/{name}/poll{poll_steps}", _run_pair(
                    params, window=window, geo=small, max_steps=max_steps,
                    poll_steps=poll_steps, events=events), rows_host)
    active = np.ones(len(rows), dtype=bool)
    active[[4, 9]] = False
    import torch

    check("rows16/active_mask", _run_pair(
        search.params_from_numpy(host, "cuda"), window=window, geo=small,
        max_steps=max_steps, active=torch.from_numpy(active).cuda()), host)

    # One row at the engine's full window, its first hit past window 2: the
    # search kernel (already held against its plain version) finds a seed.
    geo = dict(sublanes=eng.sublanes, iters=eng.iters, nblocks=eng.nblocks, group=eng.group)
    for attempt in range(64):
        row = search.pack_params(rng.bytes(32), (1 << 64) - (1 << 38), int(rng.integers(0, 1 << 62)))
        probe = search.params_from_numpy(row[None], "cuda")
        off = int(search.offsets_to_numpy(cuda_kernel.cuda_search_chunk_batch(
            probe, **{**geo, "nblocks": eng.nblocks * 16}))[0])
        if 2 * eng.chunk <= off < 6 * eng.chunk:
            break
    else:
        raise AssertionError("no seed put a first hit in engine windows 2-5")
    check("rows1/engine_window", _run_pair(
        probe, window=eng.chunk, geo=geo, max_steps=8,
        poll_steps=eng.control_poll_steps), row[None],
        extra={"hit_window": off // eng.chunk, "attempts": attempt + 1})
    _engine_launch_cases(eng, geo, rng, check)
    state["run_max_abs_err"] = max_err
    emit({"phase": "run_vs_plain", "ok": True, "max_abs_err": max_err,
          "tolerance": "bit-exact (nonces) and identical LaunchControl bookkeeping",
          "window": window, "max_steps": max_steps, "cases": len(checks),
          "plain_seconds": plain_s, "checks": checks, "card": state["card"]["smi"]})


def _planted(eng, geo: dict, rng, difficulty: int, count: int, windows: int) -> list:
    """``count`` random rows at ``difficulty`` with their first hit offset,
    found by the search kernel in one launch over ``windows`` engine
    windows; rows without a hit there are left out."""
    import numpy as np

    from tpu_dpow_torch.ops import cuda_kernel, search

    rows = np.stack([search.pack_params(rng.bytes(32), difficulty, int(rng.integers(0, 1 << 63)))
                     for _ in range(count)])
    offs = search.offsets_to_numpy(cuda_kernel.cuda_search_chunk_batch(
        search.params_from_numpy(rows, "cuda"), **{**geo, "nblocks": eng.nblocks * windows}))
    return [(row, int(o)) for row, o in zip(rows, offs) if o != search.SENTINEL]


def _row_base(row) -> int:
    from tpu_dpow_torch.ops import search

    return int(row[search.BASE_HI]) << 32 | int(row[search.BASE_LO])


def _with(row, *, difficulty=None, base=None):
    from tpu_dpow_torch.ops import search

    row = row.copy()
    for value, lo, hi in ((difficulty, search.DIFF_LO, search.DIFF_HI),
                          (base, search.BASE_LO, search.BASE_HI)):
        if value is not None:
            row[lo], row[hi] = value & 0xFFFFFFFF, value >> 32
    return row


def _engine_launch_cases(eng, geo: dict, rng, check, cut: int = 1 << 30) -> None:
    """The run kernel against the plain version at the persistent engine's
    own launch shapes: its window, poll cadence and launch length, at each
    batch size it packs (the batch sets each row's share of the blocks).

    Every batch has a row raised at k = 0 to a target it meets in windows
    0-3, a dry row cancelled at the poll at k = 2, rows with first hits
    planted in windows 0-3 and a pad as the engine packs it, so both loops
    exit within four windows. A last launch polls every 2 * ``cut`` offsets
    (64 windows), which the kernel scans as two spans of ``cut`` = 2^30
    (its span limit) with no poll between them; its row's first hit sits in
    the second span."""
    import numpy as np

    from tpu_dpow_torch.ops import search

    window, steps = eng.chunk, eng.persistent_steps
    hard = (1 << 64) - (1 << 64) // (2 * window)  # first hit ~2 windows in
    planted = iter(_planted(eng, geo, rng, hard, 48, 4))
    pad = search.pack_params(bytes(32), 0, 0)
    for b in (2, 4, 8, 16):
        hits = [next(planted) for _ in range(1 + max(0, b - 3))]
        raised, off = hits[0]
        rows = [_with(raised, difficulty=0),
                search.pack_params(rng.bytes(32), MAX_U64, int(rng.integers(0, 1 << 63)))]
        rows += [r for r, _ in hits[1:]] + [pad] * (b > 2)
        host = np.stack(rows)
        pair = _run_pair(search.params_from_numpy(host, "cuda"), window=window, geo=geo,
                         max_steps=steps, poll_steps=eng.control_poll_steps,
                         events=[(0, "raise", 0, hard), (2, "cancel", 1, None)])
        want = {0: off, **{i: o for i, (_, o) in enumerate(hits[1:], start=2)}}
        _expect_planted(f"rows{b}/engine_launch", pair, host, want)
        check(f"rows{b}/engine_launch", pair, host,
              extra={"hit_windows": sorted(o // window for o in want.values())})

    split_poll = 2 * cut // window
    far = (1 << 64) - (1 << 64) // (2 * cut)  # first hit ~2 * cut in
    for attempt in range(3):
        found = [(r, o) for r, o in _planted(eng, geo, rng, far, 24, split_poll - 1)
                 if o >= cut + 2 * window]
        if found:
            break
    else:
        raise AssertionError("no seed put a first hit in [cut + 2 windows, 2 * cut)")
    row, off = found[0]
    # No hit lies in [base, base + off), so from the later base the first
    # hit is at offset cut + window + window // 7, in the second span's second window.
    at = cut + window + window // 7
    row = _with(row, base=(_row_base(row) + off - at) & MAX_U64)[None]
    pair = _run_pair(search.params_from_numpy(row, "cuda"), window=window, geo=geo,
                     max_steps=steps, poll_steps=split_poll)
    _expect_planted("rows1/split_span", pair, row, {0: at})
    check("rows1/split_span", pair, row,
          extra={"hit_window": at // window, "poll_steps": split_poll, "attempts": attempt + 1})


def _expect_planted(label: str, pair: dict, rows, want: dict) -> None:
    """Both loops must return each planted row's known first hit."""
    for i, off in want.items():
        nonce = (_row_base(rows[i]) + off) & MAX_U64
        for side in ("kernel", "plain"):
            if pair[side]["nonces"][i] != nonce:
                raise AssertionError(
                    f"{label}: {side} row {i} gave {pair[side]['nonces'][i]:016x}, "
                    f"planted {nonce:016x}")


def search_hash(row) -> bytes:
    """The 32-byte block hash packed in a params row's message words."""
    import numpy as np

    return np.ascontiguousarray(row[:8], dtype=np.uint32).tobytes()


async def _engine(state: dict) -> dict:
    import numpy as np

    from tpu_dpow_torch.backend import WorkCancelled
    from tpu_dpow_torch.backend.torch_backend import TorchWorkBackend
    from tpu_dpow_torch.models import WorkRequest
    from tpu_dpow_torch.ops import cuda_kernel

    rng = np.random.default_rng(SEED + 1)
    new_hash = lambda: rng.bytes(32).hex().upper()
    latencies, solves = [], 0

    async def solve(h: str, difficulty: int) -> None:
        nonlocal solves
        t0 = time.perf_counter()
        work = await backend.generate(WorkRequest(h, difficulty))
        latencies.append(time.perf_counter() - t0)
        if ref_value(int(work, 16), bytes.fromhex(h)) < difficulty:
            raise AssertionError(f"invalid work {work} for {h} at {difficulty:016x}")
        solves += 1

    cuda_kernel.reset_launches()
    backend = TorchWorkBackend()
    await backend.setup()
    t_start = time.perf_counter()
    for _ in range(8):
        await solve(new_hash(), MAINNET)
    singles_s = time.perf_counter() - t_start
    t_burst = time.perf_counter()
    await asyncio.gather(
        *[solve(new_hash(), MAINNET) for _ in range(backend.max_batch)],
        *[solve(new_hash(), RECEIVE) for _ in range(backend.max_batch)],
    )
    burst_s = time.perf_counter() - t_burst
    served_s = time.perf_counter() - t_start
    hashes = backend.total_hashes

    # Cancel mid-flight at an unreachable difficulty.
    h = new_hash()
    task = asyncio.ensure_future(backend.generate(WorkRequest(h, MAX_U64)))
    await asyncio.sleep(0.2)
    t0 = time.perf_counter()
    await backend.cancel(h)
    try:
        await asyncio.wait_for(task, 5.0)
        raise AssertionError("cancelled request returned work")
    except WorkCancelled:
        cancel_s = time.perf_counter() - t0

    # Raise a queued receive-difficulty job to mainnet before its first result.
    h = new_hash()
    task = asyncio.ensure_future(backend.generate(WorkRequest(h, RECEIVE)))
    await asyncio.sleep(0)
    if not await backend.raise_difficulty(h, MAINNET):
        raise AssertionError("raise_difficulty did not take")
    work = await asyncio.wait_for(task, 60.0)
    if ref_value(int(work, 16), bytes.fromhex(h)) < MAINNET:
        raise AssertionError(f"raised job returned work below the raised target: {work}")
    await backend.close()

    # The same engine behind the nano-work-server HTTP protocol.
    import aiohttp

    from tpu_dpow_torch.workserver import WorkServer

    server = WorkServer(TorchWorkBackend(), port=0)
    await server.start()
    t_http = time.perf_counter()
    try:
        async with aiohttp.ClientSession() as http:
            async def post(payload: dict) -> dict:
                async with http.post(f"http://127.0.0.1:{server.port}/", json=payload) as r:
                    return await r.json()

            http_hashes = [new_hash() for _ in range(4)]
            replies = await asyncio.gather(*[
                post({"action": "work_generate", "hash": h, "difficulty": f"{MAINNET:016x}"})
                for h in http_hashes
            ])
            for h, reply in zip(http_hashes, replies):
                if ref_value(int(reply["work"], 16), bytes.fromhex(h)) < MAINNET:
                    raise AssertionError(f"server returned invalid work {reply} for {h}")
            check = await post({"action": "work_validate", "hash": http_hashes[0],
                                "work": replies[0]["work"], "difficulty": f"{MAINNET:016x}"})
            if check.get("valid") != "1":
                raise AssertionError(f"work_validate rejected served work: {check}")
    finally:
        await server.stop()
    http_s = time.perf_counter() - t_http
    launches = cuda_kernel.launches
    if launches <= 0:
        raise AssertionError("the engine never launched the CUDA kernel")
    lat = np.array(latencies) * 1e3
    return {
        "phase": "engine", "ok": True, "solves": solves + 1 + len(replies),
        "launches": launches,
        # Self-tests and the cancelled request's launches included.
        "launches_per_solve": launches / (solves + 1 + len(replies)),
        "hashes_scanned": hashes, "served_seconds": served_s,
        "hashes_per_second": hashes / served_s,
        "singles_seconds": singles_s, "burst_seconds": burst_s,
        "latency_ms_p50": float(np.percentile(lat, 50)),
        "latency_ms_p99": float(np.percentile(lat, 99)),
        "cancel_ms": cancel_s * 1e3, "raised_work": work,
        "http_solves": len(replies), "http_seconds": http_s,
        "card": state["card"]["smi"],
    }


def phase_engine(state: dict) -> None:
    result = asyncio.run(_engine(state))
    state["launches"] = result["launches"]
    emit(result)


def _dump_engine(backend) -> None:
    """What a stuck wait needs to be read: the engine's in-flight launches,
    their control bookkeeping, the kernel counters and every thread's stack
    (to standard error)."""
    import faulthandler

    from tpu_dpow_torch.ops import cuda_kernel

    for rec in list(getattr(backend, "_inflight", ())):
        c = rec.control
        print(json.dumps({
            "launch": [j.block_hash[:8] for j in rec.jobs], "steps": rec.steps,
            "fut_done": rec.fut.done(),
            "control": None if c is None else {
                "polls": c.polls, "last_k": c.last_k, "delivered": c.delivered,
                "done_at_k": sorted(c.done_at_k.items())},
        }, default=str), file=sys.stderr, flush=True)
    print(json.dumps({"run_launches": cuda_kernel.run_launches,
                      "poll_stats": cuda_kernel.run_poll_stats}), file=sys.stderr, flush=True)
    faulthandler.dump_traceback(all_threads=True)


async def _wait_for(pred, what: str, timeout: float = 30.0, backend=None) -> None:
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    while not pred():
        if loop.time() > deadline:
            if backend is not None:
                _dump_engine(backend)
            raise AssertionError(f"timed out waiting for {what}")
        await asyncio.sleep(0.001)


async def _result(backend, task, what: str, timeout: float = 60.0):
    """``await task`` within ``timeout``, dumping the engine if it runs out."""
    await _wait_for(task.done, what, timeout, backend)
    return task.result()


async def _running_control(backend, h: str):
    """(rec, row) of the newest in-flight launch carrying job ``h`` once its
    kernel has polled at least once (it is running on the card)."""
    found = []

    def ready():
        job = backend._jobs.get(h)
        recs = backend._live_controls(job) if job is not None else []
        found[:] = recs[-1:]
        return bool(recs) and recs[-1][0].control.polls > 0

    await _wait_for(ready, f"a running persistent launch of {h[:8]}", backend=backend)
    return found[0]


async def _cancel_ab(mode: str, n: int, rng) -> dict:
    """benchmarks/cancel_latency.py's drain trial on the port: an easy solo
    request, then a hard job cancelled after 0.25 s while a fresh easy
    request is timed (post_cancel) and the job's launches drain
    (cancel_to_stop: no in-flight launch carries it any more)."""
    import numpy as np

    from tpu_dpow_torch.backend import WorkCancelled
    from tpu_dpow_torch.backend.torch_backend import TorchWorkBackend
    from tpu_dpow_torch.models import WorkRequest

    backend = TorchWorkBackend(run_mode=mode)
    await backend.setup()
    new_hash = lambda: rng.bytes(32).hex().upper()
    solo, post, stop = [], [], []

    async def drained(h: str) -> float:
        t0 = time.perf_counter()
        await _wait_for(lambda: not any(
            any(j.block_hash == h for j in rec.jobs) for rec in backend._inflight
        ), "the cancelled job to drain", timeout=60.0)
        return time.perf_counter() - t0

    for _ in range(n):
        t0 = time.perf_counter()
        await backend.generate(WorkRequest(new_hash(), RECEIVE))
        solo.append(time.perf_counter() - t0)
        hard = new_hash()
        task = asyncio.ensure_future(backend.generate(WorkRequest(hard, MAX_U64 - 1)))
        await asyncio.sleep(0.25)
        t0 = time.perf_counter()
        await backend.cancel(hard)
        stop_task = asyncio.ensure_future(drained(hard))
        await backend.generate(WorkRequest(new_hash(), RECEIVE))
        post.append(time.perf_counter() - t0)
        stop.append(await stop_task)
        try:
            await task
            raise AssertionError("the cancelled hard job returned work")
        except WorkCancelled:
            pass
    await backend.close()
    ms = lambda xs: [x * 1e3 for x in xs]
    return {
        "run_mode": mode, "n": n,
        "solo_ms": ms(solo), "post_cancel_ms": ms(post), "cancel_to_stop_ms": ms(stop),
        "solo_p50_ms": float(np.percentile(ms(solo), 50)),
        "post_cancel_p50_ms": float(np.percentile(ms(post), 50)),
        "cancel_to_stop_p50_ms": float(np.percentile(ms(stop), 50)),
        "launch_windows_cap": backend.persistent_steps if mode == "persistent" else backend.run_steps,
        "bound_windows": backend.control_poll_steps if mode == "persistent"
        else backend.run_steps + (backend.pipeline - 1) * backend.shared_steps_cap,
    }


async def _persistent(state: dict) -> dict:
    import numpy as np

    from tpu_dpow_torch import obs
    from tpu_dpow_torch.backend.torch_backend import TorchWorkBackend
    from tpu_dpow_torch.models import WorkRequest
    from tpu_dpow_torch.ops import cuda_kernel

    rng = np.random.default_rng(SEED + 4)
    new_hash = lambda: rng.bytes(32).hex().upper()
    latencies, solves = [], 0

    def check(h: str, work: str, difficulty: int) -> None:
        nonlocal solves
        if ref_value(int(work, 16), bytes.fromhex(h)) < difficulty:
            raise AssertionError(f"invalid work {work} for {h} at {difficulty:016x}")
        solves += 1

    async def solve(h: str, difficulty: int) -> None:
        t0 = time.perf_counter()
        work = await backend.generate(WorkRequest(h, difficulty))
        latencies.append(time.perf_counter() - t0)
        check(h, work, difficulty)

    obs.reset()
    cuda_kernel.reset_launches()
    backend = TorchWorkBackend(run_mode="persistent")
    await backend.setup()
    t_start = time.perf_counter()
    for _ in range(8):
        await solve(new_hash(), MAINNET)
    singles_s = time.perf_counter() - t_start
    t_burst = time.perf_counter()
    await asyncio.gather(
        *[solve(new_hash(), MAINNET) for _ in range(backend.max_batch)],
        *[solve(new_hash(), RECEIVE) for _ in range(backend.max_batch)],
    )
    burst_s = time.perf_counter() - t_burst

    # Mid-launch raise: delivered to the running kernel at its next poll. A
    # job that solves before that poll (about 1.6 % at this target) proves
    # nothing mid-launch, so it is retried with a new hash.
    raise_from, raise_to = 0xFFFFFFFF00000000, 0xFFFFFFFF80000000
    for attempt in range(1, 4):
        h = new_hash()
        task = asyncio.ensure_future(backend.generate(WorkRequest(h, raise_from)))
        rec, row = await _running_control(backend, h)
        took = await backend.raise_difficulty(h, raise_to)
        work = await _result(backend, task, "the raised job")
        check(h, work, raise_to if took else raise_from)
        if took and any(a == "raise" for r, a, _l, _t in rec.control.delivered if r == row):
            break
    else:
        raise AssertionError("no raise_difficulty landed mid-launch in 3 tries")
    raised = {"work": work, "attempts": attempt,
              "effective_difficulty": f"{rec.control.effective_difficulty(row):016x}"}

    # Mid-launch cover_range: the running kernel is re-aimed at range B.
    cover_d, start_a, start_b = 0xFFFFFFFF00000000, 3 << 40, 0x5A5A << 44
    for attempt in range(1, 4):
        h = new_hash()
        task = asyncio.ensure_future(
            backend.generate(WorkRequest(h, cover_d, nonce_range=(start_a, 1 << 40))))
        rec, row = await _running_control(backend, h)
        took = await backend.cover_range(h, (start_b, 1 << 40))
        work = await _result(backend, task, "the re-covered job")
        check(h, work, cover_d)
        if took and int(work, 16) >= start_b:
            if "rebase" not in [a for r, a, _l, _t in rec.control.delivered if r == row]:
                raise AssertionError("work came from range B but no rebase was delivered")
            if int(work, 16) >= start_b + (1 << 40):
                raise AssertionError(f"cover_range work {work} is past range B")
            break
    else:
        raise AssertionError("no cover_range landed mid-launch in 3 tries")
    covered = {"work": work, "attempts": attempt, "range_b": f"{start_b:016x}"}
    served_s = time.perf_counter() - t_start
    hashes = backend.total_hashes
    await backend.close()
    run_launches, search_launches = cuda_kernel.run_launches, cuda_kernel.launches
    stats = dict(cuda_kernel.run_poll_stats)
    if run_launches <= 0:
        raise AssertionError("the persistent engine never launched the run kernel")
    if search_launches:
        raise AssertionError(f"persistent mode launched the chunk kernel {search_launches} times")
    snap = obs.snapshot()
    control = snap["dpow_backend_persistent_control_total"]["series"]
    lat = np.array(latencies) * 1e3

    ab_rng = np.random.default_rng(SEED + 5)
    ab = [await _cancel_ab(mode, 5, ab_rng) for mode in ("chunked", "persistent")]
    return {
        "phase": "persistent", "ok": True, "solves": solves,
        "run_launches": run_launches, "search_launches": search_launches,
        "launches_per_solve": run_launches / solves,
        "polls": stats["polls"],
        "poll_round_trip_us_mean": stats["round_trip_ns"] / max(1, stats["polls"]) / 1e3,
        "poll_round_trip_us_max": stats["round_trip_ns_max"] / 1e3,
        "queued_ms_total": stats["queued_ns"] / 1e6, "queued_ms_max": stats["queued_ns_max"] / 1e6,
        "polls_served_metric": snap["dpow_backend_persistent_polls_total"]["series"].get(""),
        "control_delivered": control,
        "hashes_scanned": hashes, "served_seconds": served_s,
        "hashes_per_second": hashes / served_s,
        "singles_seconds": singles_s, "burst_seconds": burst_s,
        "latency_ms_p50": float(np.percentile(lat, 50)),
        "latency_ms_p99": float(np.percentile(lat, 99)),
        "raised": raised, "covered": covered,
        "control_poll_steps": backend.control_poll_steps,
        "persistent_steps": backend.persistent_steps,
        "cancel_ab": ab,
        "card": state["card"]["smi"],
    }


def phase_persistent(state: dict) -> None:
    result = asyncio.run(_persistent(state))
    state["run_launches"] = result["run_launches"]
    emit(result)


def phase_kernel_time(state: dict) -> None:
    import numpy as np
    import torch

    from tpu_dpow_torch.backend.torch_backend import TorchWorkBackend
    from tpu_dpow_torch.ops import cuda_kernel, search

    eng = TorchWorkBackend()
    geo = dict(sublanes=eng.sublanes, iters=eng.iters, nblocks=eng.nblocks, group=eng.group)
    span = cuda_kernel.window(**geo)
    rng = np.random.default_rng(SEED + 2)
    host = np.stack([
        search.pack_params(rng.bytes(32), MAX_U64, int(rng.integers(0, 1 << 62)))
        for _ in range(eng.max_batch)
    ])
    params = search.params_from_numpy(host, "cuda")

    def timed(fn, reps: int) -> float:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    run_kernel = lambda: cuda_kernel.cuda_search_chunk_batch(params, **geo)
    run_plain = lambda: search.search_chunk_batch(params, chunk_size=span)
    # A lone hard request's launch: one row over run_steps windows.
    run_single = lambda: cuda_kernel.cuda_search_chunk_batch(
        params[:1], **{**geo, "nblocks": eng.nblocks * eng.run_steps}
    )
    run_kernel()  # warm-up
    torch.cuda.synchronize()
    kernel_ms = timed(run_kernel, 10)
    plain_ms = timed(run_plain, 1)
    kernel_ms_after = timed(run_kernel, 10)
    single_ms = timed(run_single, 5)
    nonces = eng.max_batch * span
    c = state["card"]
    op_bound_ms = op_bound_seconds(state["sass"], nonces, c["sms"], c["max_sm_mhz"]) * 1e3
    # The coarser bound that treats every integer instruction as one of the
    # SM's 64 INT32 lanes per clock (no ALU/FMA pipe split).
    int32_lane_bound_ms = (
        sum(state["sass"].values()) * nonces
        / (PIPE_LANES_PER_SM * c["sms"] * c["max_sm_mhz"] * 1e6) * 1e3
    )
    byte_bound_ms = eng.max_batch * (search.PARAMS_LEN * 4 + 4) / HBM_BYTES_PER_S * 1e3
    state["time"] = {
        "ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": max(op_bound_ms, byte_bound_ms),
        "bound_by": "operations" if op_bound_ms >= byte_bound_ms else "bytes",
    }
    run = _time_run_kernel(state, eng, params, timed)
    emit({
        "phase": "kernel_time", "ok": True, "rows": eng.max_batch, "span": span,
        "nonces": nonces, "kernel_ms": kernel_ms, "kernel_ms_repeat": kernel_ms_after,
        "plain_ms": plain_ms, "kernel_hashes_per_second": nonces / (kernel_ms / 1e3),
        "plain_hashes_per_second": nonces / (plain_ms / 1e3),
        "single_row_run_nonces": span * eng.run_steps, "single_row_run_ms": single_ms,
        "int_instr_per_nonce": sum(state["sass"].values()), "op_bound_ms": op_bound_ms,
        "int32_lane_bound_ms": int32_lane_bound_ms,
        "byte_bound_ms": byte_bound_ms, "bound_share": op_bound_ms / kernel_ms,
        "run_kernel": run,
        "sms": c["sms"], "max_sm_mhz": c["max_sm_mhz"], "card": c["smi"],
    })


def _time_run_kernel(state: dict, eng, params, timed) -> dict:
    """The persistent run kernel alone at max_batch rows x RUN_TIME_STEPS
    engine windows without control (every row dry: the whole span is
    scanned), its plain version once on the same rows, and one row over 16
    windows with and without a control channel at the engine's poll cadence
    (a dead slot: every poll answers zeros), which prices the polls."""
    from tpu_dpow_torch.ops import cuda_kernel, runloop

    window = eng.chunk
    run_kernel = lambda: cuda_kernel.cuda_search_run_batch(
        params, None, window=window, max_steps=RUN_TIME_STEPS)
    run_plain = lambda: runloop.run_loop_core(
        params, None, launch=runloop.plain_launch(window), window=window,
        max_steps=RUN_TIME_STEPS)
    one = params[:1]
    one_free = lambda: cuda_kernel.cuda_search_run_batch(one, None, window=window, max_steps=16)
    one_polled = lambda: cuda_kernel.cuda_search_run_batch_controlled(
        one, None, 0, window=window, max_steps=16, poll_steps=eng.control_poll_steps)
    run_kernel()  # warm-up
    ms = timed(run_kernel, 5)
    plain_ms = timed(run_plain, 1)
    ms_repeat = timed(run_kernel, 5)
    polls_before = cuda_kernel.run_poll_stats["polls"]
    one_free_ms, one_polled_ms = timed(one_free, 3), timed(one_polled, 3)
    polls = (cuda_kernel.run_poll_stats["polls"] - polls_before) // 3
    nonces = params.shape[0] * RUN_TIME_STEPS * window
    c = state["card"]
    op_bound_ms = op_bound_seconds(state["sass_run"], nonces, c["sms"], c["max_sm_mhz"]) * 1e3
    byte_bound_ms = params.shape[0] * (12 * 4 + 8) / HBM_BYTES_PER_S * 1e3
    state["run_time"] = {
        "ms": ms, "plain_ms": plain_ms, "bound_ms": max(op_bound_ms, byte_bound_ms),
        "bound_by": "operations" if op_bound_ms >= byte_bound_ms else "bytes",
    }
    return {
        "rows": params.shape[0], "windows": RUN_TIME_STEPS, "window": window,
        "nonces": nonces, "ms": ms, "ms_repeat": ms_repeat, "plain_ms": plain_ms,
        "hashes_per_second": nonces / (ms / 1e3), "op_bound_ms": op_bound_ms,
        "byte_bound_ms": byte_bound_ms, "bound_share": op_bound_ms / ms,
        "int_instr_per_nonce": sum(state["sass_run"].values()),
        "one_row_16_windows_ms": one_free_ms,
        "one_row_16_windows_polled_ms": one_polled_ms,
        "polls_per_polled_launch": polls,
        "poll_cost_us": (one_polled_ms - one_free_ms) * 1e3 / max(1, polls),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--phases", default=",".join(PHASES),
                   help=f"comma-separated subset of {','.join(PHASES)} (build always runs)")
    ns = p.parse_args(argv)
    phases = ["build"] + [x for x in ns.phases.split(",") if x and x != "build"]
    for name in phases:
        if name not in PHASES:
            p.error(f"unknown phase {name!r}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    state = {"card": card()}
    try:
        for name in phases:
            globals()[f"phase_{name}"](state)
    except BaseException:
        # A failed phase may leave a launch thread behind (a kernel that
        # never returned): exit at once instead of joining it at shutdown.
        import traceback

        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)
    print(state["card"]["smi"], flush=True)
    if set(PHASES) <= set(phases):
        t, r = state["time"], state["run_time"]
        emit({"kernels": [{
            "name": "blake2b_search", "route": "cuda",
            "source": "tpu_dpow_torch/ops/csrc/blake2b_search.cu",
            "replaces": "tpu_dpow/ops/pallas_kernel.py:239",
            "launches": state["launches"], "max_abs_err": state["max_abs_err"],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None,
        }, {
            "name": "blake2b_run", "route": "cuda",
            "source": "tpu_dpow_torch/ops/csrc/blake2b_run.cu",
            "replaces": "tpu_dpow/ops/runloop.py:51",
            "launches": state["run_launches"], "max_abs_err": state["run_max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
        }]})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
