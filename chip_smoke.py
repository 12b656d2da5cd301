#!/usr/bin/env python3
"""Run the PyTorch + CUDA port on one GPU: build, check, drive, time.

    python3 chip_smoke.py [--phases build,kernel_vs_plain,engine,kernel_time]

Drives ``tpu_dpow_torch`` only (never the JAX package). Each phase prints one
JSON line; a failed phase raises, and the script exits nonzero without its
result lines.

  build            nvcc-builds the Blake2b search kernel from the checkout's
                   sources; prints ptxas' register/spill report and the
                   kernel's integer-instruction count from its SASS.
  kernel_vs_plain  16 seeded rows (pads, 2^32 and 2^64 carries, hits planted
                   in different windows, one dry row) through the kernel and
                   its plain PyTorch version on the card, at every launch
                   shape the engine emits (1-16 rows x 1, 4, 16 windows), a
                   lone hard request, and nblocks=1: bit-equal or fail.
  engine           TorchWorkBackend at mainnet difficulty: 8 single requests,
                   a 16+16 concurrent burst at two difficulties, a cancel and
                   a raise_difficulty; then the work server (HTTP on
                   127.0.0.1) answers 4 concurrent work_generate requests and
                   a work_validate. Every work string is checked with
                   hashlib. The kernel's launch count is reset just before
                   and read just after, and must be > 0.
  kernel_time      the kernel alone and its plain version at one engine launch
                   shape (max_batch rows, one window, unreachable difficulty so
                   every row scans the whole window), timed with CUDA events,
                   beside the integer-issue bound.

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

PHASES = ("build", "kernel_vs_plain", "engine", "kernel_time")
MAINNET = 0xFFFFFFF800000000  # send/change blocks
RECEIVE = 0xFFFFFE0000000000  # receive blocks
MAX_U64 = (1 << 64) - 1
SEED = 2026

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


def sass_int_instructions(lib_path: str) -> dict:
    """Per-nonce integer instructions of the search kernel, by opcode: the
    static count inside its grid-stride loop (from the target of the
    longest backward branch to that branch), so the prologue (row loads,
    grid setup) and the exit, which run once per thread, are left out. The
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
            inside = "b2_search_kernel" in line
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
    loop = None  # (target, branch address) of the longest backward branch
    for addr, op, operands in instrs:
        t = _SASS_TARGET.findall(operands) if op == "BRA" else []
        if not t:
            continue
        target = labels.get(t[-1]) if t[-1].startswith(".") else int(t[-1], 16)
        if target is not None and target < addr and (loop is None or addr - target > loop[1] - loop[0]):
            loop = (target, addr)
    if loop is None:
        raise RuntimeError("no loop back-edge found in the search kernel's SASS")

    def count(pred) -> dict:
        out = {}
        for addr, op, _ in instrs:
            if op in ALU_OPS | FMA_OPS and pred(addr):
                out[op] = out.get(op, 0) + 1
        return out

    result = {
        "loop": count(lambda a: loop[0] <= a <= loop[1]),
        "function": count(lambda a: True),
        "loop_range": [loop[0], loop[1]],
    }
    if not result["loop"]:
        raise RuntimeError("no integer instructions found in the kernel's search loop")
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


def phase_build(state: dict) -> None:
    from tpu_dpow_torch.ops import cuda_kernel

    t0 = time.perf_counter()
    cuda_kernel.load_library()
    build_s = time.perf_counter() - t0
    log = cuda_kernel.build_log()
    regs = [int(x) for x in re.findall(r"Used (\d+) registers", log)]
    spills = [int(x) for x in re.findall(r"(\d+) bytes spill (?:stores|loads)", log)]
    stack = [int(x) for x in re.findall(r"(\d+) bytes stack frame", log)]
    sass = sass_int_instructions(cuda_kernel.library_path())
    counts = state["sass"] = sass["loop"]
    fma = sum(n for op, n in counts.items() if op in FMA_OPS)
    emit({
        "phase": "build", "ok": True, "seconds": build_s,
        "library": os.path.relpath(cuda_kernel.library_path(), REPO),
        "registers": max(regs) if regs else None,
        "spill_bytes": sum(spills) if spills else None,
        "stack_frame_bytes": max(stack) if stack else None,
        "sass_int_instructions_per_nonce": sum(counts.values()),
        "sass_alu_pipe": sum(counts.values()) - fma, "sass_fma_pipe": fma,
        "sass_opcodes": dict(sorted(counts.items())),
        "sass_loop_bytes": [hex(a) for a in sass["loop_range"]],
        "sass_int_instructions_whole_kernel": sum(sass["function"].values()),
        "blocks_per_row_b1": cuda_kernel.load_library().b2_blocks_per_row(1, 1 << 25),
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
    emit({
        "phase": "kernel_time", "ok": True, "rows": eng.max_batch, "span": span,
        "nonces": nonces, "kernel_ms": kernel_ms, "kernel_ms_repeat": kernel_ms_after,
        "plain_ms": plain_ms, "kernel_hashes_per_second": nonces / (kernel_ms / 1e3),
        "plain_hashes_per_second": nonces / (plain_ms / 1e3),
        "single_row_run_nonces": span * eng.run_steps, "single_row_run_ms": single_ms,
        "int_instr_per_nonce": sum(state["sass"].values()), "op_bound_ms": op_bound_ms,
        "int32_lane_bound_ms": int32_lane_bound_ms,
        "byte_bound_ms": byte_bound_ms, "bound_share": op_bound_ms / kernel_ms,
        "sms": c["sms"], "max_sm_mhz": c["max_sm_mhz"], "card": c["smi"],
    })


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
    for name in phases:
        globals()[f"phase_{name}"](state)
    print(state["card"]["smi"], flush=True)
    if set(PHASES) <= set(phases):
        t = state["time"]
        emit({"kernels": [{
            "name": "blake2b_search", "route": "cuda",
            "source": "tpu_dpow_torch/ops/csrc/blake2b_search.cu",
            "replaces": "tpu_dpow/ops/pallas_kernel.py:239",
            "launches": state["launches"], "max_abs_err": state["max_abs_err"],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None,
        }]})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
