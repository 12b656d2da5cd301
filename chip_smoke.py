#!/usr/bin/env python3
"""Build the PyTorch + CUDA port's kernels on the visible GPU, count what the
engine launches of them, and time them.

    python3 chip_smoke.py

Drives ``tpu_dpow_torch`` only (never the JAX package). Each phase prints one
JSON line; a failed phase raises, and the script exits nonzero without its
result lines. Whether the kernels are right at every shape is the
``cuda``-marked tests' job (``python -m pytest --noconftest -m cuda`` over
``tests/test_torch_*.py``); this script reports what they do not: the build,
the main path's launches and the times.

  build        nvcc-builds both kernels (the Blake2b search kernel and the
               persistent run kernel) from the checkout's sources, one nvcc
               per source started together; prints ptxas' register/spill
               report and each kernel's per-nonce integer-instruction count
               from its SASS, by pipe, with the half-rate IMAD.HI and
               IMAD.WIDE and the local-memory ops inside the scan loop.
  kernel_time  first the main path: the engine (TorchWorkBackend) chunked,
               persistent, fanned over every card (persistent, interleaved)
               and ganged over every card, each serving a burst of
               max_batch send- and max_batch receive-difficulty requests
               with the kernel wrappers' launch counts zeroed after its
               set-up, every work checked with hashlib; and the controlled
               run wrapper the persistent engine calls, at its window, poll
               cadence and launch length, held bit-exact against the plain
               run loop under a raise and a cancel. Then each kernel alone
               and its plain version: the search kernel at one engine
               launch shape (max_batch rows, one window) and a lone row
               over run_steps windows; the run kernel at max_batch rows x 2
               windows without control, contiguous and strided (4 windows
               apart), the same nonces as one live row of max_batch (the
               others inactive: the re-granted grid), and one row over 16
               windows with and without polls; one fanned and one ganged
               launch over every card. Unreachable difficulty, so every row
               scans it all; CUDA events (host clock for the fan and the
               mesh, whose results come back to the host). Each time is
               given as its share of the card's roofline
               (``dpowbench.roofline``) at the card's maximum SM clock; a
               fan or mesh at one card's share, since its members run at
               once. The timed results must equal the plain versions'.

The last lines are the kernel table as JSON (each kernel's main-path
launches and times), then ``{"ok": true, "device": {...}}``. Exits 2
without a result when no CUDA device is visible.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import re
import shutil
import subprocess
import sys
import time

MAX_U64 = (1 << 64) - 1
SEED = 2026
# Nano's send and receive thresholds: the main path's burst.
SEND = 0xFFFFFFF800000000
RECEIVE = 0xFFFFFE0000000000
# Windows per row of the run kernel's timed launch, and the stride of its
# strided launch, in windows.
RUN_TIME_STEPS = 2
STRIDE_WINDOWS = 4

# Per-thread integer opcodes counted from the SASS, by pipe (uniform-datapath
# U* ops run once per warp and are not counted): integer add, logic, shift
# and compare issue on the ALU pipe, integer multiply-add (IMAD, which the
# compiler also uses for moves and adds) and the byte dot products (IDP, the
# rotations of blake2b_search.cuh) on the FMA pipe.
ALU_OPS = {
    "IADD3", "IADD", "LOP3", "LOP", "SHF", "SHL", "SHR", "PRMT", "ISETP", "ICMP",
    "SEL", "LEA", "IMNMX", "VIMNMX", "MOV", "IABS", "POPC", "FLO", "BREV", "BMSK",
    "SGXT",
}
FMA_OPS = {"IMAD", "IMUL", "IDP"}

REPO = os.path.dirname(os.path.abspath(__file__))


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0].strip()


_SASS_LINE = re.compile(r"\s*/\*([0-9a-f]+)\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z0-9_]+)([^;]*);")
_SASS_TARGET = re.compile(r"(0x[0-9a-f]+|\.L_x_\d+)")


#: FMA-pipe forms the H100 issues at half rate (32 lanes per SM per clock
#: alone, against 64 for IMAD, IMAD.X, IDP and the ALU pipe's LOP3 and SHF),
#: and which in the scan loop slow the ALU pipe's work beside them: a rotate
#: half or an add moved into them costs more than it frees
#: (blake2b_search.cuh). Counted where the multiplier is a register or a
#: constant word, not where it is an immediate: an address's stride.
HALF_RATE_FORMS = ("IMAD.HI", "IMAD.WIDE")


def sass_int_instructions(lib_path: str, kernel: str = "b2_search_kernel") -> dict:
    """``count_sass`` of ``kernel`` in the SASS that cuobjdump reads from the
    library at ``lib_path``."""
    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(cuobjdump):
        cuobjdump = shutil.which("cuobjdump") or cuobjdump
    sass = subprocess.run(
        [cuobjdump, "-sass", lib_path], capture_output=True, text=True, check=True,
        timeout=120,
    ).stdout
    return count_sass(sass, kernel)


def count_sass(sass: str, kernel: str) -> dict:
    """Per-nonce integer instructions of ``kernel`` in a cuobjdump listing,
    by opcode: the static count inside its scan loop (the smallest loop,
    from a backward branch's target to that branch, that holds the Blake2b
    body's 1,000+ integer instructions), so the prologue (row loads, grid
    setup), the exit and, in the run kernel, the poll and fold around the
    scan are left out. The body is straight-line (12 unrolled rounds), so
    each opcode in the loop runs once per nonce. Returns {"loop": counts,
    "function": counts, "loop_range": [first, last] byte addresses,
    "local_memory_ops_in_loop": n, "half_rate_in_loop": n}."""
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
    in_loop = [(op, operands) for addr, op, operands in instrs if loop[0] <= addr <= loop[1]]

    result = {
        "loop": count(lambda a: loop[0] <= a <= loop[1]),
        "function": count(lambda a: True),
        "loop_range": [loop[0], loop[1]],
        # Spilled registers are read and written with LDL/STL: any inside
        # the loop would cost memory traffic per nonce.
        "local_memory_ops_in_loop": sum(1 for op, _ in in_loop if op in ("LDL", "STL")),
        "half_rate_in_loop": sum(
            1 for op, operands in in_loop
            if any((op + operands).startswith(form) for form in HALF_RATE_FORMS)
            and not operands.split(",")[2].strip().startswith("0x")
        ),
    }
    if not result["loop"]:
        raise RuntimeError(f"no integer instructions found in the scan loop of {kernel}")
    return result

def card() -> dict:
    import torch

    from dpowbench import roofline

    clocks = roofline.card_clocks()
    if clocks is None:
        raise RuntimeError("nvidia-smi gave no maximum SM clock: no roofline to time against")
    return {
        "name": torch.cuda.get_device_name(0),
        "smi": nvidia_smi("name,power.limit"),
        "max_sm_mhz": clocks["max_sm_clock_mhz"],
    }


def roofline_pct(state: dict, hashes: int, ms: float):
    """Percent of the card's roofline that ``hashes`` in ``ms`` reach (None
    for a card the roofline has no peaks for)."""
    from dpowbench import roofline

    c = state["card"]
    return roofline.share_pct(hashes, ms / 1e3, c["name"], c["max_sm_mhz"])


def bound_ms(state: dict, hashes: int):
    from dpowbench import roofline

    c = state["card"]
    s = roofline.bound_seconds(hashes, c["name"], c["max_sm_mhz"])
    return None if s is None else s * 1e3


# -- phases -------------------------------------------------------------------


def _kernel_report(cuda_kernel, name: str, kernel: str) -> dict:
    """ptxas' report and the SASS counts of one library's kernel."""
    log = cuda_kernel.build_log(name)
    regs = [int(x) for x in re.findall(r"Used (\d+) registers", log)]
    spills = [int(x) for x in re.findall(r"(\d+) bytes spill (?:stores|loads)", log)]
    stack = [int(x) for x in re.findall(r"(\d+) bytes stack frame", log)]
    sass = sass_int_instructions(cuda_kernel.library_path(name), kernel)
    counts = sass["loop"]
    fma = sum(n for op, n in counts.items() if op in FMA_OPS)
    return {
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
        "sass_half_rate_in_loop": sass["half_rate_in_loop"],
    }


def phase_build(state: dict) -> None:
    from tpu_dpow_torch.ops import cuda_kernel

    t0 = time.perf_counter()
    libs = cuda_kernel.load_libraries()
    build_s = time.perf_counter() - t0
    emit({
        "phase": "build", "ok": True, "seconds": build_s,
        **_kernel_report(cuda_kernel, "search", "b2_search_kernel"),
        "blocks_per_row_b1": libs["search"].b2_blocks_per_row(1, 1 << 25),
        "run_kernel": {
            **_kernel_report(cuda_kernel, "run", "b2_run_kernel"),
            "blocks_per_row": {b: libs["run"].b2_run_blocks_per_row(b) for b in (1, 16)},
        },
        "card": state["card"]["smi"],
    })


def _nonces(lo, hi) -> list:
    from tpu_dpow_torch.ops import search

    lo, hi = search.offsets_to_numpy(lo), search.offsets_to_numpy(hi)
    return [(int(h) << 32) | int(x) for x, h in zip(lo, hi)]


def _host_ms(fn, reps: int) -> tuple:
    """Host-clock milliseconds per call of ``fn`` over ``reps`` calls, and
    the last call's result."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    return (time.perf_counter() - t0) * 1e3 / reps, out


def _meets(block_hash: str, nonce: int, difficulty: int) -> bool:
    """Does ``nonce`` meet ``difficulty`` for ``block_hash``, by hashlib?"""
    from tpu_dpow_torch.utils.nanocrypto import work_value

    return work_value(block_hash, f"{nonce:016x}") >= difficulty


#: The engines the main path drives: chunked, persistent, the fan over every
#: card (persistent, interleaved: strided run-kernel launches from two cards
#: on) and the mesh gang over every card.
ENGINES = {
    "chunked": {},
    "persistent": {"run_mode": "persistent"},
    "fan": {"run_mode": "persistent", "devices": -1, "device_shard": "interleave"},
    "mesh": {"mesh_devices": -1},
}


async def _main_path() -> dict:
    """Each engine of ENGINES serves max_batch send- and max_batch
    receive-difficulty requests at once; its launch counts are zeroed after
    its set-up (whose self-test launches once), so they are the burst's."""
    import numpy as np
    import torch

    from tpu_dpow_torch.backend.torch_backend import TorchWorkBackend
    from tpu_dpow_torch.models import WorkRequest
    from tpu_dpow_torch.ops import cuda_kernel

    rng = np.random.default_rng(SEED + 1)
    out = {}
    for name, kwargs in ENGINES.items():
        if kwargs.get("mesh_devices") == -1:
            kwargs = {**kwargs, "mesh_devices": torch.cuda.device_count()}
        backend = TorchWorkBackend(**kwargs)
        await backend.setup()
        cuda_kernel.reset_launches()
        reqs = [(rng.bytes(32).hex().upper(), d)
                for d in (SEND, RECEIVE) for _ in range(backend.max_batch)]
        t0 = time.perf_counter()
        try:
            works = await asyncio.gather(*[backend.generate(WorkRequest(h, d)) for h, d in reqs])
        finally:
            await backend.close()
        seconds = time.perf_counter() - t0
        for (h, d), work in zip(reqs, works):
            if not _meets(h, int(work, 16), d):
                raise AssertionError(f"{name} engine: invalid work {work} for {h} at {d:016x}")
        out[name] = {"solves": len(works), "seconds": seconds, "search": cuda_kernel.launches,
                     "run": cuda_kernel.run_launches,
                     "run_strided": cuda_kernel.run_strided_launches,
                     "polls": cuda_kernel.run_poll_stats["polls"]}
    if out["chunked"]["search"] <= 0 or out["chunked"]["run"]:
        raise AssertionError(f"the chunked engine's launches: {out['chunked']}")
    for name in ("persistent", "fan"):
        if out[name]["run"] <= 0 or out[name]["search"]:
            raise AssertionError(f"the {name} engine's launches: {out[name]}")
    if out["mesh"]["search"] <= 0:
        raise AssertionError(f"the mesh engine never launched the search kernel: {out['mesh']}")
    return out


def _controlled_vs_plain(eng) -> dict:
    """The wrapper the persistent engine calls
    (runloop.search_run_batch_controlled, cuda_search_run_batch_controlled
    beneath it) at the engine's window, poll cadence and launch length,
    against the plain run_loop_core on the same rows and commands: 4 rows (a
    batch the engine packs), three with first hits about half a window in,
    one of them raised to a target ~1 window in and the fourth (dry)
    cancelled, both before the launch, so the first poll delivers them. The
    nonces, the polls, each row's done window, the deliveries and the
    targets must be equal, and every nonce must meet its row's target."""
    import numpy as np

    from tpu_dpow_torch.ops import control, runloop, search
    from tpu_dpow_torch.resilience.clock import SystemClock

    rng = np.random.default_rng(SEED + 3)
    window = eng.chunk
    easy, raised = (1 << 64) - (1 << 64) // (window // 2), (1 << 64) - (1 << 64) // window
    hashes = [rng.bytes(32) for _ in range(4)]
    host = np.stack([search.pack_params(h, d, int(rng.integers(0, 1 << 63)))
                     for h, d in zip(hashes, (easy, easy, easy, MAX_U64))])
    geo = dict(sublanes=eng.sublanes, iters=eng.iters, nblocks=eng.nblocks, group=eng.group)
    sides = {}
    for side in ("kernel", "plain"):
        c = control.LaunchControl(len(host), clock=SystemClock())
        c.raise_difficulty(0, raised, epoch=1)
        c.cancel(3)
        slot = control.register(c)
        params = search.params_from_numpy(host, eng.device)
        t0 = time.perf_counter()
        try:
            if side == "kernel":
                lo, hi = runloop.search_run_batch_controlled(
                    params, None, slot, max_steps=eng.persistent_steps,
                    poll_steps=eng.control_poll_steps, **geo)
            else:
                lo, hi = runloop.run_loop_core(
                    params, None, launch=runloop.plain_launch(window), window=window,
                    max_steps=eng.persistent_steps, poll_steps=eng.control_poll_steps,
                    control_poll=runloop.make_control_poll(slot))
            found = _nonces(lo, hi)
        finally:
            control.release(slot)
        sides[side] = {
            "nonces": found, "polls": c.polls, "last_k": c.last_k,
            "done_at_k": sorted(c.done_at_k.items()),
            "delivered": sorted((row, action) for row, action, *_ in c.delivered),
            "difficulty": [c.effective_difficulty(r) for r in range(len(host))],
            "seconds": time.perf_counter() - t0,
        }
    kernel, plain = sides["kernel"], sides["plain"]
    if {k: v for k, v in kernel.items() if k != "seconds"} != {
            k: v for k, v in plain.items() if k != "seconds"}:
        raise AssertionError(f"the controlled run wrapper != the plain run loop: {sides}")
    targets = (raised, easy, easy)
    for h, nonce, d in zip(hashes, kernel["nonces"], targets):
        if not _meets(h.hex(), nonce, d):
            raise AssertionError(f"the controlled run returned {nonce:016x}, below {d:016x}")
    if kernel["nonces"][3] != MAX_U64 or (3, "cancel") not in kernel["delivered"]:
        raise AssertionError(f"the cancelled dry row: {kernel}")
    return {"rows": len(host), "window": window, "poll_steps": eng.control_poll_steps,
            "max_steps": eng.persistent_steps, "last_poll_k": kernel["last_k"],
            "polls": kernel["polls"], "kernel_s": kernel["seconds"],
            "plain_s": plain["seconds"], "tolerance": "bit-exact against the plain run loop"}


def phase_kernel_time(state: dict) -> None:
    import numpy as np
    import torch

    from tpu_dpow_torch.backend.torch_backend import TorchWorkBackend
    from tpu_dpow_torch.ops import cuda_kernel, search

    main_path = asyncio.run(_main_path())
    state["launches"] = {
        "time": main_path["chunked"]["search"], "run_time": main_path["persistent"]["run"],
        "strided_time": main_path["fan"]["run_strided"],
        "fan_time": main_path["fan"]["search"] + main_path["fan"]["run"],
        "mesh_time": main_path["mesh"]["search"],
    }
    controlled = _controlled_vs_plain(TorchWorkBackend(run_mode="persistent"))
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
    plain_out = {}
    run_plain = lambda: plain_out.__setitem__(
        "search", search.search_chunk_batch(params, chunk_size=span))
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
    if not torch.equal(run_kernel(), plain_out["search"]):
        raise AssertionError("the timed search kernel disagrees with its plain version")
    nonces = eng.max_batch * span
    state["time"] = {"ms": kernel_ms, "plain_ms": plain_ms, "hashes": nonces}
    run = _time_run_kernel(state, eng, params, timed)
    fan = _time_fan(state, host, geo)
    mesh = _time_mesh(state, host, geo)
    emit({
        "phase": "kernel_time", "ok": True, "rows": eng.max_batch, "span": span,
        "nonces": nonces, "kernel_ms": kernel_ms, "kernel_ms_repeat": kernel_ms_after,
        "plain_ms": plain_ms, "kernel_hashes_per_second": nonces / (kernel_ms / 1e3),
        "plain_hashes_per_second": nonces / (plain_ms / 1e3),
        "bound_ms": bound_ms(state, nonces), "roofline_pct": roofline_pct(state, nonces, kernel_ms),
        "single_row_run": {"nonces": span * eng.run_steps, "ms": single_ms,
                           "roofline_pct": roofline_pct(state, span * eng.run_steps, single_ms)},
        "run_kernel": run, "fan": fan, "mesh": mesh,
        "main_path": main_path, "controlled_vs_plain": controlled,
        "max_sm_mhz": state["card"]["max_sm_mhz"], "card": state["card"]["smi"],
    })


def _time_fan(state: dict, host, geo: dict) -> dict:
    """One fanned launch at the engine's full shape over every visible card
    (max_batch rows x one window per member, fan_search_devices, results on
    the host), host-timed, and its plain version member by member. Then the
    fan's plumbing on one card: a one-member fan_search_devices against the
    plain path's launch and readback on the same rows, in turns plain, fan,
    fan, plain."""
    import numpy as np

    from tpu_dpow_torch.ops import cuda_kernel, search
    from tpu_dpow_torch.parallel import fan_search

    devs = fan_search.fan_devices(-1, "cuda")
    span = cuda_kernel.window(**geo)
    stacked = fan_search.stagger(host, len(devs), span)
    fanned = lambda: fan_search.fan_search_devices(stacked, devices=devs, chunk_per_shard=span,
                                                   **geo)
    plain = lambda: np.stack([search.offsets_to_numpy(search.search_chunk_batch(
        search.params_from_numpy(stacked[i], d), chunk_size=span)) for i, d in enumerate(devs)])
    fanned()  # warm-up
    ms, got = _host_ms(fanned, 5)
    plain_ms, want = _host_ms(plain, 1)
    if not np.array_equal(got, want):
        raise AssertionError("the timed fanned launch disagrees with its plain version")
    params = search.params_from_numpy(host, devs[0])
    one = lambda: fan_search.fan_search_devices(host[None], devices=devs[:1],
                                                chunk_per_shard=span, **geo)
    direct = lambda: search.offsets_to_numpy(cuda_kernel.cuda_search_chunk_batch(params, **geo))
    turns = {"plain_path": [], "fan_of_one": []}
    for name in ("plain_path", "fan_of_one", "fan_of_one", "plain_path") * 2:
        turns[name].append(_host_ms(one if name == "fan_of_one" else direct, 3)[0])
    if not np.array_equal(one()[0], direct()):
        raise AssertionError("a fan of one and the plain launch disagree")
    hashes = host.shape[0] * span  # one member's share: members run at once
    state["fan_time"] = {"ms": ms, "plain_ms": plain_ms, "hashes": hashes}
    return {"members": len(devs), "rows": host.shape[0], "span_per_member": span,
            "ms": ms, "plain_ms": plain_ms, "roofline_pct": roofline_pct(state, hashes, ms),
            "launch_price_ms": turns,
            "fan_of_one_over_plain_path": float(np.median(turns["fan_of_one"])
                                                / np.median(turns["plain_path"]))}


def _time_mesh(state: dict, host, geo: dict) -> dict:
    """One ganged launch at the engine's shape per member (max_batch rows x
    one window per member, sharded_search_chunk_batch over every visible
    card, results and the election on the host), host-timed, and the plain
    scan of the whole ganged window once."""
    import numpy as np

    from tpu_dpow_torch.ops import cuda_kernel, search
    from tpu_dpow_torch.parallel import fan_devices, mesh_search

    mesh = mesh_search.make_mesh(fan_devices(-1, "cuda"))
    span = cuda_kernel.window(**geo)
    ganged = lambda: mesh_search.sharded_search_chunk_batch(host, mesh=mesh,
                                                            chunk_per_shard=span, **geo)
    # The plain version of the ganged window: one plain scan of each row's
    # whole window (the members' sub-ranges side by side) on the first card.
    params = search.params_from_numpy(host, mesh.devices.flat[0])
    whole = span * mesh.shape[mesh_search.NONCE_AXIS]
    plain = lambda: search.offsets_to_numpy(search.search_chunk_batch(params, chunk_size=whole))
    ganged()  # warm-up
    ms, got = _host_ms(ganged, 5)
    plain_ms, want = _host_ms(plain, 1)
    if not np.array_equal(got, want):
        raise AssertionError("the timed ganged launch disagrees with its plain version")
    hashes = host.shape[0] * span  # one member's share: members run at once
    state["mesh_time"] = {"ms": ms, "plain_ms": plain_ms, "hashes": hashes}
    return {"members": mesh.size, "rows": host.shape[0], "span_per_member": span, "ms": ms,
            "plain_ms": plain_ms, "roofline_pct": roofline_pct(state, hashes, ms)}


def _time_run_kernel(state: dict, eng, params, timed) -> dict:
    """The persistent run kernel alone at max_batch rows x RUN_TIME_STEPS
    engine windows without control (every row dry: the whole span is
    scanned), contiguous and ``STRIDE_WINDOWS`` windows apart, each against
    its plain version once on the same rows (their results bit-equal); one
    row over 16 windows with and without a control channel at the engine's
    poll cadence (a dead slot: every poll answers zeros), which prices the
    polls; and the same nonces as ONE live row of max_batch, the others
    inactive (done from the start): the kernel deals the whole grid to that
    row, so it should scan at the all-live rate."""
    import torch

    from tpu_dpow_torch.ops import cuda_kernel, runloop

    window = eng.chunk
    stride = STRIDE_WINDOWS * window
    plain_out = {}
    run_kernel = lambda: cuda_kernel.cuda_search_run_batch(
        params, None, window=window, max_steps=RUN_TIME_STEPS)
    run_plain = lambda: plain_out.__setitem__("contiguous", runloop.run_loop_core(
        params, None, launch=runloop.plain_launch(window), window=window,
        max_steps=RUN_TIME_STEPS))
    run_strided = lambda: cuda_kernel.cuda_search_run_batch(
        params, None, window=window, max_steps=RUN_TIME_STEPS, stride=stride)
    plain_strided = lambda: plain_out.__setitem__("strided", runloop.run_loop_core(
        params, None, launch=runloop.plain_launch(window), window=stride,
        max_steps=RUN_TIME_STEPS))
    one = params[:1]
    one_free = lambda: cuda_kernel.cuda_search_run_batch(one, None, window=window, max_steps=16)
    one_polled = lambda: cuda_kernel.cuda_search_run_batch_controlled(
        one, None, 0, window=window, max_steps=16, poll_steps=eng.control_poll_steps)
    rows = params.shape[0]
    first_only = torch.zeros(rows, dtype=torch.uint8, device=params.device)
    first_only[0] = 1
    one_live = lambda: cuda_kernel.cuda_search_run_batch(
        params, first_only, window=window, max_steps=rows * RUN_TIME_STEPS)
    run_kernel()  # warm-up
    ms = timed(run_kernel, 5)
    plain_ms = timed(run_plain, 1)
    ms_repeat = timed(run_kernel, 5)
    run_strided()  # warm-up
    strided_ms = timed(run_strided, 5)
    strided_plain_ms = timed(plain_strided, 1)
    strided_ms_repeat = timed(run_strided, 5)
    contiguous_after = timed(run_kernel, 5)
    for mode, launch in (("contiguous", run_kernel), ("strided", run_strided)):
        got, want = _nonces(*launch()), _nonces(*plain_out[mode])
        if got != want:
            raise AssertionError(f"timed {mode} run kernel != plain: {got} vs {want}")
    one_live()  # warm-up
    one_live_ms = timed(one_live, 5)
    if set(_nonces(*one_live())) != {MAX_U64}:
        raise AssertionError("a dry row, alone live of its launch, returned a nonce")
    one_polled()  # warm-up: the first controlled launch allocates its pinned mailbox
    polls_before = cuda_kernel.run_poll_stats["polls"]
    one_free_ms, one_polled_ms = timed(one_free, 3), timed(one_polled, 3)
    polls = (cuda_kernel.run_poll_stats["polls"] - polls_before) // 3
    nonces = rows * RUN_TIME_STEPS * window
    state["run_time"] = {"ms": ms, "plain_ms": plain_ms, "hashes": nonces}
    # The strided launch scans as many nonces: the same bound.
    state["strided_time"] = {"ms": strided_ms, "plain_ms": strided_plain_ms, "hashes": nonces}
    return {
        "rows": rows, "windows": RUN_TIME_STEPS, "window": window,
        "nonces": nonces, "ms": ms, "ms_repeat": ms_repeat, "plain_ms": plain_ms,
        "hashes_per_second": nonces / (ms / 1e3), "bound_ms": bound_ms(state, nonces),
        "roofline_pct": roofline_pct(state, nonces, ms),
        "one_live_of_rows": {"windows": rows * RUN_TIME_STEPS, "nonces": nonces, "ms": one_live_ms,
                             "roofline_pct": roofline_pct(state, nonces, one_live_ms),
                             "over_all_live": one_live_ms / ms},
        "one_row_16_windows_ms": one_free_ms,
        "one_row_16_windows_polled_ms": one_polled_ms,
        "polls_per_polled_launch": polls,
        "poll_cost_us": (one_polled_ms - one_free_ms) * 1e3 / max(1, polls),
        "strided": {"stride": stride, "ms": strided_ms, "ms_repeat": strided_ms_repeat,
                    "plain_ms": strided_plain_ms,
                    "roofline_pct": roofline_pct(state, nonces, strided_ms),
                    "contiguous_ms_after": contiguous_after},
        "tolerance": "bit-exact against the plain run loop",
    }


#: The kernel table's rows: (name, source, what it replaces, state key).
KERNELS = (
    ("blake2b_search", "tpu_dpow_torch/ops/csrc/blake2b_search.cu",
     "tpu_dpow/ops/pallas_kernel.py:239", "time"),
    ("blake2b_run", "tpu_dpow_torch/ops/csrc/blake2b_run.cu",
     "tpu_dpow/ops/runloop.py:51", "run_time"),
    ("blake2b_run_strided", "tpu_dpow_torch/ops/csrc/blake2b_run.cu",
     "tpu_dpow/parallel/fan_search.py:343", "strided_time"),
    ("fan_search", "tpu_dpow_torch/parallel/fan_search.py",
     "tpu_dpow/parallel/fan_search.py:98", "fan_time"),
    ("mesh_search", "tpu_dpow_torch/parallel/mesh_search.py",
     "tpu_dpow/parallel/mesh_search.py:80", "mesh_time"),
)


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    state = {"card": card()}
    try:
        phase_build(state)
        phase_kernel_time(state)
    except BaseException:
        # A failed phase may leave a launch thread behind (a kernel that
        # never returned): exit at once instead of joining it at shutdown.
        import traceback

        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)
    print(state["card"]["smi"], flush=True)
    emit({"kernels": [{
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": state["launches"][key], "ms": state[key]["ms"],
        "plain_ms": state[key]["plain_ms"], "bound_ms": bound_ms(state, state[key]["hashes"]),
        "roofline_pct": roofline_pct(state, state[key]["hashes"], state[key]["ms"]),
        "library_ms": None,
    } for name, source, replaces, key in KERNELS]})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
