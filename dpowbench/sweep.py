"""Find the knee of an open-loop cell: the highest rate the stack sustains.

    python -m dpowbench.sweep --workload <open-loop cell> --seed <n> \
        --rates 100,200,300 --rung_seconds 10

Each rung on a fresh stack (``stack.py``), as each run of the cell gets
one: the mix's warm-up, then its traffic at the rung's rate for
``rung_seconds`` (the cell's window: a stack can hold a rate for 15 s that
it cannot hold for a minute), with the hub's
``dpow_server_inflight_requests`` sampled every 0.25 s. A rung holds when
its failed share stays at the lowest rung's level (within 0.1 percentage
points) and the hub's backlog does not grow: the mean of the gauge over the
rung's last third is at most twice that over its first third plus 2. The
knee is the highest rung below the first that does not hold; the sweep
stops there. Prints one JSON line per rung and a summary line last. Set-up
work, not a measured run: the benchmark's runs never call it, and the rate
it finds is written by hand into the mix's file.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys
import tempfile
import time

from . import drive, prom
from .run import ROOT, load_cell
from .stack import Stack

SAMPLE_S = 0.25


async def sample_backlog(stack, session, out: list, stop: asyncio.Event) -> None:
    while not stop.is_set():
        page = await stack.page(session, "upcheck")
        out.append((time.perf_counter(), prom.value(page, "dpow_server_inflight_requests")))
        try:
            await asyncio.wait_for(stop.wait(), SAMPLE_S)
        except asyncio.TimeoutError:
            pass


def thirds(samples: list) -> tuple:
    """Mean of the gauge over the first and the last third of a rung."""
    n = max(1, len(samples) // 3)
    first, last = samples[:n], samples[-n:]
    return (sum(v for _t, v in first) / max(1, len(first)),
            sum(v for _t, v in last) / max(1, len(last)))


async def rung(args, config: dict, traffic: dict, workdir: str, rate: float, i: int) -> dict:
    """One rung on a fresh stack, as a run of the cell makes one: warm-up,
    then ``rung_seconds`` at ``rate`` with the hub's backlog sampled."""
    import aiohttp

    threshold = int(config["difficulty"], 16)
    seed = args.seed + i
    population = drive.make_population(traffic, seed)
    stack = Stack(os.path.join(workdir, str(i)), config, device=args.device,
                  hub_difficulty=config["difficulty"], trace=False)
    os.makedirs(stack.workdir)
    faces = None
    try:
        await stack.start(population)
        faces = drive.Faces(stack, traffic["ws_share"], seed)
        await faces.start()
        await drive.open_loop(faces, population, rate=rate, warm_s=0.0,
                              seconds=traffic["warm_s"], seed=seed, start=time.perf_counter())
        async with aiohttp.ClientSession() as session:
            samples: list = []
            stop = asyncio.Event()
            sampler = asyncio.ensure_future(sample_backlog(stack, session, samples, stop))
            records, t0 = await drive.open_loop(
                faces, population, rate=rate, warm_s=0.0, seconds=args.rung_seconds,
                seed=seed, start=time.perf_counter() + 0.05)
            stop.set()
            await sampler
    finally:
        if faces is not None:
            await faces.close()
        await stack.stop()
        stack.kill()
    stats = drive.window_stats(records, t0, args.rung_seconds, "open")
    first, last = thirds([(t, v) for t, v in samples if t < t0 + args.rung_seconds])
    return {
        "rate": rate, "attempted": stats["attempted"], "failed": stats["failed"],
        "failed_share": stats["failed"] / max(1, stats["attempted"]),
        "p50_ms": drive.percentile(stats["latency_ms"], 0.5),
        "p95_ms": drive.percentile(stats["latency_ms"], 0.95),
        "invalid": sum(1 for r in records if r["outcome"] == "ok"
                       and not drive.reference.valid(r["hash"], r["work"], threshold)),
        "backlog_first": first, "backlog_last": last,
        "backlog_grows": last > 2.0 * first + 2.0,
        "slices": drive.slices(records, t0, args.rung_seconds, 10.0),
    }


async def sweep(args, config: dict, traffic: dict, workdir: str) -> dict:
    rungs: list = []
    knee = None
    for i, rate in enumerate(float(r) for r in args.rates.split(",")):
        r = await rung(args, config, traffic, workdir, rate, i)
        lowest = rungs[0]["failed_share"] if rungs else r["failed_share"]
        r["holds"] = (not r["backlog_grows"] and r["invalid"] == 0
                      and r["failed_share"] <= lowest + 0.001)
        rungs.append(r)
        print(json.dumps(r), flush=True)
        if not r["holds"]:
            break
        knee = rate
    return {"workload": args.workload, "seed": args.seed, "rung_seconds": args.rung_seconds,
            "knee": knee, "rates": [r["rate"] for r in rungs]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m dpowbench.sweep")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--rates", required=True, help="comma-separated rungs, req/s, ascending")
    p.add_argument("--rung_seconds", type=float, default=10.0)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--bench", default=os.path.join(ROOT, "BENCHMARK.json"))
    args = p.parse_args(argv)
    _bench, _cell, config, traffic = load_cell(args.bench, args.workload)
    with tempfile.TemporaryDirectory(prefix="dpowbench-sweep-") as workdir:
        summary = asyncio.run(sweep(args, config, traffic, workdir))
    print(json.dumps(summary))
    return 0 if summary["knee"] is not None else 1


if __name__ == "__main__":
    sys.exit(main())
