"""Run one cell of BENCHMARK.json once.

    python -m dpowbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Starts the port's broker, hub and worker as three processes (``stack.py``),
offers the cell's traffic to the hub's HTTP and WebSocket faces from this
process (``drive.py``), judges every served answer with ``reference.py``,
and prints one JSON line last on stdout: the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1`` (the worker then runs
under ``torch.profiler``). The numbers compared for ``correct`` are printed
last on stderr and last in the line, under ``checks``.

Options for tests and set-up work, never passed in a measured run:
``--device cpu`` runs the worker's engine on the CPU and skips the look for
a card (tests); ``--control`` starts the hub at the configuration's
``control_difficulty`` while the answers are still judged at its
``difficulty``, which has to come out not correct; ``--bench`` reads
another benchmark file, whose configurations and mixes lie under
``dpowbench/`` beside it.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import asyncio  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import signal  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

from . import devtrace, drive, prom, roofline  # noqa: E402
from .child import forbidden_modules  # noqa: E402
from .feed import NodeFeed  # noqa: E402
from .stack import ROOT, Stack  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))


class SetupError(RuntimeError):
    pass


class NoDevice(RuntimeError):
    pass


def cuda_device_count() -> int:
    import torch

    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def load_cell(bench_path: str, workload: str) -> tuple:
    """(bench, cell, configuration, traffic mix) of one workload."""
    with open(bench_path) as f:
        bench = json.load(f)
    base = os.path.dirname(os.path.abspath(bench_path))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SetupError(f"no workload {workload!r} in {bench_path}")
    cell = cells[workload]
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(os.path.join(base, entry["file"])) as f:
        config = json.load(f)
    with open(os.path.join(base, "dpowbench", "traffic", cell["traffic"] + ".json")) as f:
        traffic = json.load(f)
    return bench, cell, config, traffic


def flag_value(flags: list, name: str, default):
    return flags[flags.index(name) + 1] if name in flags else default


def for_cell(metrics: list, workload: str) -> list:
    return [m for m in metrics if workload in m.get("workloads", [workload])]


def load_reader(name: str):
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(f"dpowbench.metrics.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def end_to_end(name: str, stats: dict, setup_s: float, seconds: float):
    lat = stats["latency_ms"]
    return {
        "setup_s": lambda: setup_s,
        "p50_ms": lambda: drive.percentile(lat, 0.50),
        "p95_ms": lambda: drive.percentile(lat, 0.95),
        "served_per_s": lambda: stats["served"] / seconds,
    }[name]()


def pages_summary(pages: dict) -> str:
    """Launches, their mean host-timed length and rows, and each stage's
    mean (ms) between the window's two pages, for stderr."""
    torch_engine = {"engine": "torch"}
    parts = []
    for where, stages in (("hub", ("queue", "publish", "winner")),
                          ("worker", ("pack", "device", "result"))):
        before, after = pages["before"][where], pages["after"][where]
        for st in stages:
            mean = prom.mean_delta(before, after, "dpow_request_stage_seconds", {"stage": st})
            parts.append(f"{where}.{st}={'-' if mean is None else f'{1e3 * mean:.3f}'}")
    before, after = pages["before"]["worker"], pages["after"]["worker"]
    launch = prom.mean_delta(before, after, "dpow_engine_device_seconds", torch_engine)
    rows = prom.mean_delta(before, after, "dpow_engine_batch_occupancy")
    launches = prom.delta(before, after, "dpow_engine_device_seconds_count", torch_engine)
    launch_ms = "-" if launch is None else f"{1e3 * launch:.3f}"
    parts.append(f"launches={launches:g} launch_ms={launch_ms}"
                 f" rows={'-' if rows is None else f'{rows:.2f}'}")
    return " ".join(parts)


async def window_marks(stack, session, t0: float, seconds: float, pages: dict) -> None:
    """At the window's start and end: read both /metrics pages and signal
    the worker (SIGUSR1 opens its window, SIGUSR2 closes it)."""
    await asyncio.sleep(max(0.0, t0 - time.perf_counter()))
    pages["before"] = {w: await stack.page(session, p) for w, p in (("hub", "upcheck"),
                                                                    ("worker", "worker"))}
    stack.signal_worker(signal.SIGUSR1)
    await asyncio.sleep(max(0.0, t0 + seconds - time.perf_counter()))
    stack.signal_worker(signal.SIGUSR2)
    pages["after"] = {w: await stack.page(session, p) for w, p in (("hub", "upcheck"),
                                                                   ("worker", "worker"))}


async def run_cell(args, bench: dict, cell: dict, config: dict, traffic: dict,
                   workdir: str) -> dict:
    import aiohttp

    threshold = int(config["difficulty"], 16)
    hub_difficulty = config["control_difficulty"] if args.control else config["difficulty"]
    population = drive.make_population(traffic, args.seed)
    stack = Stack(workdir, config, device=args.device, hub_difficulty=hub_difficulty,
                  trace=bool(args.trace))
    faces = feed = None
    # torch is imported beside the children, which import it too
    count = (asyncio.ensure_future(asyncio.to_thread(cuda_device_count))
             if args.device == "cuda" else None)
    try:
        t_spawn = time.perf_counter()
        try:
            await stack.start(population)
        finally:
            if count is not None and await count < cell["chips"]:
                raise NoDevice(f"the cell needs {cell['chips']} CUDA device(s); "
                               f"{count.result()} visible")
        t_joined = time.perf_counter()
        faces = drive.Faces(stack, traffic["ws_share"], args.seed)
        await faces.start()
        if "chain" in traffic:
            feed = NodeFeed(stack.url("blocks"))
            await feed.start()
        pages: dict = {}
        # The generator's own collector would stall the loop for ~0.1-0.2 s
        # (a heap that holds torch) and count as the system's latency: freeze
        # what set-up made and collect nothing until the traffic has ended.
        gc.collect()
        gc.freeze()
        gc.disable()
        async with aiohttp.ClientSession() as session:
            start = time.perf_counter() + 0.05
            t0 = start + traffic["warm_s"]
            marks = asyncio.ensure_future(window_marks(stack, session, t0, args.seconds, pages))
            if traffic["loop"] == "open":
                records, _ = await drive.open_loop(
                    faces, population, rate=traffic["rate"], warm_s=traffic["warm_s"],
                    seconds=args.seconds, seed=args.seed, spikes=traffic.get("spikes", ()),
                    start=start)
            else:
                records, _ = await drive.closed_loop(
                    faces, population, callers=traffic["callers"], timeout=traffic["timeout"],
                    warm_s=traffic["warm_s"], seconds=args.seconds, seed=args.seed,
                    start=start, chain=traffic.get("chain"), feed=feed)
            await marks
        if feed is not None:
            # confirmations still due stop here: during late_answers one
            # could retire a hash that is being asked for again
            await feed.close()
        gc.enable()
        setup_s = t0 - T_START
        print(f"dpowbench: set-up {setup_s:.3f} s: {t_spawn - T_START:.3f} s to the spawn, "
              f"{t_joined - t_spawn:.3f} s until the worker joined, {t0 - t_joined:.3f} s of "
              "warm-up", file=sys.stderr)
        window = [r for r in records if r["phase"] == "window"]
        late = await drive.late_answers(faces, window, threshold)
        report = await stack.window_report()
    finally:
        if faces is not None:
            await faces.close()
        found = await stack.stop()
        stack.kill()
    print("dpowbench: window by due time: " + "; ".join(
        drive.slices(records, t0, args.seconds)), file=sys.stderr)
    print("dpowbench: window, ms: " + drive.lag_summary(records), file=sys.stderr)
    print("dpowbench: window in the pages: " + pages_summary(pages), file=sys.stderr)
    if feed is not None:
        print("dpowbench: node feed: " + feed.summary(pages, t0, args.seconds), file=sys.stderr)
    stats = drive.window_stats(records, t0, args.seconds, traffic["loop"])
    checks = drive.judge(records, late, threshold)
    return {"stats": stats, "checks": checks, "setup_s": setup_s, "pages": pages,
            "report": report, "found": found, "trace_path": stack.trace_path}


def result_line(args, bench, cell, config, out) -> dict:
    stats, report = out["stats"], out["report"]
    device = {"platform": "gpu" if args.device == "cuda" else "cpu",
              "kind": report.get("kind", "cpu"), "count": cell["chips"],
              "memory_peak_bytes": report.get("memory_peak_bytes", 0)}
    metrics = {}
    line = {"correct": drive.passed(out["checks"]), "attempted": stats["attempted"],
            "failed": stats["failed"], "metrics": metrics, "device": device}
    if not args.trace:
        for m in for_cell(bench["end_to_end"], cell["name"]):
            v = end_to_end(m["name"], stats, out["setup_s"], args.seconds)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        trace = devtrace.reduce(out["trace_path"]) if out["trace_path"] else None
        clocks = roofline.card_clocks() if args.device == "cuda" else None
        src = {"hub": (out["pages"]["before"]["hub"], out["pages"]["after"]["hub"]),
               "worker": (out["pages"]["before"]["worker"], out["pages"]["after"]["worker"]),
               "trace": trace, "threshold": int(config["difficulty"], 16),
               "max_batch": int(flag_value(config["worker_flags"], "--max_batch", 16)),
               "kind": device["kind"], "clocks": clocks, "stats": stats}
        for m in for_cell(bench["per_layer"], cell["name"]):
            v = load_reader(m["name"])(src)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if trace is not None:
            device["busy_s"], device["window_s"] = trace["busy_s"], trace["window_s"]
            line["breakdown"] = {"device_ops": trace["ops"][:10], "idle_gaps": trace["gaps"]}
        if clocks is not None:
            device.update(clocks)
    line["checks"] = out["checks"]
    return line


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m dpowbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--control", action="store_true")
    p.add_argument("--bench", default=os.path.join(ROOT, "BENCHMARK.json"))
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    try:
        bench, cell, config, traffic = load_cell(args.bench, args.workload)
    except (OSError, ValueError, KeyError, StopIteration, SetupError) as e:
        print(f"dpowbench: cannot read the cell: {e!r}", file=sys.stderr)
        return 1
    with tempfile.TemporaryDirectory(prefix="dpowbench-") as workdir:
        try:
            out = asyncio.run(run_cell(args, bench, cell, config, traffic, workdir))
            line = result_line(args, bench, cell, config, out)
        except NoDevice as e:
            print(f"dpowbench: {e}", file=sys.stderr)
            return 2
        except Exception as e:  # noqa: BLE001 - the run failed: say why, print no result
            import traceback

            traceback.print_exc()
            print(f"dpowbench: the run failed: {e!r}", file=sys.stderr)
            return 1
    found = {"harness": forbidden_modules(), **out["found"]}
    bad = {who: mods for who, mods in found.items() if mods != []}
    if bad:
        print(f"dpowbench: forbidden modules loaded (None: no report): {bad}", file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
