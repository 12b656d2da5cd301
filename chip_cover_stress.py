"""Drive chip_smoke.py's persistent fan engine (`_fan_engine`) again and again
on the card and count how its mid-launch cover_range attempts ended.

An attempt either has its rebase delivered to a running launch, or lands in a
launch whose kernel has already stopped polling (a speculative successor that
ran ahead of the launch before it on the card's one persistent stream): that
rebase is never delivered, and the engine re-dispatches the job from the new
range. Prints one JSON line per engine run and the tally last.

    python3 chip_cover_stress.py [--seed 11] [--runs 40] [--seconds 240]
"""
import argparse
import asyncio
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=11)
    p.add_argument("--runs", type=int, default=40, help="rounds of both device_shard policies")
    p.add_argument("--seconds", type=float, default=240.0, help="start no round after this")
    ns = p.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_cover_stress: no CUDA device visible", file=sys.stderr)
        return 2
    chip_smoke.phase_build({"card": chip_smoke.card()})
    rng = np.random.default_rng(ns.seed)
    t_end = time.monotonic() + ns.seconds
    tally = {"runs": 0, "cover_attempts": 0, "redispatched": 0, "raise_attempts": 0}
    for i in range(ns.runs):
        if time.monotonic() > t_end:
            break
        for policy in ("split", "interleave"):
            t0 = time.perf_counter()
            r = asyncio.run(chip_smoke._fan_engine("persistent", policy, rng))
            tally["runs"] += 1
            tally["cover_attempts"] += r["covered"]["attempts"]
            tally["raise_attempts"] += r["raised"]["attempts"]
            tally["redispatched"] += len(r["covered"]["redispatched"])
            print(json.dumps({"round": i, "policy": policy, "s": time.perf_counter() - t0,
                              "raised": r["raised"]["attempts"], "covered": r["covered"]}),
                  flush=True)
    print(json.dumps({**tally, "card": chip_smoke.card()["smi"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
