"""The loops that offer a mix's traffic to the hub's faces, and the judgement
of what they were served.

A record is kept for every request: its phase (``warm`` in set-up,
``window`` in the measured window), the face, the hash, when it was due
(``due``, on ``time.perf_counter``) and sent (``sent``), when its body was
read (``end``), the outcome and the work it was served.
"""

from __future__ import annotations

import asyncio
import hashlib
import random
import time
from typing import Dict, List, Optional

from . import reference
from .feed import NodeFeed
from .loadgen import (TIMEOUT_GRACE, HttpFace, RequestSpec, ServicePopulation, WsFace,
                      draw_seconds, nano_account)

#: seconds past the window's close within which every answer that is due
#: has to come
LATE_LIMIT = 60.0


class Faces:
    """The hub's HTTP and WebSocket faces; a request goes to the WebSocket
    with probability ``ws_share``, drawn from the run's seed."""

    def __init__(self, stack, ws_share: float, seed: int):
        self.http = HttpFace(stack.url("service"))
        self.ws = WsFace(stack.url("service_ws", scheme="ws"))
        self.ws_share = ws_share
        self._rng = random.Random(f"faces:{seed}")

    async def start(self) -> None:
        await self.http.start()
        if self.ws_share > 0:
            await self.ws.start()

    def pick(self) -> str:
        return "ws" if self._rng.random() < self.ws_share else "http"

    async def issue(self, spec: RequestSpec, face: str, phase: str, due: float) -> dict:
        """One request, bounded by the client's abandon point or patience."""
        rec = {"phase": phase, "face": face, "hash": spec.hash, "due": due,
               "sent": time.perf_counter()}
        call = asyncio.ensure_future((self.ws if face == "ws" else self.http)(spec))
        bound = (spec.cancel_after if spec.cancel_after is not None
                 else spec.timeout + TIMEOUT_GRACE)
        done, _ = await asyncio.wait({call}, timeout=bound)
        if done:
            rec["outcome"], rec["work"] = call.result()
        else:
            call.cancel()
            await asyncio.gather(call, return_exceptions=True)
            rec["outcome"] = "cancelled" if spec.cancel_after is not None else "timeout"
            rec["work"] = None
        rec["end"] = time.perf_counter()
        return rec

    async def close(self) -> None:
        await self.ws.close()
        await self.http.close()


def make_population(traffic: dict, seed: int) -> ServicePopulation:
    pop = dict(traffic["population"])
    for key in ("reuse_prob", "cancel_rate", "timeout_median"):
        if key in pop:
            pop[key] = tuple(pop[key])
    return ServicePopulation(stream_seed=seed, **pop)


async def open_loop(faces: Faces, population: ServicePopulation, *, rate: float,
                    warm_s: float, seconds: float, seed: int, start: float,
                    spikes=()) -> tuple:
    """Poisson arrivals at ``rate`` from ``start`` (``time.perf_counter``):
    ``warm_s`` seconds of set-up traffic, then the window. Returns (records,
    window start) once every request has ended."""
    from .loadgen import arrival_times

    rng = random.Random(f"arrivals:{seed}")
    times = ([(t, "warm") for t in arrival_times(rate, warm_s, rng)]
             + [(warm_s + t, "window") for t in arrival_times(rate, seconds, rng, spikes)])
    tasks = []
    for t, phase in times:
        due = start + t
        delay = due - time.perf_counter()
        if delay > 0:
            await asyncio.sleep(delay)
        spec = population.spec(t)
        tasks.append(asyncio.ensure_future(faces.issue(spec, faces.pick(), phase, due)))
    return list(await asyncio.gather(*tasks)), start + warm_s


def chain_account(seed: int, i: int) -> str:
    """Caller i's Nano account under ``seed``."""
    return nano_account(hashlib.blake2b(f"account:{seed}:{i}".encode(), digest_size=32).digest())


async def closed_loop(faces: Faces, population: ServicePopulation, *, callers: int,
                      timeout: float, warm_s: float, seconds: float, seed: int,
                      start: float, chain: Optional[dict] = None,
                      feed: Optional[NodeFeed] = None) -> tuple:
    """``callers`` callers, caller i for service i, each sending a fresh hash
    as soon as its last one is answered, from set-up through the window;
    a request due after the window is not sent. Returns (records,
    window start) once every caller's last request has ended.

    With ``chain`` (``confirm_s``, ``think_s``: ``draw_seconds`` values),
    caller i owns the account ``chain_account(seed, i)``, named in every
    request, and chains its blocks: once the work for hash H is served, it
    publishes a block B (a fresh hash) on H, which ``feed`` confirms
    ``confirm_s`` after the answer, and asks for work on B ``think_s`` after
    it. A request that is not served starts the chain again at once from a
    fresh hash."""
    await asyncio.sleep(max(0.0, start - time.perf_counter()))
    t0, stop = start + warm_s, start + warm_s + seconds
    records: List[dict] = []

    async def caller(i: int) -> None:
        rng = random.Random(f"caller:{seed}:{i}")
        profile = population.profiles[i % len(population.profiles)]
        account = chain_account(seed, i) if chain is not None else None
        times = random.Random(f"chain:{seed}:{i}")
        frontier = next_due = None
        while True:
            due = time.perf_counter() if next_due is None else next_due
            if due >= stop:
                return
            if next_due is not None:
                await asyncio.sleep(max(0.0, due - time.perf_counter()))
            block_hash = frontier or f"{rng.getrandbits(256):064X}"
            spec = RequestSpec(due - start, profile.name, profile.api_key, block_hash,
                               timeout, account=account)
            rec = await faces.issue(spec, faces.pick(), "warm" if due < t0 else "window", due)
            records.append(rec)
            if chain is None or rec["outcome"] != "ok":
                frontier = next_due = None
                continue
            frontier = f"{rng.getrandbits(256):064X}"
            feed.confirm(account, frontier, block_hash,
                         rec["end"] + draw_seconds(chain["confirm_s"], times))
            next_due = rec["end"] + draw_seconds(chain["think_s"], times)

    await asyncio.gather(*(caller(i) for i in range(callers)))
    return records, t0


async def late_answers(faces: Faces, records: List[dict], threshold: int) -> Dict[str, bool]:
    """For every hash whose request was due an answer and got none (a
    timeout or an error, not a client's cancel or a refusal), ask again
    until an answer comes or ``LATE_LIMIT`` seconds have passed; return
    hash -> whether valid work came."""
    served = {r["hash"] for r in records if r["outcome"] == "ok"}
    due = sorted({r["hash"] for r in records
                  if r["outcome"] in ("timeout", "error") and r["hash"] not in served})
    deadline = time.perf_counter() + LATE_LIMIT
    sem = asyncio.Semaphore(32)
    out: Dict[str, bool] = {}

    async def ask(h: str) -> None:
        async with sem:
            while time.perf_counter() < deadline:
                left = deadline - time.perf_counter()
                spec = RequestSpec(0.0, "svc-00000", "key-00000", h,
                                   round(max(1.0, min(30.0, left - TIMEOUT_GRACE)), 3))
                outcome, work = await faces.http(spec)
                if outcome == "ok":
                    out[h] = reference.valid(h, work, threshold)
                    return
                if outcome == "busy":
                    await asyncio.sleep(1.0)
            out[h] = False

    await asyncio.gather(*(ask(h) for h in due))
    return out


def judge(records: List[dict], late: Dict[str, bool], threshold: int) -> dict:
    """The numbers compared, each with its limit: every answer served, in
    set-up and window, meets the threshold by ``reference.py``; every answer
    for one hash is the same string (the store keeps one work per hash);
    every answer that was due in the window came, late or not; and the
    window served something."""
    served = [r for r in records if r["outcome"] == "ok"]
    invalid = sum(1 for r in served if not reference.valid(r["hash"], r["work"], threshold))
    works: Dict[str, set] = {}
    for r in served:
        works.setdefault(r["hash"], set()).add(r["work"])
    return {
        "invalid_work": {"value": invalid, "limit": 0},
        "hashes_with_two_works": {"value": sum(1 for w in works.values() if len(w) > 1),
                                  "limit": 0},
        "never_answered": {"value": sum(1 for ok in late.values() if not ok), "limit": 0},
        "served_min": {"value": sum(1 for r in served if r["phase"] == "window"),
                       "limit": 1},
    }


def passed(checks: dict) -> bool:
    return all((c["value"] >= c["limit"]) if name.endswith("_min") else (c["value"] <= c["limit"])
               for name, c in checks.items())


def window_stats(records: List[dict], t0: float, seconds: float, loop: str) -> dict:
    """attempted / failed / served in the window, and the latencies (ms,
    due to body read) of the requests served with valid work."""
    if loop == "closed":
        # a closed loop's window holds the requests that ended inside it
        win = [r for r in records if t0 <= r["end"] < t0 + seconds]
    else:
        win = [r for r in records if r["phase"] == "window"]
    failed = [r for r in win if r["outcome"] in ("busy", "timeout", "error")]
    ok = [r for r in win if r["outcome"] == "ok"]
    return {"attempted": len(win), "failed": len(failed), "served": len(ok),
            "latency_ms": sorted(1e3 * (r["end"] - r["due"]) for r in ok)}


def percentile(sorted_values: List[float], q: float) -> Optional[float]:
    """Exact percentile by linear interpolation between closest ranks
    (numpy's default), of an ascending list."""
    if not sorted_values:
        return None
    pos = (len(sorted_values) - 1) * q
    lo = int(pos)
    hi = min(lo + 1, len(sorted_values) - 1)
    return sorted_values[lo] + (sorted_values[hi] - sorted_values[lo]) * (pos - lo)


def slices(records: List[dict], t0: float, seconds: float, width: float = 5.0) -> List[str]:
    """Per ``width`` seconds of the window by due time: requests, p95 of the
    served (ms) and the generator's largest issue lag (ms), for stderr."""
    out = []
    for k in range(int(seconds // width) + (seconds % width > 0)):
        lo = t0 + k * width
        part = [r for r in records if lo <= r["due"] < lo + width]
        lat = sorted(1e3 * (r["end"] - r["due"]) for r in part if r["outcome"] == "ok")
        p95 = percentile(lat, 0.95)
        lag = max((1e3 * (r["sent"] - r["due"]) for r in part), default=0.0)
        out.append(f"{k * width:g}s n={len(part)} p95={p95 if p95 is None else round(p95, 1)}"
                   f" lag={lag:.1f}")
    return out


def lag_summary(records: List[dict]) -> str:
    """The window's issue lag (sent - due) and, of the served, the time from
    issue to body read (ms): p50, p95 and max each, for stderr. A swing of
    the latency that the second carries and the first does not is the
    stack's, not the generator's."""
    win = [r for r in records if r["phase"] == "window"]
    lag = sorted(1e3 * (r["sent"] - r["due"]) for r in win)
    own = sorted(1e3 * (r["end"] - r["sent"]) for r in win if r["outcome"] == "ok")

    def three(v):
        if not v:
            return "none"
        return f"p50 {percentile(v, 0.5):.2f} p95 {percentile(v, 0.95):.2f} max {v[-1]:.2f}"
    return f"issue lag {three(lag)}; issue to answer {three(own)}"
