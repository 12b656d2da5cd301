"""Traffic: a frozen copy of the port's generator, read from a mix's data file.

Copied from ``tpu_dpow_torch.loadgen`` (``population.ServicePopulation``'s
request side, ``driver.HttpPostDriver``, ``driver.WsDriver`` and
``driver.classify_response``) so that the yardstick does not move when the
program's generator does. Three departures, each for the benchmark's sake:

  * open-loop arrivals are a Poisson process conditioned on its count: a run
    of ``seconds`` at ``rate`` holds exactly ``round(rate * seconds)``
    arrivals, placed as the sorted draws of the rate's density. Every seed
    then offers the same amount of work, in another order;
  * the services' profiles (Zipf weight, reuse, cancel rate, patience) come
    from the mix's own ``profile_seed``: the population is part of the
    deployment, the stream of requests is what ``--seed`` draws;
  * a face returns the work it was served, not only an outcome, so every
    answer can be judged.

A request may name the Nano account whose block it asks work for
(``RequestSpec.account``, an address from ``nano_account``): only then does
its body carry ``"account"``, so a mix that names none sends the bodies it
always sent.
"""

from __future__ import annotations

import asyncio
import hashlib
import itertools
import json
import math
import random
from bisect import bisect_right
from collections import deque
from dataclasses import dataclass
from typing import Deque, Dict, List, Optional, Sequence, Tuple

#: slack added to a request's own timeout before the client gives up on a
#: reply (the hub answers its own deadline first in a healthy run)
TIMEOUT_GRACE = 2.0


@dataclass(frozen=True)
class RequestSpec:
    """One request the driver issues."""

    intended_t: float
    service: str
    api_key: str
    hash: str
    timeout: float
    #: seconds after issue at which the client abandons the request
    cancel_after: Optional[float] = None
    #: the Nano account whose next block the work is for
    account: Optional[str] = None


def request_body(spec: RequestSpec) -> dict:
    """The service faces' request body: ``account`` only where it is set."""
    body = {"user": spec.service, "api_key": spec.api_key, "hash": spec.hash,
            "timeout": spec.timeout}
    if spec.account is not None:
        body["account"] = spec.account
    return body


#: Nano's base32 alphabet (no 0, 2, l, v)
NANO_ALPHABET = "13456789abcdefghijkmnopqrstuwxyz"


def _nano_base32(value: int, chars: int) -> str:
    return "".join(NANO_ALPHABET[(value >> (5 * k)) & 0x1F] for k in range(chars - 1, -1, -1))


def nano_account(public_key: bytes) -> str:
    """The ``nano_`` address of a 32-byte public key: the key in 52 base32
    digits (4 zero bits first), then its 5-byte blake2b checksum, bytes
    reversed, in 8."""
    if len(public_key) != 32:
        raise ValueError("a Nano public key is 32 bytes")
    check = hashlib.blake2b(public_key, digest_size=5).digest()[::-1]
    return ("nano_" + _nano_base32(int.from_bytes(public_key, "big"), 52)
            + _nano_base32(int.from_bytes(check, "big"), 8))


def draw_seconds(value, rng: random.Random) -> float:
    """A mix's time in seconds: a number, or ``{"lognormal": [median, sigma]}``."""
    if isinstance(value, (int, float)):
        return float(value)
    (kind, args), = value.items()
    if kind == "lognormal":
        return float(args[0]) * math.exp(rng.gauss(0.0, float(args[1])))
    raise ValueError(f"unknown distribution {kind!r}")


@dataclass(frozen=True)
class ServiceProfile:
    name: str
    api_key: str
    weight: float
    reuse_prob: float
    cancel_rate: float
    timeout_median: float
    timeout_sigma: float


def arrival_times(rate: float, seconds: float, rng: random.Random,
                  spikes: Sequence[dict] = ()) -> List[float]:
    """Arrival times in [0, seconds) of a Poisson process of ``rate``
    requests/s, times ``factor`` inside each spike's ``[at, at + duration)``,
    conditioned on its expected count."""
    spans = [(float(s["at"]), float(s["at"]) + float(s["duration"]), float(s["factor"]))
             for s in spikes]
    edges = sorted({0.0, float(seconds)}
                   | {min(max(x, 0.0), seconds) for a, b, _f in spans for x in (a, b)})
    segments = []
    for lo, hi in zip(edges, edges[1:]):
        factor = math.prod(f for a, b, f in spans if a <= lo < b)
        segments.append((lo, hi, rate * factor * (hi - lo)))
    total = sum(w for _lo, _hi, w in segments)
    cum = list(itertools.accumulate(w for _lo, _hi, w in segments))
    times = []
    for _ in range(int(round(total))):
        i = min(bisect_right(cum, rng.random() * total), len(segments) - 1)
        lo, hi, _w = segments[i]
        times.append(lo + rng.random() * (hi - lo))
    return sorted(times)


class ServicePopulation:
    """Services with a Zipf popularity, hash reuse, abandon rate and
    log-normal patience (the port's ``ServicePopulation``, request side)."""

    def __init__(
        self,
        n_services: int = 1000,
        *,
        profile_seed: int = 0,
        stream_seed: int = 0,
        zipf_s: float = 1.1,
        reuse_prob: Tuple[float, float] = (0.0, 0.35),
        cancel_rate: Tuple[float, float] = (0.0, 0.08),
        timeout_median: Tuple[float, float] = (4.0, 16.0),
        timeout_sigma: float = 0.5,
        timeout_floor: float = 1.0,
        timeout_cap: float = 30.0,
        reuse_window: int = 8,
        hot_hash_prob: float = 0.02,
        hot_window: int = 4,
    ):
        if n_services < 1:
            raise ValueError("need at least one service")
        self._rng = random.Random(f"stream:{stream_seed}")
        profile_rng = random.Random(profile_seed)
        self.timeout_floor = timeout_floor
        self.timeout_cap = timeout_cap
        self.hot_hash_prob = hot_hash_prob
        self.profiles: List[ServiceProfile] = []
        cum: List[float] = []
        total = 0.0
        for i in range(n_services):
            weight = 1.0 / (i + 1) ** zipf_s
            self.profiles.append(ServiceProfile(
                name=f"svc-{i:05d}",
                api_key=f"key-{i:05d}",
                weight=weight,
                reuse_prob=profile_rng.uniform(*reuse_prob),
                cancel_rate=profile_rng.uniform(*cancel_rate),
                timeout_median=profile_rng.uniform(*timeout_median),
                timeout_sigma=timeout_sigma,
            ))
            total += weight
            cum.append(total)
        self._cum = cum
        self._total = total
        self._recent: Dict[str, Deque[str]] = {}
        self._hot: Deque[str] = deque(maxlen=hot_window)
        self._reuse_window = reuse_window

    def _pick_service(self) -> ServiceProfile:
        r = self._rng.random() * self._total
        return self.profiles[min(bisect_right(self._cum, r), len(self.profiles) - 1)]

    def fresh_hash(self) -> str:
        return f"{self._rng.getrandbits(256):064X}"

    def spec(self, t: float) -> RequestSpec:
        """One request arriving at ``t``: a Zipf-picked service asks for a
        hot hash, one of its recent hashes, or a fresh one."""
        profile = self._pick_service()
        rng = self._rng
        recent = self._recent.setdefault(profile.name, deque(maxlen=self._reuse_window))
        if self._hot and rng.random() < self.hot_hash_prob:
            block_hash = self._hot[rng.randrange(len(self._hot))]
        elif recent and rng.random() < profile.reuse_prob:
            block_hash = recent[rng.randrange(len(recent))]
        else:
            block_hash = self.fresh_hash()
            recent.append(block_hash)
            self._hot.append(block_hash)
        timeout = profile.timeout_median * math.exp(rng.gauss(0.0, profile.timeout_sigma))
        timeout = min(max(timeout, self.timeout_floor), self.timeout_cap)
        cancel_after = None
        if rng.random() < profile.cancel_rate:
            # abandon inside the first half of the patience window
            cancel_after = timeout * rng.uniform(0.05, 0.5)
        return RequestSpec(t, profile.name, profile.api_key, block_hash,
                           round(timeout, 3), cancel_after)


def classify_response(status: Optional[int], data: object) -> str:
    """Map one service-face reply onto an outcome."""
    if not isinstance(data, dict):
        return "error"
    if (status == 429) or data.get("busy"):
        return "busy"
    if "work" in data:
        return "ok"
    if data.get("timeout"):
        return "timeout"
    return "error"


class HttpFace:
    """``POST /service/`` on one hub."""

    def __init__(self, base_url: str):
        self.url = base_url + "/service/"
        self._session = None

    async def start(self) -> None:
        import aiohttp

        self._session = aiohttp.ClientSession(
            connector=aiohttp.TCPConnector(limit=0))

    async def __call__(self, spec: RequestSpec) -> Tuple[str, Optional[str]]:
        import aiohttp

        try:
            async with self._session.post(
                self.url, json=request_body(spec),
                timeout=aiohttp.ClientTimeout(total=spec.timeout + TIMEOUT_GRACE),
            ) as resp:
                data = await resp.json(content_type=None)
                status = resp.status
        except asyncio.TimeoutError:
            return "timeout", None
        except (aiohttp.ClientError, json.JSONDecodeError, ValueError):
            return "error", None
        work = data.get("work") if isinstance(data, dict) else None
        return classify_response(status, data), work

    async def close(self) -> None:
        session, self._session = self._session, None
        if session is not None:
            await session.close()


class WsFace:
    """``/service_ws/`` on one hub: a pool of long-lived connections with
    id-correlated replies."""

    def __init__(self, base_url: str, conns: int = 2):
        self.url = base_url + "/service_ws/"
        self.n_conns = conns
        self._session = None
        self._conns: List[dict] = []
        self._rr = itertools.count()
        self._ids = itertools.count(1)

    async def start(self) -> None:
        import aiohttp

        self._session = aiohttp.ClientSession()
        for _ in range(self.n_conns):
            ws = await self._session.ws_connect(self.url)
            conn = {"ws": ws, "pending": {}}
            conn["reader"] = asyncio.ensure_future(self._read(conn))
            self._conns.append(conn)

    async def _read(self, conn: dict) -> None:
        import aiohttp

        try:
            async for msg in conn["ws"]:
                if msg.type != aiohttp.WSMsgType.TEXT:
                    continue
                try:
                    data = json.loads(msg.data)
                except json.JSONDecodeError:
                    continue
                fut = conn["pending"].pop(data.get("id"), None)
                if fut is not None and not fut.done():
                    fut.set_result(data)
        finally:
            # the socket died: fail every reply still owed on it
            if conn in self._conns:
                self._conns.remove(conn)
            for fut in conn["pending"].values():
                if not fut.done():
                    fut.set_exception(ConnectionError("ws face closed"))
            conn["pending"].clear()

    async def __call__(self, spec: RequestSpec) -> Tuple[str, Optional[str]]:
        if not self._conns:
            return "error", None
        conn = self._conns[next(self._rr) % len(self._conns)]
        rid = next(self._ids)
        fut = asyncio.get_running_loop().create_future()
        conn["pending"][rid] = fut
        try:
            await conn["ws"].send_json({**request_body(spec), "id": rid})
            data = await asyncio.wait_for(fut, spec.timeout + TIMEOUT_GRACE)
        except asyncio.TimeoutError:
            return "timeout", None
        except (ConnectionError, RuntimeError):
            return "error", None
        finally:
            conn["pending"].pop(rid, None)
        work = data.get("work") if isinstance(data, dict) else None
        return classify_response(None, data), work

    async def close(self) -> None:
        conns, self._conns = list(self._conns), []
        for conn in conns:
            await conn["ws"].close()
            conn["reader"].cancel()
            await asyncio.gather(conn["reader"], return_exceptions=True)
        session, self._session = self._session, None
        if session is not None:
            await session.close()
