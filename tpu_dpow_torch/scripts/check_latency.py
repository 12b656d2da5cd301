"""Passive transport latency probe (reference server/scripts/check_latency.py).

``python -m tpu_dpow_torch.scripts.check_latency [--uri mqtt://HOST:1883]
[--duration S] | --from-metrics URL``; the port's copy of
``tpu_dpow/scripts/check_latency.py``.

Subscribes to ``work/# result/# cancel/#`` (and ``statistics``) as an
observer and times, per block hash, the deltas work→first-result and
work→cancel — the live round-trip health of the swarm (reference
check_latency.py:18-39). Works against any Transport; the default connects
to a TCP broker as the dashboard user.

``--from-metrics [URL]`` skips the probe entirely and reads the product's
own telemetry instead: it scrapes the Prometheus ``/metrics`` surface
(server upcheck port by default) and summarizes the request-latency and
per-stage span histograms the stack itself populated — the passive probe
measures only what happens to fly by while it watches, the metrics mode
reads everything the server served since it started.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import statistics
import sys
import time
from typing import Dict, Optional

from ..transport import QOS_0, Transport, wire
from ..transport.tcp import TcpTransport


class LatencyProbe:
    def __init__(self, transport: Transport, *, quiet: bool = False):
        self.transport = transport
        self.quiet = quiet
        self.work_sent: Dict[str, float] = {}
        self.result_deltas: list = []
        self.cancel_deltas: list = []

    # Entries older than this can no longer produce a meaningful delta (the
    # server's request timeout tops out at 30 s — reference
    # server/dpow_server.py:330-336); prune them so a long-running probe on a
    # busy broker doesn't grow work_sent without bound.
    MAX_PENDING_AGE = 120.0

    async def run(self, duration: Optional[float] = None) -> None:
        await self.transport.connect()
        for pattern in ("work/#", "result/#", "cancel/#", "statistics"):
            await self.transport.subscribe(pattern, qos=QOS_0)
        deadline = None if duration is None else time.monotonic() + duration
        messages = self.transport.messages()
        while True:
            # Bound the wait so an idle broker still honors --duration.
            timeout = None if deadline is None else deadline - time.monotonic()
            if timeout is not None and timeout <= 0:
                break
            try:
                msg = await asyncio.wait_for(anext(messages), timeout)
            except (asyncio.TimeoutError, StopAsyncIteration):
                break
            self.on_message(msg.topic, msg.payload)

    def _prune(self, now: float) -> None:
        cutoff = now - self.MAX_PENDING_AGE
        # Insertion order == ascending start time, so stop at the first
        # fresh entry: amortized O(1) per message instead of a full scan on
        # exactly the busy brokers the prune exists for.
        stale = []
        for block_hash, start in self.work_sent.items():
            if start >= cutoff:
                break
            stale.append(block_hash)
        for block_hash in stale:
            del self.work_sent[block_hash]

    def on_message(self, topic: str, payload: str) -> None:
        now = time.monotonic()
        self._prune(now)
        if topic.startswith("work/"):
            # work/# includes the per-worker lanes, which may carry binary
            # v1 (batched) frames on a negotiated fleet — decode by version
            # so the probe keeps correlating mixed traffic. Hash case is
            # canonicalized: v1 decodes lowercase, v0 ships uppercase.
            try:
                for item in wire.decode_work_any(payload):
                    self.work_sent.setdefault(item[0].upper(), now)
            except ValueError:
                pass
            return
        elif topic.startswith("result/"):
            # get, not pop: the cancel fan-out for this hash arrives after
            # the winning result and still needs the start time; _prune is
            # what keeps work_sent bounded.
            try:
                block_hash = wire.decode_result_any(payload)[0].upper()
            except ValueError:
                return
            start = self.work_sent.get(block_hash)
            if start is not None:
                delta = now - start
                self.result_deltas.append(delta)
                if not self.quiet:
                    print(f"result {block_hash[:16]}… after {delta * 1000:.1f} ms")
        elif topic.startswith("cancel/"):
            block_hash = payload.strip()
            start = self.work_sent.pop(block_hash, None)
            if start is not None:
                delta = now - start
                self.cancel_deltas.append(delta)
                if not self.quiet:
                    print(f"cancel {block_hash[:16]}… after {delta * 1000:.1f} ms")
        elif topic == "statistics" and not self.quiet:
            print(f"statistics: {payload}")

    def summary(self) -> dict:
        def pct(xs, q):
            return round(statistics.quantiles(xs, n=100)[q - 1] * 1000, 2) if len(xs) > 1 else None

        return {
            "results": len(self.result_deltas),
            "cancels": len(self.cancel_deltas),
            "result_p50_ms": pct(self.result_deltas, 50),
            "result_p90_ms": pct(self.result_deltas, 90),
            "cancel_p50_ms": pct(self.cancel_deltas, 50),
        }


def summarize_metrics(text: str) -> dict:
    """Summary of a scraped /metrics page: request counts + latency
    quantiles per work type, and the per-stage span p50s. Pure function so
    tests can feed it a rendered page without a socket."""
    from ..obs import histogram_quantile, parse_text

    samples = parse_text(text)

    def buckets_by_label(metric: str, label: str) -> dict:
        out = {}
        for labels, value in samples.get(f"{metric}_bucket", ()):
            key = labels.get(label, "")
            out.setdefault(key, []).append((float(labels["le"]), value))
        return out

    def q_ms(rows, q):
        v = histogram_quantile(rows, q)
        return round(v * 1000, 2) if v is not None else None

    requests = {
        labels.get("work_type", ""): value
        for labels, value in samples.get("dpow_server_requests_total", ())
    }
    latency = {}
    for work_type, rows in buckets_by_label(
        "dpow_server_request_seconds", "work_type"
    ).items():
        count = int(max(c for _, c in rows)) if rows else 0
        latency[work_type] = {
            "count": count,
            "p50_ms": q_ms(rows, 0.50),
            "p90_ms": q_ms(rows, 0.90),
        }
    stages = {
        stage: q_ms(rows, 0.50)
        for stage, rows in buckets_by_label(
            "dpow_request_stage_seconds", "stage"
        ).items()
    }
    return {
        "source": "metrics",
        "requests_total": requests,
        "request_latency": latency,
        "stage_p50_ms": stages,
    }


async def scrape_metrics(url: str) -> dict:
    import aiohttp

    async with aiohttp.ClientSession() as http:
        async with http.get(url, timeout=aiohttp.ClientTimeout(total=10)) as resp:
            resp.raise_for_status()
            return summarize_metrics(await resp.text())


async def amain(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=1883)
    p.add_argument("--from-metrics", dest="from_metrics", nargs="?",
                   const="http://127.0.0.1:5031/metrics", default=None,
                   metavar="URL",
                   help="summarize the stack's own /metrics endpoint "
                   "(default URL: the server upcheck port) instead of "
                   "timing a live probe")
    p.add_argument("--username", default="dpowinterface")
    p.add_argument("--password", default="dpowinterface")
    p.add_argument("--uri", default=None,
                   help="full broker URI (tcp:// | mqtt:// | ws://) overriding "
                   "host/port — mqtt:// also observes a stock Mosquitto, like "
                   "the reference's paho probe")
    p.add_argument("--duration", type=float, default=None, help="seconds; default forever")
    p.add_argument("--quiet", action="store_true")
    args = p.parse_args(argv)
    if args.from_metrics:
        print(json.dumps(await scrape_metrics(args.from_metrics)))
        return 0
    if args.uri:
        from urllib.parse import quote, urlparse, urlunparse

        from ..transport import transport_from_uri

        u = urlparse(args.uri)
        if not u.username:
            # Merge the credential flags into a URI given without userinfo
            # (percent-encoded: passwords may hold /, ?, @, #).
            creds = f"{quote(args.username, safe='')}:{quote(args.password, safe='')}"
            netloc = f"{creds}@{u.hostname or '127.0.0.1'}"
            if u.port:
                netloc += f":{u.port}"
            args.uri = urlunparse((u.scheme, netloc, u.path, "", u.query, ""))
        transport = transport_from_uri(args.uri)
    else:
        transport = TcpTransport(
            args.host, args.port, username=args.username, password=args.password
        )
    probe = LatencyProbe(transport, quiet=args.quiet)
    try:
        await probe.run(args.duration)
    except (KeyboardInterrupt, asyncio.CancelledError):
        pass
    finally:
        await transport.close()
    print(json.dumps(probe.summary()))
    return 0


def main(argv=None) -> int:
    return asyncio.run(amain(argv))


if __name__ == "__main__":
    sys.exit(main())
