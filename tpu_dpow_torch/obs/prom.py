"""Prometheus text exposition (format v0.0.4): renderer, parser, HTTP route.

The renderer turns a Registry into the plain-text page any Prometheus /
VictoriaMetrics / agent scraper ingests; the parser is the inverse, used by
``scripts/check_latency.py --from-metrics`` (and the renderer golden test)
so the repo's own tooling consumes the same surface operators scrape —
no privileged side-channel.

Mounting: ``add_metrics_route(app)`` hangs GET /metrics off any aiohttp
app — the server's upcheck app and the client's metrics app both use it.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

from .registry import Histogram, Registry, get_registry


def _escape_help(s: str) -> str:
    return s.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label(s: str) -> str:
    return s.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _labels(names: Tuple[str, ...], values: Tuple[str, ...],
            extra: Tuple[Tuple[str, str], ...] = ()) -> str:
    pairs = [(n, v) for n, v in zip(names, values)] + list(extra)
    if not pairs:
        return ""
    body = ",".join(f'{n}="{_escape_label(v)}"' for n, v in pairs)
    return "{" + body + "}"


def _fmt(value: float) -> str:
    if value == math.inf:
        return "+Inf"
    if value == -math.inf:
        return "-Inf"
    f = float(value)
    return str(int(f)) if f.is_integer() and abs(f) < 1e15 else repr(f)


def render(registry: Optional[Registry] = None) -> str:
    """The registry as a Prometheus text-format v0.0.4 page."""
    registry = registry or get_registry()
    lines: List[str] = []
    for fam in registry.collect():
        lines.append(f"# HELP {fam.name} {_escape_help(fam.help)}")
        lines.append(f"# TYPE {fam.name} {fam.kind}")
        if isinstance(fam, Histogram):
            for key, data in sorted(fam.collect().items()):
                for le, cum in data["buckets"]:
                    lines.append(
                        f"{fam.name}_bucket"
                        f"{_labels(fam.labelnames, key, (('le', _fmt(le)),))}"
                        f" {cum}"
                    )
                lines.append(
                    f"{fam.name}_sum{_labels(fam.labelnames, key)}"
                    f" {_fmt(data['sum'])}"
                )
                lines.append(
                    f"{fam.name}_count{_labels(fam.labelnames, key)}"
                    f" {data['count']}"
                )
        else:
            for key, value in sorted(fam.collect().items()):
                lines.append(
                    f"{fam.name}{_labels(fam.labelnames, key)} {_fmt(value)}"
                )
    return "\n".join(lines) + "\n"


def parse_text(text: str) -> Dict[str, List[Tuple[Dict[str, str], float]]]:
    """Inverse of render(): {metric_name: [(labels, value), ...]}.

    Histogram series arrive under their _bucket/_sum/_count sample names
    (as on the wire); comments and blank lines are skipped. Tolerates any
    v0.0.4 page, not just our renderer's output.
    """
    out: Dict[str, List[Tuple[Dict[str, str], float]]] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        if "{" in line:
            name, rest = line.split("{", 1)
            labelpart, valuepart = rest.rsplit("}", 1)
            labels = _parse_labels(labelpart)
            value = valuepart.strip().split()[0]
        else:
            parts = line.split()
            if len(parts) < 2:
                continue
            name, value = parts[0], parts[1]
            labels = {}
        try:
            v = float(value)
        except ValueError:
            if value == "+Inf":
                v = math.inf
            elif value == "-Inf":
                v = -math.inf
            else:
                continue
        out.setdefault(name, []).append((labels, v))
    return out


def _parse_labels(body: str) -> Dict[str, str]:
    labels: Dict[str, str] = {}
    i = 0
    while i < len(body):
        eq = body.index("=", i)
        name = body[i:eq].strip().lstrip(",").strip()
        # value is a double-quoted string with \\ \" \n escapes
        j = body.index('"', eq) + 1
        buf = []
        while j < len(body):
            c = body[j]
            if c == "\\" and j + 1 < len(body):
                nxt = body[j + 1]
                buf.append({"n": "\n", '"': '"', "\\": "\\"}.get(nxt, nxt))
                j += 2
                continue
            if c == '"':
                break
            buf.append(c)
            j += 1
        labels[name] = "".join(buf)
        i = j + 1
    return labels


def histogram_quantile(
    buckets: List[Tuple[float, float]], q: float
) -> Optional[float]:
    """Prometheus-style quantile estimate from cumulative (le, count) rows.

    Linear interpolation within the winning bucket (its lower edge taken
    from the previous bucket's le, 0 for the first) — the same estimate
    promQL's histogram_quantile() produces, so a --from-metrics probe and a
    dashboard panel over the same scrape agree.
    """
    rows = sorted(buckets)
    if not rows:
        return None
    total = rows[-1][1]
    if total <= 0:
        return None
    rank = q * total
    lower = 0.0
    prev_cum = 0.0
    for le, cum in rows:
        if cum >= rank:
            if le == math.inf:
                return lower  # open-ended bucket: its lower edge
            width = le - lower
            inside = cum - prev_cum
            if inside <= 0:
                return le
            return lower + width * (rank - prev_cum) / inside
        lower = le if le != math.inf else lower
        prev_cum = cum
    return lower


def add_metrics_route(app, registry: Optional[Registry] = None) -> None:
    """Mount GET /metrics (and /metrics/) on an aiohttp application."""
    from aiohttp import web

    async def metrics_handler(request: "web.Request") -> "web.Response":
        return web.Response(text=render(registry), content_type="text/plain")

    app.router.add_get("/metrics", metrics_handler)
    app.router.add_get("/metrics/", metrics_handler)
