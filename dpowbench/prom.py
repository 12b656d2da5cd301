"""Prometheus text pages: a frozen copy of the port's parser and the deltas
the readers take between a page read at the window's start and one at its end.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

Page = Dict[str, List[Tuple[Dict[str, str], float]]]


def parse_text(text: str) -> Page:
    """{metric_name: [(labels, value), ...]}; histogram series arrive under
    their _bucket/_sum/_count sample names, comments and blank lines skipped."""
    out: Page = {}
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


def value(page: Page, name: str, labels: Optional[dict] = None) -> float:
    """Sum of the samples of ``name`` whose labels include ``labels``."""
    return sum(v for lab, v in page.get(name, [])
               if all(lab.get(k) == w for k, w in (labels or {}).items()))


def delta(before: Page, after: Page, name: str, labels: Optional[dict] = None) -> float:
    return value(after, name, labels) - value(before, name, labels)


def mean_delta(before: Page, after: Page, name: str,
               labels: Optional[dict] = None) -> Optional[float]:
    """Mean of a histogram's observations between two pages (_sum/_count
    deltas), or None where it observed nothing."""
    count = delta(before, after, name + "_count", labels)
    if count <= 0:
        return None
    return delta(before, after, name + "_sum", labels) / count
