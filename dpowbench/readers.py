"""Arithmetic that more than one per-layer reader in ``metrics/`` shares.

A reader takes ``src``, the run's captured sources:

  ``hub``, ``worker``  (page at the window's start, page at its end), each
                       parsed by ``prom.parse_text``
  ``trace``            ``devtrace.reduce`` of the worker's device trace, or
                       None without one
  ``threshold``        the hub's difficulty as an integer
  ``max_batch``        the worker's ``--max_batch``
  ``kind``, ``clocks`` the card's name and ``roofline.card_clocks()``
  ``stats``            the window's attempted, failed and served counts

and returns a number, or None where it finds nothing to read.
"""

from __future__ import annotations

from typing import Optional

from . import prom

STAGES = "dpow_request_stage_seconds"


def stage_ms(pages, stages) -> Optional[float]:
    """Sum over ``stages`` of each stage's mean in the window, in ms."""
    before, after = pages
    means = [prom.mean_delta(before, after, STAGES, {"stage": s}) for s in stages]
    if any(m is None for m in means):
        return None
    return 1e3 * sum(means)


def overscan(src) -> Optional[float]:
    """Nonces scanned per solution over the 2^64 / (2^64 - threshold)
    expected per solution."""
    before, after = src["worker"]
    torch_engine = {"engine": "torch"}
    hashes = prom.delta(before, after, "dpow_engine_hashes_total", torch_engine)
    solutions = prom.delta(before, after, "dpow_engine_solutions_total", torch_engine)
    if solutions <= 0:
        return None
    expected = 2.0 ** 64 / (2 ** 64 - src["threshold"])
    return hashes / (solutions * expected)


def idle_pct(src) -> Optional[float]:
    trace = src["trace"]
    if trace is None or trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
