"""The node feed: a Nano node's HTTP callback of confirmed blocks, posted to
the hub's ``POST /block/`` face.

A chained caller (``drive.closed_loop`` with a mix's ``chain``) publishes a
block once it has its work; the node confirms it ``confirm_s`` later. Each
confirmation is one POST in the node's callback shape::

    {"account": "nano_...", "hash": "<block>",
     "block": "{\\"type\\": \\"state\\", \\"account\\": ..., \\"previous\\": ...}"}

``block`` is a JSON string, as the node sends it; the hub reads ``account``,
``hash`` and the block's ``previous``. Confirmations are paced on this
process's clock through warm-up and window alike; those still due when the
traffic ends are dropped.
"""

from __future__ import annotations

import asyncio
import json
import time
from typing import List, Set, Tuple

from . import prom

DECISIONS = "dpow_precache_decisions_total"
REQUESTS = "dpow_precache_requests_total"


def callback_body(account: str, block_hash: str, previous: str) -> dict:
    block = {"type": "state", "account": account, "previous": previous}
    return {"account": account, "hash": block_hash, "block": json.dumps(block)}


class NodeFeed:
    """Posts each confirmation at its due time; counts the posts the face
    answered with 200 and those it did not (an error or another status),
    each with its time on ``time.perf_counter``."""

    def __init__(self, base_url: str):
        self.url = base_url + "/block/"
        self.posts: List[Tuple[float, bool]] = []
        self._session = None
        self._tasks: Set[asyncio.Task] = set()

    async def start(self) -> None:
        import aiohttp

        self._session = aiohttp.ClientSession()

    def confirm(self, account: str, block_hash: str, previous: str, at: float) -> None:
        """Confirm ``block_hash`` (``previous`` before it) at ``at``."""
        task = asyncio.ensure_future(self._post(callback_body(account, block_hash, previous), at))
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)

    async def _post(self, body: dict, at: float) -> None:
        import aiohttp

        await asyncio.sleep(max(0.0, at - time.perf_counter()))
        try:
            async with self._session.post(self.url, json=body) as resp:
                ok = resp.status == 200
        except (aiohttp.ClientError, asyncio.TimeoutError):
            ok = False
        self.posts.append((time.perf_counter(), ok))

    async def close(self) -> None:
        tasks = list(self._tasks)
        for task in tasks:
            task.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
        session, self._session = self._session, None
        if session is not None:
            await session.close()

    def summary(self, pages: dict, t0: float, seconds: float) -> str:
        """Confirmations posted and failed (the whole run, then the window's),
        and the window's precache verdicts and request outcomes from the
        hub's pages, for stderr."""
        ok = sum(1 for _t, good in self.posts if good)
        win = [good for t, good in self.posts if t0 <= t < t0 + seconds]
        before, after = pages["before"]["hub"], pages["after"]["hub"]

        def deltas(name: str, label: str) -> str:
            keys = sorted({lab[label] for lab, _v in after.get(name, []) if label in lab})
            parts = [f"{k}={prom.delta(before, after, name, {label: k}):g}" for k in keys]
            return " ".join(parts) or "none"
        return (f"posted={ok} failed={len(self.posts) - ok} (window: posted={sum(win)} "
                f"failed={len(win) - sum(win)}); precache decisions: "
                f"{deltas(DECISIONS, 'verdict')}; requests: {deltas(REQUESTS, 'outcome')}")
