"""Operator CLIs of the port — parity with the reference's server/scripts/ suite.

Counterpart of ``tpu_dpow/scripts/``; each runs as ``python -m
tpu_dpow_torch.scripts.<name>``:

  services        — service-record CRUD + stats   (reference scripts/services.py)
  client_snapshot — payout prep snapshots         (reference scripts/client_snapshot.py)
  payouts         — proportional reward payouts   (reference scripts/payouts.py)
  check_latency   — passive transport latency probe (reference scripts/check_latency.py)
  chaos_demo      — scripted drop/fail/recover walkthrough of the resilience layer

All of them talk to the same Store seam the server uses: pass
``--store redis://...`` for a live deployment, or the path of a MemoryStore
checkpoint file (server ``--checkpoint_path``) to inspect/mutate offline
state — the test seam the reference's redis-only scripts never had.
"""

from __future__ import annotations

import contextlib
from typing import AsyncIterator

from ..store import MemoryStore, Store, get_store


@contextlib.asynccontextmanager
async def open_store(uri: str) -> AsyncIterator[Store]:
    """Open a store by URI; checkpoint-file stores persist mutations on exit.

    sqlite:// operates on the server's live database (WAL mode permits the
    concurrent reader/writer), the reference's redis-cli-style ops access.
    """
    if uri.startswith(("redis://", "sqlite://")) or uri == "memory":
        store = get_store(uri)
        await store.setup()
        try:
            yield store
        finally:
            await store.close()
        return
    # Anything else is a MemoryStore checkpoint path (load → mutate → save).
    store = MemoryStore()
    with contextlib.suppress(FileNotFoundError):
        # dpowlint: disable=DPOW201 — one-shot operator CLI, nothing else shares this event loop
        store.load(uri)
    yield store
    # dpowlint: disable=DPOW201 — same: CLI exit path, no concurrent loop work to stall
    store.save(uri)
