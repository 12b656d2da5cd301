"""Payout-prep snapshots of client work counters
(reference server/scripts/client_snapshot.py).

``python -m tpu_dpow_torch.scripts.client_snapshot --store ... [--out_dir .]
[--min_works 50] [--exclude ADDR ...] [--dry_run]``; the port's copy of
``tpu_dpow/scripts/client_snapshot.py``, with the same uuid derivation (the
``tpu-dpow:`` name prefix included), so a hub moving between the two
packages keeps its send ids.

Diffs each ``client:{addr}`` counter hash against its ``snapshot_*`` fields,
skips clients below the minimum-work threshold (reference :47) and clients
with invalid payout addresses (reference :28-32), then emits two timestamped
JSON files:

  payouts_<ts>.json  — {address: {"works": n, "uuid": ...}} for the payer
  snapshot_<ts>.json — full counter state for the audit trail

and advances the ``snapshot_*`` fields so the next run starts from zero. The
per-payout uuid doubles as the idempotent node ``send`` id downstream
(reference payouts.py:95).

Migration note: the uuid derivation is keyed on the snapshot BASE values
plus a store-persisted per-window seed (stable across a crashed run and its
rerun, unique across counter resets). If you hold an UNPAID payouts file
produced by a build older than this note, pay it before upgrading or
discard it and rerun — old- and new-format uuids differ, so mixing files
across the upgrade loses the double-pay protection for that one window.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
import time
import uuid

from ..utils import nanocrypto as nc
from . import open_store

MIN_WORKS = 50  # reference client_snapshot.py:47
WORK_FIELDS = ("precache", "ondemand")


async def snapshot(store, *, min_works: int = MIN_WORKS, out_dir: str = ".",
                   exclude: frozenset = frozenset(), dry_run: bool = False) -> dict:
    ts = int(time.time())
    payouts: dict = {}
    snap: dict = {}
    for addr in sorted(await store.smembers("clients")):
        record = await store.hgetall(f"client:{addr}")
        snap[addr] = dict(record)
        if addr in exclude:
            continue
        try:
            nc.validate_account(addr)
        except nc.InvalidAccount:
            print(f"skipping invalid payout address {addr!r}", file=sys.stderr)
            continue
        new_works = sum(
            int(record.get(f, 0)) - int(record.get(f"snapshot_{f}", 0))
            for f in WORK_FIELDS
        )
        if new_works < min_works:
            continue
        # Deterministic uuid keyed on (snapshot BASE, per-window seed):
        #   * the base only advances after a successful run, and the seed —
        #     persisted in the store BEFORE the payout file exists — only
        #     rotates with that advance, so a crashed run's file and its
        #     rerun share the uuid even if more works landed in between:
        #     paying both sends at most once (the uuid is the node's
        #     idempotent send id downstream, reference payouts.py:95);
        #   * the random seed makes uuids unique across payout windows even
        #     when counters reset to identical values (fresh store, wipe) —
        #     base-only keying would deterministically collide there and
        #     the node would silently swallow the later window's send.
        seed_key = f"payout-seed:{addr}"
        seed = await store.get(seed_key)
        if seed is None:
            seed = str(uuid.uuid4())
            # Persisted in dry-run too (harmless metadata): otherwise a
            # dry-run preview would mint throwaway seeds and its uuids could
            # never match the real run's, defeating preview-then-pay.
            await store.set(seed_key, seed)
        state = ":".join(
            f"{record.get(f'snapshot_{f}', 0)}" for f in WORK_FIELDS
        )
        payouts[addr] = {
            "works": new_works,
            "uuid": str(
                uuid.uuid5(uuid.NAMESPACE_URL, f"tpu-dpow:{addr}:{state}:{seed}")
            ),
        }

    # Durability order matters (this is money-adjacent): persist the payout
    # record BEFORE advancing any snapshot_* counter, so a crash between the
    # two at worst re-derives the same payouts on rerun (same uuids — see
    # above) instead of silently losing credited works the way the
    # reference's advance-then-write order can (client_snapshot.py:54-62).
    # A crash in the middle of the counter loop below still shrinks the
    # rerun's file, but the already-written file plus idempotent uuids keep
    # every credited work payable exactly once.
    payouts_path = f"{out_dir}/payouts_{ts}.json"
    snapshot_path = f"{out_dir}/snapshot_{ts}.json"
    if not dry_run:
        with open(payouts_path, "w") as f:
            json.dump(payouts, f, indent=2)
        with open(snapshot_path, "w") as f:
            json.dump(snap, f, indent=2)
        for addr in payouts:
            await store.hset(
                f"client:{addr}",
                {f"snapshot_{f}": snap[addr].get(f, "0") for f in WORK_FIELDS},
            )
            # Rotate the uuid seed WITH the base advance: the next payout
            # window derives fresh send ids (a crash mid-loop leaves this
            # addr's seed in place, so its rerun still reuses the uuid).
            await store.delete(f"payout-seed:{addr}")
    return {
        "clients_eligible": len(payouts),
        "total_works": sum(p["works"] for p in payouts.values()),
        "payouts_file": payouts_path,
        "snapshot_file": snapshot_path,
        "dry_run": dry_run,
    }


async def amain(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--store", default="redis://localhost")
    p.add_argument("--min_works", type=int, default=MIN_WORKS)
    p.add_argument("--out_dir", default=".")
    p.add_argument("--exclude", nargs="*", default=[],
                   help="payout addresses to skip (e.g. the hub's own account)")
    p.add_argument("--dry_run", action="store_true")
    args = p.parse_args(argv)
    async with open_store(args.store) as store:
        result = await snapshot(
            store,
            min_works=args.min_works,
            out_dir=args.out_dir,
            exclude=frozenset(args.exclude),
            dry_run=args.dry_run,
        )
    print(json.dumps(result, indent=2))
    return 0


def main(argv=None) -> int:
    return asyncio.run(amain(argv))


if __name__ == "__main__":
    sys.exit(main())
