"""Proportional reward payouts from a snapshot file
(reference server/scripts/payouts.py).

``python -m tpu_dpow_torch.scripts.payouts payouts_<ts>.json --wallet W
--source ACCOUNT [--node URI] [--fraction F] [--dry_run]``; the port's copy
of ``tpu_dpow/scripts/payouts.py``.

Reads a ``payouts_<ts>.json`` produced by client_snapshot, splits a fraction
of the payer wallet's balance proportionally to works done (reference
payouts.py:62-78), and issues one node-RPC ``send`` per client with the
snapshot's per-payout uuid as the send ``id`` — the node deduplicates on id,
so re-running after a crash never double-pays (reference :95). ``--dry_run``
prints the plan; a real run demands the explicit confirmation phrase
(reference :84-87).
"""

from __future__ import annotations

import argparse
import json
import sys
from decimal import Decimal

import requests

from ..utils import nanocrypto as nc

CONFIRM_PHRASE = "OFCOURSE"  # reference payouts.py:84-87


def node(rpc_uri: str, action: str, **kwargs) -> dict:
    """One Nano node RPC call (reference payouts.py:29)."""
    reply = requests.post(rpc_uri, json={"action": action, **kwargs}, timeout=30)
    reply.raise_for_status()
    data = reply.json()
    if "error" in data:
        raise RuntimeError(f"node rpc {action}: {data['error']}")
    return data


def plan_payouts(payouts: dict, balance_raw: int, fraction: float) -> dict:
    """{address: raw_amount} — proportional to works, floored to integer raw."""
    total_works = sum(p["works"] for p in payouts.values())
    if total_works == 0:
        return {}
    pool = int(Decimal(balance_raw) * Decimal(str(fraction)))
    shares = {
        addr: pool * p["works"] // total_works for addr, p in payouts.items()
    }
    return {addr: share for addr, share in shares.items() if share > 0}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("payouts_file", help="payouts_<ts>.json from client_snapshot")
    p.add_argument("--node", default="http://[::1]:7076", help="node RPC URI")
    p.add_argument("--wallet", required=True)
    p.add_argument("--source", required=True, help="paying account in the wallet")
    p.add_argument("--fraction", type=float, default=1.0,
                   help="fraction of the source balance to distribute")
    p.add_argument("--dry_run", action="store_true")
    args = p.parse_args(argv)

    if not 0 < args.fraction <= 1.0:
        print("--fraction must be in (0, 1]", file=sys.stderr)
        return 1
    nc.validate_account(args.source)

    with open(args.payouts_file) as f:
        payouts = json.load(f)
    if not payouts:
        print("nothing to pay")
        return 0

    balance_raw = int(
        node(args.node, "account_balance", account=args.source)["balance"]
    )
    plan = plan_payouts(payouts, balance_raw, args.fraction)

    total = sum(plan.values())
    print(f"source balance : {nc.raw_to_nano(balance_raw)} nano")
    print(f"distributing   : {nc.raw_to_nano(total)} nano to {len(plan)} clients")
    for addr, raw in sorted(plan.items(), key=lambda kv: -kv[1]):
        print(f"  {addr}  {payouts[addr]['works']:>7} works  {nc.raw_to_nano(raw)} nano")
    if args.dry_run:
        return 0

    phrase = input(f"Type {CONFIRM_PHRASE} to send: ")
    if phrase != CONFIRM_PHRASE:
        print("aborted")
        return 1

    for addr, raw in plan.items():
        reply = node(
            args.node,
            "send",
            wallet=args.wallet,
            source=args.source,
            destination=addr,
            amount=str(raw),
            id=payouts[addr]["uuid"],  # idempotency key (reference :95)
        )
        print(f"sent {nc.raw_to_nano(raw)} nano -> {addr}: block {reply.get('block')}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
