"""Service-record administration (reference server/scripts/services.py).

``python -m tpu_dpow_torch.scripts.services {add,update,delete,check,list,stats}
--store <sqlite://path | redis://... | checkpoint path>``; the port's copy of
``tpu_dpow/scripts/services.py``.

Service records live in the store as a ``service:{user}`` hash plus the
``services`` set (reference scripts/services.py:97-102); api_keys are stored
blake2b-hashed (reference :27-30) — the server compares hashes, never
plaintext. Unlike the reference's interactive prompts, every field is a flag
(scriptable), with prompts only as fallback for missing required values.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import secrets
import sys

from . import open_store

SERVICE_FIELDS = ("display", "website", "public")

# THE api_key hash: the CLI writes records the server verifies, so both
# sides must share one implementation — any drift (digest size, salt,
# encoding) would lock every service out with "Invalid credentials".
from ..utils import hash_key as hash_api_key  # noqa: E402


async def add(store, args) -> int:
    user = args.user or input("Username: ")
    if await store.hget(f"service:{user}", "api_key"):
        print(f"service {user!r} already exists (use update)", file=sys.stderr)
        return 1
    api_key = args.api_key or secrets.token_urlsafe(32)
    record = {
        "api_key": hash_api_key(api_key),
        "display": args.display or user,
        "website": args.website or "",
        "public": "Y" if args.public else "N",
        "precache": "0",
        "ondemand": "0",
    }
    await store.hset(f"service:{user}", record)
    await store.sadd("services", user)
    print(f"added service {user!r}")
    if not args.api_key:
        print(f"generated api_key (store it now, only the hash is kept): {api_key}")
    return 0


async def update(store, args) -> int:
    user = args.user or input("Username: ")
    if not await store.hgetall(f"service:{user}"):
        print(f"no such service {user!r}", file=sys.stderr)
        return 1
    changes = {}
    if args.api_key:
        changes["api_key"] = hash_api_key(args.api_key)
    if args.display:
        changes["display"] = args.display
    if args.website:
        changes["website"] = args.website
    if args.public is not None:
        changes["public"] = "Y" if args.public else "N"
    if not changes:
        print("nothing to update (pass --api_key/--display/--website/--public/--private)")
        return 1
    await store.hset(f"service:{user}", changes)
    print(f"updated service {user!r}: {sorted(changes)}")
    return 0


async def delete(store, args) -> int:
    user = args.user or input("Username: ")
    removed = await store.delete(f"service:{user}")
    await store.srem("services", user)
    print(f"deleted service {user!r}" if removed else f"no such service {user!r}")
    return 0 if removed else 1


async def check(store, args) -> int:
    user = args.user or input("Username: ")
    record = await store.hgetall(f"service:{user}")
    if not record:
        print(f"no such service {user!r}", file=sys.stderr)
        return 1
    record = {k: ("<hashed>" if k == "api_key" else v) for k, v in record.items()}
    print(json.dumps({user: record}, indent=2))
    return 0


async def list_services(store, args) -> int:
    for user in sorted(await store.smembers("services")):
        record = await store.hgetall(f"service:{user}")
        print(
            f"{user:24} public={record.get('public', '?')} "
            f"precache={record.get('precache', 0):>8} "
            f"ondemand={record.get('ondemand', 0):>8}  {record.get('website', '')}"
        )
    return 0


async def stats(store, args) -> int:
    out = {
        "work": {
            "precache": int(await store.get("stats:precache") or 0),
            "ondemand": int(await store.get("stats:ondemand") or 0),
        },
        "services": {},
    }
    for user in sorted(await store.smembers("services")):
        record = await store.hgetall(f"service:{user}")
        out["services"][user] = {
            "precache": int(record.get("precache", 0)),
            "ondemand": int(record.get("ondemand", 0)),
            "public": record.get("public") == "Y",
        }
    print(json.dumps(out, indent=2))
    return 0


ACTIONS = {
    "add": add,
    "update": update,
    "delete": delete,
    "check": check,
    "list": list_services,
    "stats": stats,
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("action", choices=sorted(ACTIONS))
    p.add_argument("--store", default="redis://localhost", help="redis:// URI or checkpoint path")
    p.add_argument("--user")
    p.add_argument("--api_key")
    p.add_argument("--display")
    p.add_argument("--website")
    p.add_argument("--public", dest="public", action="store_true", default=None)
    p.add_argument("--private", dest="public", action="store_false")
    return p


async def amain(argv=None) -> int:
    args = build_parser().parse_args(argv)
    async with open_store(args.store) as store:
        return await ACTIONS[args.action](store, args)


def main(argv=None) -> int:
    return asyncio.run(amain(argv))


if __name__ == "__main__":
    sys.exit(main())
