"""Epoch-fenced Store writes: the one place ``replica:*`` keys are written.

Replication's correctness rests on a single rule: a replica may only write
its slice of the shared replica state while its membership EPOCH is still
current. A replica that was declared dead and adopted (takeover.py) has its
fence raised past its epoch; if that replica was not actually dead — a GC
pause, a network partition, a wedged event loop — it wakes up as a ZOMBIE
and its writes (heartbeats, dispatch-journal records) must bounce off the
fence instead of resurrecting state its adopter already owns. This is the
same fencing-token idiom Redlock-style leases use, built on nothing but the
Store protocol's atomic ``setnx``/``incrby``.

This module is the ONLY place in the package allowed to call a Store write
method with a ``replica:*`` key — dpowlint DPOW901 (analysis/replica_keys.py)
enforces that mechanically, because a single unfenced write anywhere else
would silently void the zombie guarantee the takeover protocol rests on.

Key schema (all epoch-fenced unless noted):
  replica:epoch                  → global epoch counter (atomic incrby; the
                                   source of every member's epoch — unfenced
                                   by nature, allocation is the fence's input)
  replica:member:{id}            → hash {epoch, hb, wall} (registration +
                                   heartbeat seq)
  replica:fence:{id}             → minimum epoch still allowed to write as
                                   {id}; raised by an adopter to dead_epoch+1
  replica:dispatch:{id}:{hash}   → JSON dispatch record (the takeover journal)
  replica:adopt:{id}:{epoch}     → adoption election lock (setnx, one adopter
                                   per death event — the winner-lock idiom)
"""

from __future__ import annotations

import json
from typing import Dict, List, Tuple

from .. import obs

EPOCH_KEY = "replica:epoch"
MEMBER_PREFIX = "replica:member:"
FENCE_PREFIX = "replica:fence:"
DISPATCH_PREFIX = "replica:dispatch:"
ADOPT_PREFIX = "replica:adopt:"


def member_key(replica_id: str) -> str:
    return f"{MEMBER_PREFIX}{replica_id}"


def fence_key(replica_id: str) -> str:
    return f"{FENCE_PREFIX}{replica_id}"


def dispatch_key(replica_id: str, block_hash: str) -> str:
    return f"{DISPATCH_PREFIX}{replica_id}:{block_hash}"


def adopt_key(replica_id: str, epoch: int) -> str:
    return f"{ADOPT_PREFIX}{replica_id}:{epoch}"


class StaleEpoch(Exception):
    """This replica's epoch is behind its fence: it was declared dead and
    adopted. Everything it still believes it owns belongs to the adopter."""

    def __init__(self, replica_id: str, epoch: int, fence: int):
        super().__init__(
            f"replica {replica_id!r} epoch {epoch} is fenced (fence={fence}): "
            "a peer declared it dead and adopted its dispatches — rejoin with "
            "a fresh epoch instead of writing stale state"
        )
        self.replica_id = replica_id
        self.epoch = epoch
        self.fence = fence


def _m_fenced():
    return obs.get_registry().counter(
        "dpow_replica_fenced_total",
        "Store writes refused because the writer's epoch is behind its "
        "fence (zombie replica detected)", ("op",))


async def allocate_epoch(store) -> int:
    """A fresh, globally unique, monotonically increasing epoch (join)."""
    return int(await store.incrby(EPOCH_KEY))


async def read_fence(store, replica_id: str) -> int:
    raw = await store.get(fence_key(replica_id))
    try:
        return int(raw) if raw is not None else 0
    except (TypeError, ValueError):
        return 0


async def raise_fence(store, replica_id: str, to_epoch: int) -> int:
    """Fence ``replica_id`` so epochs below ``to_epoch`` can no longer
    write (adopter-side; monotonic — a lower raise never un-fences)."""
    current = await read_fence(store, replica_id)
    target = max(current, int(to_epoch))
    if target != current:
        await store.set(fence_key(replica_id), str(target))
    return target


class FencedWriter:
    """One replica's write authority over its own ``replica:*`` slice.

    Every mutation checks ``replica:fence:{id}`` first; a fence at or above
    our epoch means a peer adopted us — the write raises
    :class:`StaleEpoch` (and counts ``dpow_replica_fenced_total``) instead
    of landing. The check-then-write is not atomic, but it does not need to
    be: the fence only ever RISES, so the race window admits at most writes
    that were legal when checked — and the adopter re-reads the journal
    AFTER raising the fence, so a record that slips in is still adopted,
    not lost (takeover.py orders it that way on purpose).
    """

    def __init__(self, store, replica_id: str, epoch: int):
        self.store = store
        self.replica_id = replica_id
        self.epoch = int(epoch)
        self._m = _m_fenced()

    async def _guard(self, op: str) -> None:
        fence = await read_fence(self.store, self.replica_id)
        if fence > self.epoch:
            self._m.inc(1, op)
            raise StaleEpoch(self.replica_id, self.epoch, fence)

    # -- member record / heartbeat ------------------------------------

    async def write_member(self, hb: int, wall: float) -> None:
        await self._guard("member")
        await self.store.hset(
            member_key(self.replica_id),
            {"epoch": str(self.epoch), "hb": str(int(hb)), "wall": repr(wall)},
        )

    async def delete_member(self) -> None:
        """Clean leave (bye). Fence-checked: a zombie's leave must not
        erase the record its ADOPTER may have just re-registered."""
        await self._guard("member")
        await self.store.delete(member_key(self.replica_id))

    # -- dispatch journal ---------------------------------------------

    async def journal_dispatch(self, block_hash: str, record: Dict) -> None:
        await self._guard("journal")
        record = dict(record)
        record["epoch"] = self.epoch
        await self.store.set(
            dispatch_key(self.replica_id, block_hash), json.dumps(record)
        )

    async def forget_dispatch(self, block_hash: str) -> None:
        await self._guard("journal")
        await self.store.delete(dispatch_key(self.replica_id, block_hash))


# -- read side (no fencing needed: reads cannot resurrect state) --------


async def read_members(store) -> Dict[str, Dict[str, str]]:
    """Every registered member record, id → raw hash."""
    out: Dict[str, Dict[str, str]] = {}
    for key in await store.keys(f"{MEMBER_PREFIX}*"):
        rid = key[len(MEMBER_PREFIX):]
        if not rid:
            continue
        record = await store.hgetall(key)
        if record:
            out[rid] = record
    return out


async def read_dispatches(store, replica_id: str) -> List[Tuple[str, Dict]]:
    """The takeover journal of one replica: [(block_hash, record)]."""
    prefix = f"{DISPATCH_PREFIX}{replica_id}:"
    out: List[Tuple[str, Dict]] = []
    for key in await store.keys(f"{prefix}*"):
        block_hash = key[len(prefix):]
        raw = await store.get(key)
        if not block_hash or raw is None:
            continue
        try:
            record = json.loads(raw)
        except ValueError:
            continue
        if isinstance(record, dict):
            out.append((block_hash, record))
    return out


async def claim_adoption(store, dead_id: str, dead_epoch: int, expire: float) -> bool:
    """Leaderless single-adopter election for one death event: the setnx
    winner adopts, everyone else stands down (the winner-lock idiom). The
    TTL re-opens the claim if the adopter itself dies mid-takeover. The
    winner's claim registers in the LeakLedger; release_adoption and
    drop_member_record are its discharge points (obs/ledger.py)."""
    won = await store.setnx(adopt_key(dead_id, dead_epoch), "1", expire=expire)
    if won:
        obs.LEDGER.acquire("claim", (dead_id, int(dead_epoch)))
    return won


async def release_adoption(store, dead_id: str, dead_epoch: int) -> None:
    """Re-open the adoption election NOW instead of waiting out the claim
    TTL (adopter-side, after a pass that left journal leftovers behind):
    the records already adopted are out of the journal, so the next
    claimant — the same replica on its next poll, or any peer — re-adopts
    only what remains. Without this, a failed adoption pass in a
    two-replica ring stranded the leftovers until the TTL expired, and
    the adopter itself never retried at all. Ledger discharge comes FIRST:
    ownership ends the moment the adopter abandons the pass — if the
    store delete itself fails (or a cancellation lands on it), the claim
    key falls back to its TTL, which is the designed recovery, and the
    ledger must not read that as a leak."""
    obs.LEDGER.discharge("claim", (dead_id, int(dead_epoch)))
    await store.delete(adopt_key(dead_id, dead_epoch))


async def retire_member(store, dead_id: str, dead_epoch: int) -> None:
    """Adopter-side teardown of a dead member's slice: fence first (so the
    zombie is locked out BEFORE its state moves), then drop the record.
    NOTE (takeover liveness): the coordinator deletes the member record
    only AFTER the journal drains (drop_member_record) — deleting it up
    front made peers drop the dead id from their views immediately, so an
    adopter crash mid-takeover orphaned the remaining journal records
    forever (no peer would ever re-detect the death; the adoption claim's
    TTL re-open was dead code). This combined helper remains for
    tests/simple callers where the slice is known empty."""
    await raise_fence(store, dead_id, dead_epoch + 1)
    await store.delete(member_key(dead_id))


async def drop_member_record(store, dead_id: str, dead_epoch: int) -> None:
    """Delete a retired member's record, but only while it still belongs
    to the dead incarnation: a zombie that rejoined at a fresh epoch
    during the adoption loop owns the key again, and deleting it would
    blip a LIVE member out of every peer's view."""
    # The adoption pass that called us is COMPLETE: the claim key itself
    # is left to its TTL on purpose (re-claiming a fully drained slice is
    # harmless), but its ownership ends here — discharge the ledger with
    # op="lapse" so a finished takeover reads as zero outstanding
    # (count-neutral for callers that never held the claim).
    obs.LEDGER.discharge("claim", (dead_id, int(dead_epoch)), op="lapse")
    record = await store.hgetall(member_key(dead_id))
    if not record:
        return
    try:
        epoch = int(record.get("epoch", 0) or 0)
    except (TypeError, ValueError):
        epoch = 0
    if epoch <= dead_epoch:
        await store.delete(member_key(dead_id))


async def drop_adopted_dispatch(store, dead_id: str, block_hash: str) -> None:
    """Remove one adopted journal record from the dead replica's slice
    (adopter authority — the fence already locks the zombie out)."""
    await store.delete(dispatch_key(dead_id, block_hash))
