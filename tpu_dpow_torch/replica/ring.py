"""Deterministic hash→owner ring: "whose request is this" without consensus.

Rendezvous (highest-random-weight) hashing over the live member set: every
replica computes ``blake2b(member_id || block_hash)`` for each live member
and the highest score owns the hash. Properties the takeover protocol
leans on:

  * DETERMINISTIC — any replica (or an operator's script) answers ownership
    from the member list alone; no coordinator, no agreement round;
  * MINIMAL MOVEMENT — when a member joins or dies, only the hashes whose
    argmax was (or becomes) that member change owner; everyone else's slice
    is untouched, so a rebalance never stampedes the fleet;
  * EPOCH-FENCED — a table is stamped with the membership epoch it was
    built from (the max member epoch); two replicas comparing tables can
    tell stale from fresh without comparing member lists.

Transient membership disagreement between replicas is harmless by
construction: a replica that believes it owns a hash serves it correctly
(the shared store's winner lock keeps results exactly-once), so the worst
case of a split view is one request served unpartitioned, never one
served twice or zero times.
"""

from __future__ import annotations

import hashlib
from typing import Dict, Iterable, List, Optional, Tuple


def _score(member_id: str, block_hash: str) -> int:
    return int.from_bytes(
        hashlib.blake2b(
            member_id.encode() + b"|" + block_hash.encode(), digest_size=8
        ).digest(),
        "big",
    )


def owner_of(block_hash: str, members: Iterable[str]) -> Optional[str]:
    """The rendezvous owner of ``block_hash`` among ``members`` (None for
    an empty set). Ties break on the id itself, so the answer is total."""
    best: Optional[Tuple[int, str]] = None
    for rid in members:
        key = (_score(rid, block_hash), rid)
        if best is None or key > best:
            best = key
    return None if best is None else best[1]


class HashRing:
    """An immutable ownership table: live member ids + the membership epoch
    it was built from. Rebuilt (never mutated) on membership change, so a
    reference handed to a dispatch keeps answering consistently even while
    the registry observes churn."""

    def __init__(self, members: Iterable[str], epoch: int = 0):
        self.members: Tuple[str, ...] = tuple(sorted(set(members)))
        self.epoch = int(epoch)

    def owner_of(self, block_hash: str) -> Optional[str]:
        return owner_of(block_hash, self.members)

    def owns(self, replica_id: str, block_hash: str) -> bool:
        return self.owner_of(block_hash) == replica_id

    def __len__(self) -> int:
        return len(self.members)

    def __contains__(self, replica_id: str) -> bool:
        return replica_id in self.members

    def __repr__(self) -> str:
        return f"HashRing(members={self.members!r}, epoch={self.epoch})"

    def slice_counts(self, hashes: Iterable[str]) -> Dict[str, int]:
        """Owner histogram over a sample of hashes (balance diagnostics)."""
        out: Dict[str, int] = {rid: 0 for rid in self.members}
        for h in hashes:
            o = self.owner_of(h)
            if o is not None:
                out[o] += 1
        return out

    def moved(self, other: "HashRing", hashes: Iterable[str]) -> List[str]:
        """The hashes (of a sample) whose owner differs between two tables
        — the minimal-movement property's measurable form."""
        return [h for h in hashes if self.owner_of(h) != other.owner_of(h)]
