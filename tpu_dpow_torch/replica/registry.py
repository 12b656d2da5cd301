"""ReplicaRegistry: ring membership, heartbeats, and death detection.

Each replica registers itself in the shared Store (``replica:member:{id}``
with the epoch it joined at), then heartbeats by bumping a per-member
SEQUENCE number. Peers never compare clocks — monotonic clocks don't agree
across processes and wall clocks drift — they watch the sequence: a peer
whose heartbeat seq has not MOVED for ``ttl`` seconds of the observer's own
clock is stale. That makes death detection skew-free and fully leaderless:
every replica reaches the same verdict from the same store reads, just
possibly a poll apart.

All writes ride :mod:`tpu_dpow_torch.replica.fence` (DPOW901): a zombie replica —
fenced by the peer that adopted it — has its heartbeats refused at the
store, so it can never flap back to "live" in anyone's view under its old
epoch.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional

from .. import obs
from ..resilience.clock import Clock, SystemClock
from ..utils.logging import get_logger
from . import fence
from .ring import HashRing

logger = get_logger("tpu_dpow_torch.replica")


@dataclass
class PeerView:
    """One observer's evidence about one peer."""

    replica_id: str
    epoch: int = 0
    hb: int = -1  # last heartbeat seq read from the store
    observed: float = 0.0  # observer-clock time the seq last MOVED
    joined_wall: float = 0.0  # coarse wall stamp from the member record


class ReplicaRegistry:
    def __init__(
        self,
        store,
        replica_id: str,
        *,
        clock: Optional[Clock] = None,
        ttl: float = 10.0,
    ):
        self.store = store
        self.replica_id = replica_id
        self.clock = clock or SystemClock()
        self.ttl = ttl
        self.epoch = 0  # assigned at join()
        self.writer: Optional[fence.FencedWriter] = None
        self.fenced = False  # we observed our own fence: we are a zombie
        self._hb = 0
        self._peers: Dict[str, PeerView] = {}
        reg = obs.get_registry()
        self._m_live = reg.gauge(
            "dpow_replica_live",
            "Ring members whose heartbeat moved within the ttl (self "
            "included)")
        self._m_epoch = reg.gauge(
            "dpow_replica_epoch", "This replica's membership epoch")
        self._m_heartbeats = reg.counter(
            "dpow_replica_heartbeats_total",
            "Heartbeat sequence bumps written to the shared store")

    # -- lifecycle -----------------------------------------------------

    async def join(self) -> int:
        """Register this replica: allocate a fresh epoch (atomic counter),
        install the fenced writer, write the member record. Idempotent
        rejoin after a fence: a NEW epoch makes the zombie a member again."""
        self.epoch = await fence.allocate_epoch(self.store)
        self.writer = fence.FencedWriter(self.store, self.replica_id, self.epoch)
        self.fenced = False
        self._hb = 0
        await self.heartbeat()
        self._m_epoch.set(float(self.epoch))
        logger.info(
            "replica %s joined the ring at epoch %d", self.replica_id, self.epoch
        )
        return self.epoch

    async def leave(self) -> None:
        """Clean shutdown: drop the member record so peers rebalance
        immediately instead of waiting out the ttl. Best-effort — a fenced
        (already-adopted) replica has nothing left to remove."""
        if self.writer is None:
            return
        try:
            await self.writer.delete_member()
        except fence.StaleEpoch:
            self.fenced = True

    async def heartbeat(self) -> bool:
        """Bump the heartbeat seq. Returns False — and flags this replica
        as fenced — when the write bounced off a raised fence (we were
        declared dead and adopted while away)."""
        if self.writer is None:
            raise RuntimeError("heartbeat before join()")
        self._hb += 1
        try:
            # Coarse wall stamp for cross-restart store hygiene only (the
            # seq, not the stamp, carries liveness).
            # dpowlint: disable=DPOW101 — wall clock survives the process; monotonic stamps do not
            await self.writer.write_member(self._hb, time.time())
        except fence.StaleEpoch:
            self.fenced = True
            logger.warning(
                "replica %s (epoch %d) is fenced: a peer adopted it; "
                "standing down", self.replica_id, self.epoch,
            )
            return False
        self._m_heartbeats.inc()
        return True

    # -- observation ---------------------------------------------------

    async def observe(self) -> None:
        """One observation pass over the member records: fold heartbeat
        movement into the per-peer views on OUR clock."""
        now = self.clock.time()
        records = await fence.read_members(self.store)
        for rid, record in records.items():
            if rid == self.replica_id:
                continue
            try:
                epoch = int(record.get("epoch", 0) or 0)
                hb = int(record.get("hb", -1) or -1)
                wall = float(record.get("wall", 0) or 0)
            except (TypeError, ValueError):
                continue
            view = self._peers.get(rid)
            if view is None or view.epoch != epoch:
                # Fresh member, or the same id rejoined at a new epoch —
                # either way the staleness timer restarts.
                self._peers[rid] = PeerView(rid, epoch, hb, now, wall)
                continue
            if hb != view.hb:
                view.hb = hb
                view.observed = now
        # A record that vanished (clean leave, or retired by an adopter)
        # drops from the view immediately.
        for rid in list(self._peers):
            if rid not in records:
                del self._peers[rid]
        self._m_live.set(float(len(self.live_members())))

    def live_members(self) -> List[str]:
        """Everyone whose heartbeat moved within the ttl, self included
        (unless fenced — a zombie is not a member of anything)."""
        now = self.clock.time()
        out = [] if self.fenced else [self.replica_id]
        for rid, view in self._peers.items():
            if now - view.observed <= self.ttl:
                out.append(rid)
        return sorted(out)

    def stale_peers(self) -> List[PeerView]:
        """Peers whose heartbeat seq has not moved for a full ttl of our
        clock — takeover candidates."""
        now = self.clock.time()
        return [
            v for v in self._peers.values() if now - v.observed > self.ttl
        ]

    def is_live(self, replica_id: str) -> bool:
        if replica_id == self.replica_id:
            return not self.fenced
        view = self._peers.get(replica_id)
        return (
            view is not None
            and self.clock.time() - view.observed <= self.ttl
        )

    def peer_epoch(self, replica_id: str) -> int:
        view = self._peers.get(replica_id)
        return view.epoch if view is not None else 0

    def ring(self) -> HashRing:
        """The ownership table for the CURRENT live view, stamped with the
        highest member epoch observed (the table's fencing token)."""
        members = self.live_members()
        epoch = self.epoch if not self.fenced else 0
        for rid in members:
            view = self._peers.get(rid)
            if view is not None:
                epoch = max(epoch, view.epoch)
        return HashRing(members, epoch)
