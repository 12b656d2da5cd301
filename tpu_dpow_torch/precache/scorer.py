"""AccountScorer: who is hot enough to be worth a speculative solve.

One decayed-activity score per observed account — every block confirmation
folds +1 into an exponentially-decaying accumulator (half-life
``half_life`` seconds on the injectable resilience Clock), so the score IS
the account's recent confirmation rate in half-life units: a wallet
confirming every few minutes scores high and stays there, the Zipf tail
decays to ~0 between its own confirmations. Same shape as the fleet
registry's hashrate EMA (fleet/registry.py): memory-first on the hot path,
bounded cardinality, store persistence for warm restarts.

Population-scale discipline:

  * the in-memory table is bounded (``max_accounts``) with watermark
    pruning — at capacity the bottom of the score order is dropped in one
    amortized O(n log n) pass down to 90%, so a million-account feed costs
    a fixed table, not a per-confirmation eviction scan;
  * ONLY the hot head persists: a store write per tail confirmation would
    make the tail exactly as expensive as the head, which is the failure
    this subsystem exists to avoid. An account's record is written under
    ``precache:score:{account}`` when its score is at or above
    ``persist_floor``, throttled to once per ``persist_interval``;
  * persisted records carry a coarse wall-clock stamp (monotonic clocks
    die with the process): load() decays each score by the wall time the
    process was down and deletes records idle past 10 half-lives — the
    fleet registry's cross-restart hygiene, applied to accounts.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional

from .. import obs
from ..resilience.clock import Clock, SystemClock
from ..utils.logging import get_logger

logger = get_logger("tpu_dpow_torch.precache")

STORE_PREFIX = "precache:score:"

#: Score histogram tiers: 2x ladder from "seen once lately" to "confirms
#: many times per half-life". docs/precache.md names the tiers.
SCORE_BUCKETS = (0.5, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0)

#: Watermark pruning keeps this fraction of max_accounts after a prune
#: pass (amortizes the O(n log n) sort across ~10% of max_accounts
#: observations of fresh accounts).
PRUNE_KEEP = 0.9


@dataclass
class _AccountScore:
    score: float = 0.0
    stamp: float = 0.0  # scorer clock time of the last fold
    persisted: bool = False
    persist_stamp: float = float("-inf")


class AccountScorer:
    def __init__(
        self,
        store,
        *,
        clock: Optional[Clock] = None,
        half_life: float = 900.0,
        max_accounts: int = 65536,
        persist_floor: float = 1.0,
        persist_interval: float = 30.0,
    ):
        self.store = store
        self.clock = clock or SystemClock()
        self.half_life = max(half_life, 1e-3)
        self.max_accounts = max(int(max_accounts), 1)
        self.persist_floor = persist_floor
        self.persist_interval = persist_interval
        self._scores: Dict[str, _AccountScore] = {}
        reg = obs.get_registry()
        self._m_tracked = reg.gauge(
            "dpow_precache_accounts_tracked",
            "Accounts with a live activity score in memory")
        self._m_pruned = reg.counter(
            "dpow_precache_accounts_pruned_total",
            "Accounts dropped by the scorer's cardinality watermark")
        self._m_score = reg.histogram(
            "dpow_precache_score",
            "Per-confirmation account activity score, by tier "
            "(post-fold; the population's observed score distribution)",
            buckets=SCORE_BUCKETS)

    def __len__(self) -> int:
        return len(self._scores)

    # -- scoring -------------------------------------------------------

    def _decayed(self, entry: _AccountScore, now: float) -> float:
        dt = max(now - entry.stamp, 0.0)
        return entry.score * 0.5 ** (dt / self.half_life)

    def score(self, account: str) -> float:
        """Current decayed score; 0.0 for an unknown account."""
        entry = self._scores.get(account)
        if entry is None:
            return 0.0
        return self._decayed(entry, self.clock.time())

    async def observe(self, account: str) -> float:
        """Fold one block confirmation into the account's score and return
        the post-fold value. Persists hot-head records (score >= floor,
        throttled); evicted-by-watermark accounts lose their store record
        too, so the persisted set stays as bounded as the table."""
        now = self.clock.time()
        entry = self._scores.get(account)
        if entry is None:
            entry = self._scores[account] = _AccountScore()
            entry.stamp = now
        entry.score = self._decayed(entry, now) + 1.0
        entry.stamp = now
        self._m_score.observe(entry.score)
        evicted = self._prune(now)
        if (
            entry.score >= self.persist_floor
            and now - entry.persist_stamp >= self.persist_interval
        ):
            entry.persist_stamp = now
            entry.persisted = True
            await self.store.hset(
                f"{STORE_PREFIX}{account}",
                {
                    "score": repr(entry.score),
                    # Coarse wall stamp for cross-restart decay/hygiene only
                    # (fleet-registry idiom: monotonic stamps die with the
                    # process).
                    # dpowlint: disable=DPOW101 — deliberate wall clock, see above
                    "seen_wall": repr(time.time()),
                },
            )
        if evicted:
            await self.store.delete(
                *(f"{STORE_PREFIX}{a}" for a in evicted)
            )
        self._m_tracked.set(float(len(self._scores)))
        return entry.score

    def _prune(self, now: float) -> List[str]:
        """Watermark pass: over max_accounts ⇒ keep the top PRUNE_KEEP
        fraction by decayed score. Returns evicted accounts that have a
        store record to delete."""
        if len(self._scores) <= self.max_accounts:
            return []
        ranked = sorted(
            self._scores.items(),
            key=lambda kv: self._decayed(kv[1], now),
        )
        drop = len(self._scores) - int(self.max_accounts * PRUNE_KEEP)
        evicted_store = []
        for account, entry in ranked[:drop]:
            del self._scores[account]
            if entry.persisted:
                evicted_store.append(account)
        self._m_pruned.inc(drop)
        logger.info(
            "scorer pruned %d cold accounts (bound %d)", drop, self.max_accounts
        )
        return evicted_store

    # -- persistence ---------------------------------------------------

    async def load(self) -> int:
        """Rehydrate the hot head after a restart. Each score is decayed
        by the WALL time since it was written (the only clock that spans
        processes); records idle past 10 half-lives — or decayed to dust —
        are deleted instead of loaded, so account churn cannot accumulate
        corpses in the store."""
        now = self.clock.time()
        # dpowlint: disable=DPOW101 — cross-restart decay needs wall clock; monotonic stamps die with the process
        wall = time.time()
        count = 0
        for key in await self.store.keys(f"{STORE_PREFIX}*"):
            record = await self.store.hgetall(key)
            account = key[len(STORE_PREFIX):]
            if not account or not record:
                continue
            try:
                score = float(record.get("score", 0) or 0)
                seen_wall = float(record.get("seen_wall", 0) or 0)
            except (TypeError, ValueError):
                logger.warning("dropping corrupt precache score record %s", key)
                await self.store.delete(key)
                continue
            idle = max(wall - seen_wall, 0.0) if seen_wall else 0.0
            if seen_wall and idle > 10 * self.half_life:
                await self.store.delete(key)
                continue
            score *= 0.5 ** (idle / self.half_life)
            if score <= 0.01:
                await self.store.delete(key)
                continue
            self._scores[account] = _AccountScore(
                score=score, stamp=now, persisted=True
            )
            count += 1
        self._prune(now)
        self._m_tracked.set(float(len(self._scores)))
        if count:
            logger.info("rehydrated %d account scores", count)
        return count
