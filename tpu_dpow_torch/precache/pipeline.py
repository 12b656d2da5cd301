"""PrecachePipeline: confirmation in, ranked / fenced / shaped dispatch out.

Replaces the server's flat ``block_arrival → should_precache → dispatch``
path (the reference precaches every known account's every confirmation,
dpow_server.py:170-206). One call per confirmed block; the verdict ladder,
cheapest test first:

  shed            the autoscaler's shed_precache lever is on — precache is
                  the top of the shed order, so the confirmation is counted
                  and dropped before any store I/O
  duplicate       re-announced frontier (or a concurrent replica won the
                  frontier swap for the same hash)
  unknown_account neither a tracked frontier nor a precached ``previous`` —
                  the reference's "known account" test, unchanged
  score_floor /   the bounded cache (cache.py) refused admission: the
  below_cached    account is not hot enough to spend speculative budget on
  window_full     the admission window's precache share is exhausted
                  (sched/admission.py sheds — never queues — precache)
  dispatch        admitted, fenced, published

Frontier fence: the account-frontier advance rides ``Store.getset`` — the
seed's ``get`` then ``set`` across awaits is a cross-replica lost-update
window (two replicas confirm blocks of one account; the second plain set
reverts the first's frontier and strands its dispatch). Whichever caller's
atomic swap RETURNS a given old frontier is the exactly-one owner of
retiring it; a swap that returns our own hash means we lost a same-hash
race and we unwind the ticket and cache entry we took.

Rate shaping is split across two mechanisms: the admission window's
``precache_window_fraction`` bounds how much of the window speculative
work may hold at any instant (admission.py, so the shed is visible in
``dpow_sched_shed_total``), and ``batch_interval > 0`` fuses publishes
into one batched flush per tick so a confirmation storm becomes a few
transport bursts instead of a per-block publish stream. The run loop also
reaps cache entries whose admission lease lapsed (dispatch died without a
result) so the speculative budget cannot be squatted by the dead.
"""

from __future__ import annotations

import asyncio
from typing import Callable, Dict, List, Optional, Tuple

from .. import obs
from ..models import WorkType
from ..resilience.clock import Clock, SystemClock
from ..utils.logging import get_logger
from . import cache as cache_mod
from .cache import PrecacheCache
from .scorer import AccountScorer

logger = get_logger("tpu_dpow_torch.precache")

#: block:{hash} value meaning "dispatched, no proof yet" (server/app.py
#: defines the same sentinel; duplicated here so precache does not import
#: the server package — the server imports us).
WORK_PENDING = "0"

#: decision verdicts (dpow_precache_decisions_total); the server counts
#: ``not_owner`` via note_verdict for confirmations the ring routed away
VERDICT_DISPATCH = "dispatch"
VERDICT_SHED = "shed"
VERDICT_DUPLICATE = "duplicate"
VERDICT_UNKNOWN = "unknown_account"
VERDICT_WINDOW_FULL = "window_full"
VERDICT_NOT_OWNER = "not_owner"


class PrecachePipeline:
    def __init__(
        self,
        store,
        admission,
        fleet,
        tracer,
        scorer: AccountScorer,
        cache: PrecacheCache,
        *,
        base_difficulty: int,
        debug: bool = False,
        account_expiry: Optional[float] = None,
        block_expiry: Optional[float] = None,
        batch_interval: float = 0.0,
        batch_size: int = 16,
        poll_interval: float = 0.5,
        clock: Optional[Clock] = None,
        retire_cb: Optional[Callable[[str], None]] = None,
    ):
        self.store = store
        self.admission = admission
        self.fleet = fleet
        self.tracer = tracer
        self.scorer = scorer
        self.cache = cache
        self.base_difficulty = base_difficulty
        self.debug = debug
        self.account_expiry = account_expiry
        self.block_expiry = block_expiry
        self.batch_interval = batch_interval
        self.batch_size = max(int(batch_size), 1)
        self.poll_interval = poll_interval
        self.clock = clock or SystemClock()
        #: server hook fired when a dispatch is retired (evict/supersede/
        #: shed unwind): a coalesced on-demand waiter must be failed over,
        #: not left to burn its whole timeout on work that will never land
        self.retire_cb = retire_cb
        #: (block_hash, trace_id) publishes awaiting a batch flush
        self._pending_publish: List[Tuple[str, Optional[str]]] = []
        self._counts: Dict[str, int] = {}
        reg = obs.get_registry()
        self._m_decisions = reg.counter(
            "dpow_precache_decisions_total",
            "Confirmation verdicts from the precache pipeline",
            ("verdict",))
        # Same family app.py registered since the seed (get-or-create):
        # the headline "precache publishes" counter keeps its name across
        # the refactor so dashboards and BENCH baselines stay comparable.
        self._m_dispatch = reg.counter(
            "dpow_server_precache_dispatch_total",
            "Precache work publishes triggered by block arrivals")

    # -- verdict accounting ---------------------------------------------

    def note_verdict(self, verdict: str) -> str:
        self._counts[verdict] = self._counts.get(verdict, 0) + 1
        self._m_decisions.inc(1, verdict)
        return verdict

    def count(self, verdict: str) -> int:
        return self._counts.get(verdict, 0)

    # -- the decision path ----------------------------------------------

    async def on_confirmation(
        self, block_hash: str, account: str, previous: Optional[str]
    ) -> str:
        """Decide and (maybe) dispatch one confirmed block. Returns the
        verdict string (see module docstring for the ladder)."""
        # Score every confirmation, even ones about to be shed or refused:
        # activity tracking is what lets the cache prefer the hot head the
        # moment pressure lifts.
        score = await self.scorer.observe(account)

        if self.admission.shed_precache:
            # Top of the shed order. Route through the admission
            # controller so the shed is counted in dpow_sched_shed_total
            # alongside window sheds — the autoscaler watches one metric.
            self.admission.try_acquire_precache(
                block_hash, difficulty=self.base_difficulty
            )
            return self.note_verdict(VERDICT_SHED)

        old_frontier = await self.store.get(f"account:{account}")
        if old_frontier == block_hash:
            return self.note_verdict(VERDICT_DUPLICATE)
        previous_exists = False
        if not old_frontier and previous is not None:
            previous_exists = await self.store.exists(f"block:{previous}")
        if not (self.debug or old_frontier or previous_exists):
            return self.note_verdict(VERDICT_UNKNOWN)

        refusal = self.cache.precheck(block_hash, score, force=self.debug)
        if refusal is not None:
            return self.note_verdict(refusal)

        # Admission gate (sched/): precache is speculative — a full window
        # (or an exhausted precache fraction) sheds it here, never queues
        # it ahead of waiting on-demand work. The account's next
        # confirmation simply retries.
        ticket = self.admission.try_acquire_precache(
            block_hash, difficulty=self.base_difficulty
        )
        if ticket is None:
            logger.debug("precache for %s shed: dispatch window full", block_hash)
            return self.note_verdict(VERDICT_WINDOW_FULL)

        # No awaits between precheck and insert: the verdict cannot be
        # invalidated by an interleaved confirmation. At the hard bound
        # the lowest-scored resident is evicted; retire its dispatch so
        # the budget bound is also a dispatch bound.
        _, evicted = self.cache.insert(block_hash, account, score)
        if evicted is not None:
            await self._retire(evicted.block_hash)

        # Frontier fence: atomic swap. The RETURN value — not the read at
        # the top of this function, which is stale by however many awaits
        # ran since — names the one frontier this caller owns retiring.
        old = await self.store.getset(
            f"account:{account}", block_hash, expire=self.account_expiry
        )
        if old == block_hash:
            # Lost a same-hash race (another replica, or a re-announce
            # interleaved with our own awaits): the winner's dispatch is
            # already in flight, unwind ours.
            self.cache.remove(block_hash, cache_mod.EVICT_DUPLICATE)
            self.admission.release_key(block_hash)
            return self.note_verdict(VERDICT_DUPLICATE)
        retired = old or (previous if previous_exists else None)

        trace_id = self.tracer.begin(block_hash, stage="queue")
        self._m_dispatch.inc()
        aws = [
            self.store.set(
                f"block:{block_hash}", WORK_PENDING, expire=self.block_expiry
            ),
            self.store.set(
                f"work-type:{block_hash}", WorkType.PRECACHE.value,
                expire=self.block_expiry,
            ),
        ]
        if retired:
            # Retire the superseded frontier completely: winner lock and
            # work-type go with the work, or a later on-demand dispatch
            # for that hash has every result discarded at the still-held
            # setnx lock until its TTL. A retired hash never sees its
            # result: its precache lease and cache entry go with it.
            self.cache.remove(retired, cache_mod.EVICT_SUPERSEDED)
            await self._retire(retired, gather_into=aws)
        await asyncio.gather(*aws)
        await self._publish(block_hash, trace_id)
        return self.note_verdict(VERDICT_DISPATCH)

    async def _retire(self, block_hash: str, gather_into=None) -> None:
        """Tear down a dispatch that will never see its result."""
        self.admission.release_key(block_hash)
        self.fleet.forget(block_hash)
        if self.retire_cb is not None:
            self.retire_cb(block_hash)
        deletion = self.store.delete(
            f"block:{block_hash}",
            f"block-lock:{block_hash}",
            f"work-type:{block_hash}",
        )
        if gather_into is not None:
            gather_into.append(deletion)
        else:
            await deletion

    async def _publish(self, block_hash: str, trace_id: Optional[str]) -> None:
        if self.batch_interval > 0:
            self._pending_publish.append((block_hash, trace_id))
            if len(self._pending_publish) >= self.batch_size:
                await self.flush()
            return
        await self.fleet.publish_work(
            block_hash, self.base_difficulty,
            WorkType.PRECACHE.value, trace_id,
        )
        self.tracer.mark(trace_id, "publish")

    # -- result / request hooks (server integration) ---------------------

    def on_result(self, block_hash: str, work_type: str) -> None:
        """Winner-path hook: a precached solve completed."""
        if work_type == WorkType.PRECACHE.value:
            self.cache.mark_ready(block_hash)

    def on_stale(self, block_hash: str) -> None:
        """Service-path hook: precached work exists but is unusable at the
        requested difficulty — the server forces an on-demand solve."""
        self.cache.remove(block_hash, cache_mod.EVICT_STALE)

    def note_request(self, work_type: str) -> None:
        """Service-path hook: classify a served request as a precache hit
        (served from speculative work) or miss (paid an on-demand solve)."""
        if work_type == WorkType.PRECACHE.value:
            self.cache.note_request(True)
        elif work_type == WorkType.ONDEMAND.value:
            self.cache.note_request(False)
        # "unresolved" (errored before a work type existed) is neither

    # -- the run loop ----------------------------------------------------

    async def flush(self) -> int:
        """Publish the fused batch. Under shed_precache the queue is
        dropped instead — entries unwound, budget and window freed — so a
        flip of the shed lever takes effect within one tick even for work
        already admitted."""
        batch, self._pending_publish = self._pending_publish, []
        if not batch:
            return 0
        if self.admission.shed_precache:
            for block_hash, _ in batch:
                entry = self.cache.remove(block_hash, cache_mod.EVICT_SHED)
                if entry is not None:
                    await self._retire(block_hash)
            self.note_verdict(VERDICT_SHED)
            return 0
        await asyncio.gather(*(
            self.fleet.publish_work(
                block_hash, self.base_difficulty,
                WorkType.PRECACHE.value, trace_id,
            )
            for block_hash, trace_id in batch
        ))
        for _, trace_id in batch:
            self.tracer.mark(trace_id, "publish")
        return len(batch)

    def reap_lapsed(self) -> int:
        """Drop pending entries whose admission lease lapsed: the dispatch
        died (worker loss, lost publish past the supervisor's patience)
        and the window already reclaimed the slot — the budget must follow.
        Store keys are left to their TTLs, as the seed leaves any
        never-resolved dispatch."""
        queued = {h for h, _ in self._pending_publish}
        reaped = 0
        for entry in self.cache.entries():
            if entry.state != cache_mod.PENDING:
                continue
            if entry.block_hash in queued:
                continue  # not yet published; its lease is still live
            if self.admission.has_lease(entry.block_hash):
                continue
            self.cache.remove(entry.block_hash, cache_mod.EVICT_LEASE_LAPSE)
            reaped += 1
        if reaped:
            logger.info("reaped %d lease-lapsed precache entries", reaped)
        return reaped

    async def run(self) -> None:
        """Batch flusher + lease reaper. Cancelled at server close."""
        tick = self.batch_interval if self.batch_interval > 0 else self.poll_interval
        while True:
            await self.clock.sleep(tick)
            try:
                await self.flush()
                self.reap_lapsed()
                self.cache.hit_ratio()  # refresh the windowed gauge
            except asyncio.CancelledError:
                raise
            except Exception:
                logger.exception("precache maintenance tick failed")
