"""A population of simulated services with realistic per-service behavior.

The reference hub serves a handful of registered wallets/exchanges; the
million-user story is thousands of services with a heavy-tailed popularity
curve. Each simulated service gets, at construction (deterministic per
seed):

  * a Zipf popularity weight — a few services carry most of the traffic,
    a long tail trickles;
  * a hash-reuse probability — wallets re-request recent frontiers, which
    downstream becomes a store hit (already solved) or a same-hash
    coalesce (still in flight): the hub's two capacity-relief paths;
  * a cancel rate — the fraction of its requests abandoned client-side
    before completion (user closed the tab);
  * a per-request timeout distribution (log-normal around its own median
    — impatient bots and patient batch services coexist);
  * a quota identity: the service's name and API key are REGISTERED in
    the store (:meth:`ServicePopulation.seed_store`), so the sched layer
    meters every simulated service exactly like a paying customer —
    per-service throttles, token buckets and fair-share shed all see the
    real population, not one "bench" super-user.

A small ``hot_hash`` probability models the flash-crowd correlation that
makes spikes coalescible: during a market move, MANY services re-request
the SAME few frontiers.

The population also synthesizes the OTHER side of the workload: the
node's block-confirmation stream (:meth:`confirm_spec`). Confirmations
draw from a Zipf over ``n_accounts`` accounts with the same exponent as
the service curve — the population-scale shape the precache subsystem
(tpu_dpow_torch/precache/) exists for — and each account's confirmations CHAIN
(every ConfirmSpec's ``previous`` is that account's last confirmed hash,
exactly like a real Nano frontier). The two streams are coupled the way
reality couples them: a confirmed frontier is pushed into the owning
service's reuse pool and the hot set, so the request stream starts
asking for exactly the hashes a good precacher would have pre-solved —
which is what makes a measured hit ratio meaningful.
"""

from __future__ import annotations

import math
import random
from bisect import bisect_right
from collections import deque
from dataclasses import dataclass
from typing import Deque, List, Optional, Tuple

from .arrival import Arrival


@dataclass(frozen=True)
class RequestSpec:
    """One concrete request the driver will issue."""

    intended_t: float
    service: str
    api_key: str
    hash: str
    timeout: float
    #: seconds after issue at which the client abandons the request
    #: (None = waits its timeout out like a well-behaved caller)
    cancel_after: Optional[float] = None


@dataclass(frozen=True)
class ConfirmSpec:
    """One node block confirmation the driver will feed the server."""

    t: float
    account: str
    hash: str
    #: the account's prior frontier (None only for a never-seen account)
    previous: Optional[str]


@dataclass(frozen=True)
class ServiceProfile:
    name: str
    api_key: str
    weight: float
    reuse_prob: float
    cancel_rate: float
    timeout_median: float
    timeout_sigma: float


class ServicePopulation:
    """Deterministic population: same (n_services, seed) ⇒ same profiles
    and, fed the same arrivals, the same request stream."""

    def __init__(
        self,
        n_services: int = 1000,
        *,
        seed: int = 0,
        zipf_s: float = 1.1,
        reuse_prob: Tuple[float, float] = (0.0, 0.35),
        cancel_rate: Tuple[float, float] = (0.0, 0.08),
        timeout_median: Tuple[float, float] = (4.0, 16.0),
        timeout_sigma: float = 0.5,
        timeout_floor: float = 1.0,
        timeout_cap: float = 30.0,
        reuse_window: int = 8,
        hot_hash_prob: float = 0.02,
        hot_window: int = 4,
        n_accounts: Optional[int] = None,
    ):
        if n_services < 1:
            raise ValueError("need at least one service")
        self.seed = seed
        self._rng = random.Random(seed ^ 0x10AD6E)
        profile_rng = random.Random(seed)
        self.timeout_floor = timeout_floor
        self.timeout_cap = timeout_cap
        self.hot_hash_prob = hot_hash_prob
        self.profiles: List[ServiceProfile] = []
        cum: List[float] = []
        total = 0.0
        for i in range(n_services):
            name = f"svc-{i:05d}"
            weight = 1.0 / (i + 1) ** zipf_s
            self.profiles.append(
                ServiceProfile(
                    name=name,
                    api_key=f"key-{i:05d}",
                    weight=weight,
                    reuse_prob=profile_rng.uniform(*reuse_prob),
                    cancel_rate=profile_rng.uniform(*cancel_rate),
                    timeout_median=profile_rng.uniform(*timeout_median),
                    timeout_sigma=timeout_sigma,
                )
            )
            total += weight
            cum.append(total)
        self._cum = cum
        self._total = total
        self._by_name = {p.name: p for p in self.profiles}
        # per-service recent hashes (reuse pool) + the global hot set
        self._recent: dict = {}
        self._hot: Deque[str] = deque(maxlen=hot_window)
        self._reuse_window = reuse_window
        # Confirmation-side population: a (possibly much larger) Zipf of
        # accounts with the same exponent — n_accounts scales to millions
        # because accounts are index-derived, never profiled. Account i
        # belongs to service i % n_services, so the hot account head and
        # the hot service head coincide (as they do in production: the
        # busiest wallets belong to the busiest providers).
        self.n_accounts = n_accounts if n_accounts is not None else n_services
        if self.n_accounts < 1:
            raise ValueError("need at least one account")
        acc_cum: List[float] = []
        acc_total = 0.0
        for i in range(self.n_accounts):
            acc_total += 1.0 / (i + 1) ** zipf_s
            acc_cum.append(acc_total)
        self._acc_cum = acc_cum
        self._acc_total = acc_total
        self._frontiers: dict = {}  # account -> last confirmed hash

    # -- request synthesis ---------------------------------------------

    def _pick_service(self) -> ServiceProfile:
        r = self._rng.random() * self._total
        return self.profiles[min(bisect_right(self._cum, r), len(self.profiles) - 1)]

    def _fresh_hash(self) -> str:
        return f"{self._rng.getrandbits(256):064X}"

    def spec(self, arrival: Arrival) -> RequestSpec:
        """Turn one schedule arrival into a concrete request. Trace
        overrides (service/hash/timeout) win over sampled behavior."""
        if arrival.service is not None and arrival.service in self._by_name:
            profile = self._by_name[arrival.service]
        else:
            profile = self._pick_service()
        rng = self._rng
        if arrival.hash is not None:
            block_hash = arrival.hash
        else:
            recent: Deque[str] = self._recent.setdefault(
                profile.name, deque(maxlen=self._reuse_window)
            )
            if self._hot and rng.random() < self.hot_hash_prob:
                block_hash = self._hot[rng.randrange(len(self._hot))]
            elif recent and rng.random() < profile.reuse_prob:
                block_hash = recent[rng.randrange(len(recent))]
            else:
                block_hash = self._fresh_hash()
                recent.append(block_hash)
                self._hot.append(block_hash)
        if arrival.timeout is not None:
            timeout = arrival.timeout
        else:
            timeout = profile.timeout_median * math.exp(
                rng.gauss(0.0, profile.timeout_sigma)
            )
            timeout = min(max(timeout, self.timeout_floor), self.timeout_cap)
        cancel_after = None
        if rng.random() < profile.cancel_rate:
            # abandon somewhere inside the first half of the patience
            # window — a cancel at 99% of timeout is just a timeout
            cancel_after = timeout * rng.uniform(0.05, 0.5)
        return RequestSpec(
            intended_t=arrival.t,
            service=profile.name,
            api_key=profile.api_key,
            hash=block_hash,
            timeout=round(timeout, 3),
            cancel_after=cancel_after,
        )

    # -- confirmation synthesis ----------------------------------------

    def _pick_account(self) -> int:
        r = self._rng.random() * self._acc_total
        return min(bisect_right(self._acc_cum, r), self.n_accounts - 1)

    def account_name(self, idx: int) -> str:
        return f"acct-{idx:07d}"

    def confirm_spec(self, arrival: Arrival) -> ConfirmSpec:
        """Turn one schedule arrival into a block confirmation: a Zipf-
        picked account's frontier advances by one fresh hash, chained to
        its previous frontier. The new frontier is pushed into the owning
        service's reuse pool and the hot set, so subsequent request specs
        ask for it — the precache-hit coupling."""
        idx = self._pick_account()
        account = self.account_name(idx)
        block_hash = self._fresh_hash()
        previous = self._frontiers.get(account)
        self._frontiers[account] = block_hash
        profile = self.profiles[idx % len(self.profiles)]
        recent: Deque[str] = self._recent.setdefault(
            profile.name, deque(maxlen=self._reuse_window)
        )
        recent.append(block_hash)
        self._hot.append(block_hash)
        return ConfirmSpec(
            t=arrival.t, account=account, hash=block_hash, previous=previous
        )

    # -- store registration --------------------------------------------

    async def seed_store(self, store) -> int:
        """Register every simulated service in the Store the way
        scripts/services.py registers a real one, so auth, throttles and
        quotas meter the population per service. Returns the count."""
        from ..server import hash_key

        for p in self.profiles:
            await store.hset(
                f"service:{p.name}",
                {
                    "api_key": hash_key(p.api_key),
                    "public": "N",
                    "display": p.name,
                    "website": "",
                    "precache": "0",
                    "ondemand": "0",
                },
            )
            await store.sadd("services", p.name)
        return len(self.profiles)

    async def seed_accounts(
        self, store, *, limit: Optional[int] = None, expire=None
    ) -> int:
        """Make the hottest ``limit`` accounts KNOWN to the server before
        the run (a genesis frontier under ``account:{name}``), the way a
        long-lived deployment has already tracked its regulars. Without
        this every confirmation of a fresh population is an
        unknown_account and a debug-mode run would be the only way to
        exercise precache — which bypasses the score policy this seeding
        exists to measure. The tail past ``limit`` stays unknown, as the
        tail does in production."""
        count = min(limit if limit is not None else self.n_accounts,
                    self.n_accounts)
        for i in range(count):
            account = self.account_name(i)
            genesis = f"{i:064X}"
            await store.set(f"account:{account}", genesis, expire)
            self._frontiers.setdefault(account, genesis)
        return count
