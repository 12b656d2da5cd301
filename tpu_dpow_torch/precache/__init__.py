"""Population-scale precache: score accounts, bound the cache, shape the feed.

The port's own copy of ``tpu_dpow/precache/``, with the same class, function,
metric family and label names; only the imports point at tpu_dpow_torch.

The reference precaches for a flat set of "known accounts" (reference
dpow_server.py:170-206): every confirmed block of any known account
immediately burns a dispatch. Production Nano is millions of accounts on a
heavy Zipf tail — most confirmations belong to accounts that will never
request work before their frontier moves again, so flat precaching spends
almost all of its speculative capacity on the tail and the cache-hit ratio
collapses exactly when load makes it matter.

This package replaces the flat path with a ranked, bounded, rate-shaped
pipeline (docs/precache.md):

  * :mod:`.scorer` — per-account activity EMA on the resilience Clock
    (the fleet-registry idiom), persisted under ``precache:score:{account}``
    for the hot head only, so a million-account population costs a bounded
    in-memory table and the long tail is cheap to ignore;
  * :mod:`.cache` — a bounded priority cache of precached work: admission
    by score against a capacity watermark, eviction by lowest score, lease
    lapse (sched/window.py's machinery) reaping entries whose dispatch
    died. THIS bound — not the unbounded scatter of ``account:{account}``
    frontier keys — decides whether a confirmation is worth solving;
  * :mod:`.pipeline` — the decision + dispatch path: ring-ownership gated,
    frontier-fenced (Store.getset), shed first under load (the autoscaler's
    lever), dispatched at strictly-lower FairQueue priority and never
    occupying more than a configured fraction of the admission window,
    optionally batch-fused across confirmations of the same tick.
"""

from .cache import CacheEntry, PrecacheCache
from .pipeline import PrecachePipeline
from .scorer import AccountScorer

__all__ = [
    "AccountScorer",
    "CacheEntry",
    "PrecacheCache",
    "PrecachePipeline",
]
