"""Admission control & fair scheduling for the server's dispatch path.

The port's own copy of ``tpu_dpow/sched/``, with the same class, function,
metric family and label names; only the imports point at tpu_dpow_torch.

The reference hub accepts every request unconditionally and fans it out to
all workers at once; under overload nothing in it knows who is asking,
what is urgent, or when to say no. This package is that missing layer
(HashCore frames PoW throughput as a scheduling problem over heterogeneous
compute; VaultxGPU gates its consensus pipeline behind explicit admission
stages — PAPERS.md):

  quota.py      — store-backed token-bucket ledger keyed by service;
                  bucket state persists across restarts via the Store
                  protocol (memory / sqlite / redis / degraded+).
  queue.py      — weighted priority queue: class (on-demand > precache),
                  quota standing, deadline slack, difficulty — with
                  round-robin fair share across services.
  window.py     — bounded in-flight dispatch window with backpressure:
                  full ⇒ on-demand queues then sheds (precache →
                  over-quota → most slack), precache sheds immediately,
                  evictions surface as :class:`Busy` (HTTP 429 +
                  Retry-After / websocket ``busy`` frame).
  admission.py  — the controller the server routes through, plus every
                  ``dpow_sched_*`` metric family.

All timers run on the injectable ``resilience.clock.Clock``; the overload
scenarios in tests/test_sched_overload.py and tests/test_chaos.py play out
on a FakeClock with no real sleeps. Contract: docs/admission.md.
"""

from .admission import NODE_SERVICE, AdmissionController  # noqa: F401
from .queue import ONDEMAND, PRECACHE, FairQueue, Ticket  # noqa: F401
from .quota import QuotaLedger, QuotaVerdict  # noqa: F401
from .window import Busy, DispatchWindow  # noqa: F401
