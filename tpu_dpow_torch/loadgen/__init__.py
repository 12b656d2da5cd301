"""Open-loop traffic generation, the port's copy of ``tpu_dpow/loadgen/``.

A closed-loop flood (a fixed pool of coroutines that fires a request, waits
for the answer and fires the next) measures the system at whatever rate
the system itself permits: when the hub slows down, the generator slows
down with it, and the latency numbers silently omit every request that
*would* have arrived while the stack was wedged (coordinated omission).
Wallets do not wait for anyone. This package is the open-loop generator:

  arrival     — arrival-schedule generators: homogeneous Poisson, diurnal
                sinusoid (non-homogeneous Poisson via thinning), spike
                overlays, and flash-crowd replay from a JSONL trace (the
                parser refuses non-monotonic timestamps with a
                line-numbered error instead of sleeping backwards);
  population  — thousands of simulated services with per-service behavior:
                Zipf popularity, hash-reuse probability (drives store hits
                and same-hash coalescing), cancel rate, a per-request
                timeout distribution, and a real quota identity (each
                simulated service is registered in the store and metered
                by the hub's sched layer like any paying customer) — plus
                the node-side workload: a Zipf-over-accounts block
                confirmation stream whose frontiers chain per account;
  recorder    — coordinated-omission-safe capture: every latency is
                measured from the *intended* arrival time on the
                injectable resilience.Clock, never from the moment the
                generator got around to sending;
  driver      — the open-loop scheduler plus drivers that speak the real
                faces: HTTP POST /service/ and the /service_ws/ websocket,
                round-robin with failover across N replica processes;
  responder   — a synthetic worker (real transport, fixed solve latency)
                so orchestration-layer captures aren't confounded by
                device compute (``python -m tpu_dpow_torch.loadgen.responder``);
  sim         — a discrete-event twin of the replica ring (admission
                window + queue + service-time model) that runs
                million-request schedules in seconds of wall clock with
                the real autoscale controller (``tpu_dpow_torch.autoscale``)
                in the loop. Imported as ``tpu_dpow_torch.loadgen.sim``.

Names, seeds and metric families are ``tpu_dpow.loadgen``'s, so the same
seed gives the same schedule, population, recorder output and sim outcome
in both packages.
"""

from .arrival import (  # noqa: F401
    Arrival,
    ConstantRate,
    DiurnalRate,
    SpikeOverlay,
    TraceError,
    parse_trace,
    poisson_schedule,
    trace_schedule,
)
from .population import ConfirmSpec, RequestSpec, ServicePopulation  # noqa: F401
from .recorder import FINE_BUCKETS, OpenLoopRecorder  # noqa: F401
from .driver import (  # noqa: F401
    ConfirmFeed,
    HttpPostDriver,
    InprocDriver,
    OpenLoopDriver,
    WsDriver,
)
from .responder import SyntheticResponder  # noqa: F401
