"""Fleet coordination: worker registry, sharded dispatch, straggler re-cover.

The port's own copy of ``tpu_dpow/fleet/``, with the same class, function,
metric family and label names; only the imports point at tpu_dpow_torch.

The reference hub treats its swarm as an anonymous broadcast audience; this
package makes the fleet a first-class, observable resource (docs/fleet.md):

  registry    — who is alive and how fast (announces + EMA from wins),
                persisted through the Store protocol;
  planner     — disjoint, hashrate-weighted u64 nonce-range partitions,
                with broadcast fallback when the fleet is too small;
  cover       — per-dispatch shard table: win attribution, dead-shard
                re-cover through the resilience supervisor;
  coordinator — the publish facade the server's dispatch paths call.

Everything timer-driven runs on the injectable resilience Clock, and every
decision lands in the ``dpow_fleet_*`` metric families
(docs/observability.md).
"""

from .cover import CoverageTracker  # noqa: F401
from .coordinator import ANNOUNCE_TOPIC, FleetCoordinator, work_topic  # noqa: F401
from .planner import (  # noqa: F401
    BROADCAST,
    SHARDED,
    SPACE,
    Assignment,
    FleetPlanner,
    Plan,
)
from .registry import MIN_HASHRATE, WorkerInfo, WorkerRegistry  # noqa: F401
