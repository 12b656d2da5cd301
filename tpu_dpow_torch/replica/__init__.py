"""Replicated orchestrator: hash-partitioned ownership, leaderless takeover.

The port's own copy of ``tpu_dpow/replica/``, with the same class, function,
metric family and label names; only the imports point at tpu_dpow_torch.

The single-process DpowServer's flood ceiling is architectural — one MQTT
session, one admission window, one event loop. This
package makes the orchestrator REPLICABLE: N near-stateless server replicas
behind the POST/WS faces, each owning a hash-partitioned slice of request
space over the shared Store (the quota ledger, fleet registry, and
DegradedStore journal already live there and already survive failover).

  * :mod:`~tpu_dpow_torch.replica.ring` — deterministic rendezvous hash→owner
    table; any replica answers "whose request is this" without consensus;
  * :mod:`~tpu_dpow_torch.replica.registry` — store-backed membership: epoch at
    join, heartbeat SEQUENCE (clock-skew-free staleness), observer-side
    death detection on the injectable resilience Clock;
  * :mod:`~tpu_dpow_torch.replica.fence` — epoch-fenced writes; the ONLY module
    allowed to touch ``replica:*`` store keys (dpowlint DPOW901), so a
    zombie replica's stale writes bounce instead of resurrecting state;
  * :mod:`~tpu_dpow_torch.replica.coordinator` — the facade the server talks to:
    routing, the per-dispatch takeover journal, and the leaderless
    adopt-a-dead-peer protocol built on the store's setnx winner-lock
    idiom plus the existing DispatchSupervisor.

Protocol, failure matrix, and metric catalogue: docs/replication.md.
"""

from .coordinator import ReplicaCoordinator, dispatch_topic, result_lane  # noqa: F401
from .fence import StaleEpoch  # noqa: F401
from .registry import ReplicaRegistry  # noqa: F401
from .ring import HashRing, owner_of  # noqa: F401
