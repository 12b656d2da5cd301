"""Device-parallel nonce search of the port.

Counterpart of ``tpu_dpow/parallel/``. So far the port has the device fan
(``fan_search.py``: one request's range over several devices, per-member
launches of the hand-written kernels, host stagger and election). The
shard_map mesh (``mesh_search.py``) and the multi-host topology
(``multihost.py``) come with a later slice.
"""

from .fan_search import (  # noqa: F401
    CPU_FAN_DEVICES,
    elect,
    fan_devices,
    fan_search_chunk_batch,
    fan_search_devices,
    fan_search_run,
    fan_search_run_controlled,
    stagger,
)
