"""Device-parallel nonce search of the port.

Counterpart of ``tpu_dpow/parallel/``. Two gang implementations share one
contract, as in the JAX package: the (batch, nonce) mesh
(``mesh_search.py``: contiguous row blocks per batch shard, one search-
kernel launch per nonce member, host stagger and host min election) and
the device fan (``fan_search.py``: one request's range over several
devices with per-device bases and attribution). ``multihost.py`` lays a
mesh over several processes of a ``torch.distributed`` group.
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
from .mesh_search import (  # noqa: F401
    BATCH_AXIS,
    NONCE_AXIS,
    expected_steps,
    make_mesh,
    replicate_params,
    sharded_search_chunk_batch,
    sharded_search_run,
    sharded_search_run_controlled,
)
from .multihost import (  # noqa: F401
    arrange_by_host,
    init_distributed,
    make_multihost_mesh,
)
