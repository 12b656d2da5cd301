"""The DPoW hub of the port: counterpart of ``tpu_dpow/server/``.

Run it with ``python -m tpu_dpow_torch.server`` (or ``tpu-dpow-torch-server``).
"""

from .app import DpowServer, hash_key, WORK_PENDING  # noqa: F401
from .config import ServerConfig, parse_args  # noqa: F401
from .exceptions import InvalidRequest, RequestTimeout, RetryRequest  # noqa: F401
