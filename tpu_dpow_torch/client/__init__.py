from .app import DpowClient  # noqa: F401
from .config import ClientConfig, parse_args  # noqa: F401
from .work_handler import WorkHandler, WorkQueue  # noqa: F401
