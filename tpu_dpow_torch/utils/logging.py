"""Logger factory: stdout + optional rotating file.

Capability parity with the reference's hybrid watched/timed rotating
handlers (reference server/dpow/logger.py, client/logger.py): daily
rotation, bounded backups, DEBUG to file / INFO to stdout.

The port's own copy of ``tpu_dpow/utils/logging.py``. Handlers are
attached ONCE to the package root logger ("tpu_dpow_torch") and children
propagate into them, so configuring any child with a file also captures
the engine's and the fault domains' warnings.
"""

from __future__ import annotations

import logging
import logging.handlers
import os
import sys
from typing import Optional

_ROOT = "tpu_dpow_torch"


def get_logger(
    name: str = _ROOT,
    *,
    file_path: Optional[str] = None,
    debug: bool = False,
    backup_count: int = 30,
) -> logging.Logger:
    """Module-level logger accessor; configures defaults on first touch."""
    root = logging.getLogger(_ROOT)
    if not root.handlers or file_path or debug:
        # First touch, or an entrypoint passing explicit flags AFTER
        # import-time default setup (api.py etc. call get_logger at module
        # level) — explicit flags must win.
        configure_logger(file_path=file_path, debug=debug, backup_count=backup_count)
    return logging.getLogger(name)


def configure_logger(
    name: str = _ROOT,
    *,
    file_path: Optional[str] = None,
    debug: bool = False,
    backup_count: int = 30,
) -> logging.Logger:
    """(Re)build the package root's handlers from the given flags."""
    root = logging.getLogger(_ROOT)
    for handler in list(root.handlers):
        root.removeHandler(handler)
        handler.close()
    root.setLevel(logging.DEBUG)
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s")

    stream = logging.StreamHandler(sys.stdout)
    stream.setLevel(logging.DEBUG if debug else logging.INFO)
    stream.setFormatter(fmt)
    root.addHandler(stream)

    if file_path:
        os.makedirs(os.path.dirname(os.path.abspath(file_path)), exist_ok=True)
        fileh = logging.handlers.TimedRotatingFileHandler(
            file_path, when="d", interval=1, backupCount=backup_count
        )
        fileh.setLevel(logging.DEBUG)
        fileh.setFormatter(fmt)
        root.addHandler(fileh)
    return logging.getLogger(name)
