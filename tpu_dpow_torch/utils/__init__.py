from . import nanocrypto  # noqa: F401


def maybe_init_distributed() -> None:
    """Entrypoint hook: join a multi-host deployment iff TPU_DPOW_COORDINATOR
    is set (parallel/multihost.py's env contract).

    The env check lives here so that a single-host startup never imports
    ``torch.distributed``.
    """
    import os

    if os.environ.get("TPU_DPOW_COORDINATOR"):
        from ..parallel.multihost import init_distributed

        init_distributed()
