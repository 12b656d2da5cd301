from . import nanocrypto  # noqa: F401


def hash_key(api_key: str) -> str:
    """Service api_key hashing (parity: reference scripts/services.py:27-30).

    The same digest as ``tpu_dpow.utils.hash_key``: one store authenticates
    a service under either hub, so any drift (digest size, salt, encoding)
    would lock every service out with 'Invalid credentials'.
    """
    import hashlib

    m = hashlib.blake2b()
    m.update(api_key.encode())
    return m.hexdigest()


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
