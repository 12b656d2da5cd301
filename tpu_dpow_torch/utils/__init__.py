from . import nanocrypto  # noqa: F401
