"""engine_overscan.capacity: nonces the engine scanned per solution over the
expected nonces per solution at the hub's threshold (x), in the window."""

from dpowbench.readers import overscan


def read(src):
    return overscan(src)
