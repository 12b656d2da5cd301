"""worker_startup_s: the worker's start-up, from its process's start to the
end of its set-up (s): the sum of ``dpow_client_startup_seconds`` over its
phases on the worker's /metrics at the window's start. None where the
worker does not time its start-up."""

from dpowbench import prom

STARTUP = "dpow_client_startup_seconds"


def read(src):
    before, _after = src["worker"]
    if STARTUP not in before:
        return None
    return prom.value(before, STARTUP)
