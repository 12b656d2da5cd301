"""worker_device_init_s: the part of the worker's start-up spent on the
card (s): its ``cuda_context``, ``kernels`` (nvcc builds or loads) and
``self_test`` phases of ``dpow_client_startup_seconds`` on the worker's
/metrics at the window's start. None where the worker does not time its
start-up."""

from dpowbench import prom

STARTUP = "dpow_client_startup_seconds"
PHASES = ("cuda_context", "kernels", "self_test")


def read(src):
    before, _after = src["worker"]
    if STARTUP not in before:
        return None
    return sum(prom.value(before, STARTUP, {"phase": p}) for p in PHASES)
