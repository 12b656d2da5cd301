"""Launcher of one process of the stack under test.

    python -m dpowbench.child REPORT MODULE [ARGS...]

runs ``python -m MODULE ARGS...`` in this interpreter and, at exit, writes
to ``REPORT`` the top-level names of the forbidden modules it holds (JAX and
the JAX package must never load). SIGTERM ends it as SIGINT does, so the
module's own shutdown runs.

For the worker (``tpu_dpow_torch.client``) it also marks the measured
window: SIGUSR1 opens it and SIGUSR2 closes it, after which ``REPORT`` gets
the card's name and peak memory. With ``DPOWBENCH_TRACE=<path>`` in the
environment a ``torch.profiler`` session (device activity only) runs from
start-up, and a ``spin_kernel`` on a stream of the launcher's own marks each
end of the window in the device trace, which is written to ``<path>`` once
the window has closed and the kernels in flight at its end have finished.
"""

from __future__ import annotations

import atexit
import json
import os
import runpy
import signal
import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_dpow")
#: seconds between the closing mark and the profiler's stop: a chunked
#: launch of 16 windows runs ~0.9 s on the card, and a kernel that has not
#: ended by the stop is missing from the trace
TRACE_DRAIN_S = 2.0


def forbidden_modules() -> list:
    """Forbidden top-level names in ``sys.modules``, compared whole."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def _write(path: str, obj: dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


class WorkerWindow:
    """The worker's side of the measured window."""

    def __init__(self, report: str, trace_path: str):
        self.report = report
        self.trace_path = trace_path
        self.prof = self.stream = None
        if trace_path:
            from torch.profiler import ProfilerActivity, profile

            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.start()

    def _mark(self) -> None:
        import torch

        if self.stream is None:
            self.stream = torch.cuda.Stream()
        with torch.cuda.stream(self.stream):
            torch.cuda._sleep(1000)

    def open(self, *_args) -> None:
        if self.prof is not None:
            self._mark()

    def close(self, *_args) -> None:
        import asyncio

        if self.prof is not None:
            self._mark()
            asyncio.get_running_loop().call_later(TRACE_DRAIN_S, self._finish)
        else:
            self._finish()

    def _finish(self) -> None:
        import torch

        out = {"forbidden": forbidden_modules()}
        if torch.cuda.is_available():
            out.update(kind=torch.cuda.get_device_name(),
                       memory_peak_bytes=torch.cuda.max_memory_allocated())
        if self.prof is not None:
            self.stream.synchronize()
            self.prof.stop()
            self.prof.export_chrome_trace(self.trace_path)
            out["trace"] = self.trace_path
        _write(self.report + ".window", out)


def main(argv) -> None:
    report, module, args = argv[0], argv[1], argv[2:]

    def on_term(*_args):
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, on_term)
    atexit.register(lambda: _write(report, {"forbidden": forbidden_modules()}))
    if module == "tpu_dpow_torch.client":
        window = WorkerWindow(report, os.environ.get("DPOWBENCH_TRACE", ""))
        signal.signal(signal.SIGUSR1, window.open)
        signal.signal(signal.SIGUSR2, window.close)
    sys.argv = [module, *args]
    try:
        runpy.run_module(module, run_name="__main__", alter_sys=True)
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main(sys.argv[1:])
