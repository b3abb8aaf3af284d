"""Tracing and timing helpers (counterpart of
``ldpc_tpu/utils/profiling.py``).

The reference's only tracing is per-trial wall-clock time around
``decode()`` (``experiment.h:100-103``). Here:

* :func:`trace`: a context manager that records a ``torch.profiler`` trace
  of the enclosed region (CPU, and the card's kernels when one is visible)
  and writes it as a Chrome trace into a directory; without a directory it
  does nothing;
* :class:`Timer`: accumulating wall-clock timing whose ``stop`` waits for
  the card when it is handed tensors on it, so that queued work is
  counted.
"""
from __future__ import annotations

import contextlib
import os
import time

import torch

__all__ = ["trace", "Timer"]


@contextlib.contextmanager
def trace(trace_dir: str | None):
    """``torch.profiler`` trace of the enclosed region when ``trace_dir``
    is set, written to ``trace_dir/trace_<pid>_<ns>.json``."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        trace_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


class Timer:
    """Accumulating wall-clock timer; ``stop`` waits for the card when any
    tensor it is given lies on it."""

    def __init__(self):
        self.total = 0.0
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()
        return self

    def stop(self, *tensors):
        if any(isinstance(t, torch.Tensor) and t.is_cuda for t in tensors):
            torch.cuda.synchronize()
        self.total += time.perf_counter() - self._t0
        self._t0 = None
        return self.total

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
