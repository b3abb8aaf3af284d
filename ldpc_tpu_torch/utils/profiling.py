"""Tracing and timing helpers (counterpart of
``ldpc_tpu/utils/profiling.py``).

The reference's only tracing is per-trial wall-clock time around
``decode()`` (``experiment.h:100-103``). Here:

* :func:`trace`: a context manager that records a ``torch.profiler`` trace
  of the enclosed region (CPU, and the card's kernels when one is visible)
  and writes it as a Chrome trace into a directory; without a directory it
  does nothing;
* :func:`span` and :func:`spanned`: the program's named ranges
  (:data:`SPANS`), opened inside the function whose work each names (or
  around its whole call): the harness's block, channel, classification,
  synchronises and refills, the decoders' rounds, cut search, appends and
  host reads, the LP solves and their chunk polls, the IPM's graph
  captures and copies into its static buffers, and QP-ADMM's decode and
  its stream's start, chunks and finish;
* :class:`Timer`: accumulating wall-clock timing whose ``stop`` waits for
  the card when it is handed tensors on it, so that queued work is
  counted.

Spans are on exactly while a ``torch.profiler`` records (:func:`trace`, a
benchmark's traced run, a profiling script): :func:`span` is then
``torch.profiler.record_function``, and so is each call of a function
under :func:`spanned`, so each span sits on the profiler's own timeline
beside the card's kernels and copies, and its device-side mirror is an
annotation, not device work. Otherwise :func:`span` is one shared no-op
context and a spanned function is called as it is, either at the cost of
a check of the profiler's state; nothing else turns spans on or off.
"""
from __future__ import annotations

import contextlib
import functools
import os
import time

import torch

__all__ = ["SPANS", "Timer", "span", "spanned", "trace"]

# every span the program opens, outermost layer first (``harness.block >
# harness.channel``, ``alp.decode > alp.round > lp.solve > lp.poll``)
SPANS = frozenset({
    "harness.block", "harness.channel", "harness.count", "harness.sync",
    "harness.refill",
    "bp.decode",
    "alp.decode", "alp.round", "alp.cut_search", "alp.append",
    "alp.tier_read", "alp.done_read", "agc.gauss",
    "lp.solve", "lp.poll", "lp.capture", "lp.copy_in",
    "admm.decode", "admm.init", "admm.chunk", "admm.finish",
})

_OFF = contextlib.nullcontext()
_recording = torch.autograd._profiler_enabled


def span(name: str):
    """A context manager for the program's span ``name``: a
    ``record_function`` range while a profiler records, else a shared
    no-op. A name outside :data:`SPANS` raises ``ValueError`` (checked
    only while a profiler records)."""
    if not _recording():
        return _OFF
    if name not in SPANS:
        raise ValueError(f"span {name!r} is not in profiling.SPANS")
    return torch.profiler.record_function(name)


def spanned(name: str):
    """Decorator: each call of the function is the span ``name`` while a
    profiler records, as if its body were under :func:`span`. The name is
    checked against :data:`SPANS` once, when the function is decorated."""
    if name not in SPANS:
        raise ValueError(f"span {name!r} is not in profiling.SPANS")

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _recording():
                return fn(*args, **kwargs)
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        return call
    return wrap


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
