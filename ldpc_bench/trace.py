"""The traced slice: ``torch.profiler`` over a fixed number of blocks, the
spans the benchmark wraps around calls into the program, and the summary
that the per-layer metric readers (``metrics/<name>.py``) read.

Device busy time is the union of the intervals of every device operation
(kernels, copies, fills); the profiler's mirrors of ``record_function``
ranges on the device timeline are annotations and not device work. The
time a span holds the device is that union clipped to the span's mirrored
intervals. Host reads are device-to-host copies: each waits for the stream.
"""
from __future__ import annotations

import functools
import time
from collections import defaultdict

import torch

SPAN_PREFIX = "bench."


class Context:
    """What a metric reader's ``install`` and ``read`` see: the decoder,
    the configuration, the device's peaks, and the records that installed
    wrappers keep while ``tracing`` is on."""

    def __init__(self, decoder, config: dict, device, peaks):
        self.decoder = decoder
        self.config = config
        self.device = device
        self.peaks = peaks
        self.tracing = False
        self.records = defaultdict(list)
        self.batches = 0
        self.trials = 0
        self.spans = set()
        self.notes = {}

    def span(self, name: str):
        """A decorator that runs a function under the profiler range
        ``bench.<name>`` while tracing."""
        full = SPAN_PREFIX + name
        self.spans.add(full)

        def wrap(fn):
            @functools.wraps(fn)
            def wrapped(*args, **kwargs):
                if not self.tracing:
                    return fn(*args, **kwargs)
                with torch.profiler.record_function(full):
                    return fn(*args, **kwargs)
            return wrapped
        return wrap

    def record(self, key: str, value) -> None:
        if self.tracing:
            self.records[key].append(value)


def _merge(spans):
    """Sorted disjoint union of (start, end) intervals."""
    out = []
    for s, e in sorted(spans):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _length(merged) -> float:
    return sum(e - s for s, e in merged)


def _overlap(a, b) -> float:
    """Length of the intersection of two merged interval lists."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def _is_annotation(e) -> bool:
    return bool(getattr(e, "is_user_annotation", False)) or \
        e.name.startswith(SPAN_PREFIX)


def _gaps(busy, host, spans, window):
    """Idle gaps between device operations, each named by what the host's
    main thread was doing at the gap's middle: the innermost benchmark span
    and the innermost operation (``python`` where no operation was open)."""
    if not host:
        return []
    thread = max(set(e.thread for e in host),
                 key=lambda t: sum(1 for e in host if e.thread == t))
    host = sorted(((e.time_range.start, -e.time_range.end, e.name)
                   for e in host if e.thread == thread))
    lo, hi = window
    edges = [lo] + [p for iv in busy for p in iv] + [hi]
    gaps = [(edges[k], edges[k + 1]) for k in range(0, len(edges), 2)
            if edges[k + 1] > edges[k]]
    named = defaultdict(float)
    stack, i = [], 0
    for start, end in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = 0.5 * (start + end)
        while i < len(host) and host[i][0] <= mid:
            s, neg_e, name = host[i]
            while stack and stack[-1][0] < s:
                stack.pop()
            stack.append((-neg_e, name))
            i += 1
        while stack and stack[-1][0] < mid:
            stack.pop()
        live = [name for e, name in stack if e >= mid]
        span = next((n for n in reversed(live) if n in spans), "no span")
        op = live[-1] if live and live[-1] not in spans else "python"
        named[f"{span} > {op}"] += end - start
    return sorted(named.items(), key=lambda kv: -kv[1])


def profile(ctx: Context, run) -> dict:
    """Run ``run()`` under the profiler with ``ctx.tracing`` on; returns the
    summary the metric readers take."""
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU]
    if ctx.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(ctx.device)
    ctx.batches = ctx.trials = 0
    with torch.profiler.profile(activities=acts) as prof:
        ctx.tracing = True
        t0 = time.perf_counter()
        run()
        if ctx.device.type == "cuda":
            torch.cuda.synchronize(ctx.device)
        wall_us = (time.perf_counter() - t0) * 1e6
        ctx.tracing = False
    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    dev_ops = [e for e in events if e.device_type == cuda
               and not _is_annotation(e)]
    marks = defaultdict(list)
    for e in events:
        if e.device_type == cuda and e.name in ctx.spans:
            marks[e.name].append((e.time_range.start, e.time_range.end))
    busy = _merge((e.time_range.start, e.time_range.end) for e in dev_ops)
    by_name = defaultdict(float)
    for e in dev_ops:
        by_name[e.name] += e.time_range.end - e.time_range.start
    host = [e for e in events if e.device_type != cuda]
    starts = [e.time_range.start for e in host] or [0.0]
    lo = min(starts)
    window = (lo, lo + wall_us)
    return {
        "window_us": wall_us,
        "busy_us": _length(busy),
        "device_us_by_name": dict(by_name),
        "busy_under_us": {name: _overlap(busy, _merge(iv))
                          for name, iv in marks.items()},
        "host_reads": sum(1 for e in dev_ops if "DtoH" in e.name),
        "batches": ctx.batches,
        "trials": ctx.trials,
        "idle_by_host": _gaps(busy, host, ctx.spans, window),
    }


def breakdown(summary: dict) -> dict:
    """The ten device operations with most time and the ten longest idle
    gaps by what the host was doing, in seconds."""
    ops = sorted(summary["device_us_by_name"].items(), key=lambda kv: -kv[1])
    return {"device_ops": [[n[:160], us / 1e6] for n, us in ops[:10]],
            "idle_gaps": [[n[:160], us / 1e6]
                          for n, us in summary["idle_by_host"][:10]]}

