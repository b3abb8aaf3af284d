"""Where the time of the port's ALP path goes, on one CUDA device.

Runs ALP (optimalH, -3 dB, batches of 256, the sweep app's configuration)
through ``run_experiment`` once to warm up (kernel build included), then
once more under ``torch.profiler``, and prints: the wall time and device-busy
time of the profiled run and the idle share; the PDHG kernel's share of
device time and its launches per row tier; the device time spent under each phase of a cut round (cut
search, tier solve, the rest), marked with ``record_function`` ranges that
this script wraps around the decoder's functions; the host reads per batch
(device-to-host copies, each of which waits for the stream); and the kernels
ranked by device time. The Chrome trace goes to
``build/torch_alp_trace.json`` (gitignored).

    python -m scripts.torch_profile_alp [--trials 1024]
"""
from __future__ import annotations

import argparse
import functools
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from ldpc_tpu_torch import bench
from ldpc_tpu_torch.channel.awgn import gen_random_codewords
from ldpc_tpu_torch.codes.gf2 import gf2_nullspace
from ldpc_tpu_torch.codes.io import read_pcm
from ldpc_tpu_torch.decoders import alp
from ldpc_tpu_torch.harness.experiment import run_experiment
from ldpc_tpu_torch.ops import pdhg_kernel

TRACE = "build/torch_alp_trace.json"
SNR = -3.0
BATCH = 256
RANGES = {"alp.cut_search": ("alp_cut_candidates", "cut_hashes",
                             "append_cuts")}
RANGE_NAMES = ("alp.round", "alp.cut_search", "alp.solve")


def _union_us(spans, lo=float("-inf"), hi=float("inf")) -> float:
    """Length of the union of (start, stop) intervals, clipped to
    [lo, hi]."""
    busy, end = 0.0, float("-inf")
    for start, stop in sorted(spans):
        start, stop = max(start, lo), min(stop, hi)
        if stop > end and stop > start:
            busy += stop - max(start, end)
            end = stop
    return busy


def _ranged(name, fn):
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with record_function(name):
            return fn(*args, **kwargs)
    return wrapped


def _mark_phases():
    """Wrap the cut round's phases in profiler ranges (this process only)."""
    for name, fns in RANGES.items():
        for fn in fns:
            setattr(alp, fn, _ranged(name, getattr(alp, fn)))
    alp._AdaptiveLPBase._solve = _ranged("alp.solve",
                                         alp._AdaptiveLPBase._solve)
    alp._AdaptiveLPBase._round_body = _ranged(
        "alp.round", alp._AdaptiveLPBase._round_body)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--trials", type=int, default=4 * BATCH)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda")
    h = read_pcm(str(bench.MATRIX))
    g, _ = gf2_nullspace(h)
    cw = gen_random_codewords(g, args.trials,
                              torch.Generator().manual_seed(bench.SEED), dev)
    dec = alp.ALPDecoder(h, device=dev)
    _mark_phases()

    def run():
        return run_experiment(dec, h, cw, SNR, bench.SEED + 1,
                              batch_size=BATCH, device=dev, warmup=False)

    run()
    torch.cuda.synchronize()
    launches = pdhg_kernel.LAUNCHES
    pdhg_kernel.reset_tier_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = run()
        wall = time.perf_counter() - t0
    launches = pdhg_kernel.LAUNCHES - launches
    batches = -(-args.trials // BATCH)
    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    # the profiler mirrors record_function ranges onto the device timeline
    # as annotations spanning their kernels; they are not device work
    dev_events = [e for e in events if e.device_type == cuda
                  and e.name not in RANGE_NAMES]
    spans = [(e.time_range.start, e.time_range.end) for e in dev_events]
    busy_us = _union_us(spans)
    pdhg_us = sum(e.time_range.elapsed_us() for e in dev_events
                  if "pdhg_chunk_kernel" in e.name)
    d2h = sum(1 for e in dev_events if "DtoH" in e.name)
    print(f"device: {bench.card_stamp(dev)}")
    print(f"profiled run: ALP optimalH {SNR} dB, {res.total} trials in "
          f"{batches} batches of {BATCH}, FER {res.fer:.4f}, mean rounds "
          f"{res.sum_iterations / res.total:.3f}; wall {wall * 1e3:.3f} ms "
          f"(profiler on), device busy {busy_us / 1e3:.3f} ms, idle share "
          f"{1.0 - busy_us / 1e6 / wall:.4f}")
    print(f"pdhg_chunk_kernel: {pdhg_us / 1e3:.3f} ms over {launches} "
          f"launches ({launches / batches:.1f} per batch), "
          f"{pdhg_us / busy_us:.4f} of device busy time; launches per row "
          f"tier T: {dict(sorted(pdhg_kernel.TIER_LAUNCHES.items()))}")
    print(f"host reads (device-to-host copies): {d2h} ({d2h / batches:.1f} "
          f"per batch)")
    for name in RANGE_NAMES:
        marks = [e for e in events if e.name == name]
        host = sum(e.cpu_time_total for e in marks if e.device_type != cuda)
        on_dev = [(e.time_range.start, e.time_range.end) for e in marks
                  if e.device_type == cuda]
        busy_in = sum(_union_us(spans, lo, hi) for lo, hi in on_dev)
        print(f"{name}: {sum(e.device_type != cuda for e in marks)} calls, "
              f"device busy under it {busy_in / 1e3:.3f} ms "
              f"({busy_in / busy_us:.4f}), its device span "
              f"{_union_us(on_dev) / 1e3:.3f} ms, host {host / 1e3:.3f} ms")
    print(prof.key_averages().table(sort_by="self_device_time_total",
                                    row_limit=25, max_name_column_width=60))
    os.makedirs(os.path.dirname(TRACE), exist_ok=True)
    prof.export_chrome_trace(TRACE)


if __name__ == "__main__":
    main()
