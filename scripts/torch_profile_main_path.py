"""Where the time of the port's main path goes, on one CUDA device.

Runs the benchmark's configuration once to warm up (kernel build included),
then once more under ``torch.profiler``, and prints: the wall time of the
profiled run, the device-busy time (sum of kernel times on the one stream)
and idle share, and the kernels ranked by device time. The Chrome trace goes
to ``build/torch_main_path_trace.json`` (gitignored).

    python -m scripts.torch_profile_main_path
"""
from __future__ import annotations

import os
import time

import torch
from torch.profiler import ProfilerActivity, profile

from ldpc_tpu_torch import bench
from ldpc_tpu_torch.channel.awgn import gen_random_codewords
from ldpc_tpu_torch.codes.gf2 import gf2_nullspace
from ldpc_tpu_torch.codes.io import read_pcm
from ldpc_tpu_torch.decoders.bp import BPDecoder
from ldpc_tpu_torch.harness.experiment import run_experiment

TRACE = "build/torch_main_path_trace.json"


def _busy_us(events) -> float:
    """Length of the union of the device-side intervals (kernels, copies)."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for start, stop in spans:
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    return busy


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda")
    h = read_pcm(str(bench.MATRIX))
    g, _ = gf2_nullspace(h)
    cw = gen_random_codewords(g, bench.TRIALS,
                              torch.Generator().manual_seed(bench.SEED), dev)
    dec = BPDecoder(h, max_iter=100, device=dev)

    def run():
        return run_experiment(dec, h, cw, bench.SNR, bench.SEED + 1,
                              batch_size=bench.BATCH, device=dev,
                              warmup=False)

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = run()
        wall = time.perf_counter() - t0
    busy_us = _busy_us(prof.events())
    events = prof.key_averages()
    print(f"device: {bench.card_stamp(dev)}")
    print(f"profiled run: {res.total} trials, FER {res.fer:.4f}, wall "
          f"{wall * 1e3:.3f} ms (profiler on), device busy "
          f"{busy_us / 1e3:.3f} ms, idle share "
          f"{1.0 - busy_us / 1e6 / wall:.4f}")
    print(events.table(sort_by="self_device_time_total", row_limit=25,
                       max_name_column_width=60))
    os.makedirs(os.path.dirname(TRACE), exist_ok=True)
    prof.export_chrome_trace(TRACE)


if __name__ == "__main__":
    main()
