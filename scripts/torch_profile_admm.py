"""Where the time of the port's QP-ADMM path goes, on one CUDA device.

Runs QP-ADMM (optimalH, -3 dB, the sweep app's configuration: batch 1024,
streamed, alpha 1.2, mu 0.55, ``max_iter`` 10,000) through
``run_experiment`` once to warm up (kernel build included), then once more
under ``torch.profiler``, and prints: the wall time and device-busy time of
the profiled run and the idle share; the iteration kernel's share of
device time and its launches; the host reads (device-to-host copies, each
of which waits for the stream); and the kernels ranked by device time. The
Chrome trace goes to ``build/torch_admm_trace.json`` (gitignored).

    python -m scripts.torch_profile_admm [--trials 2048]
"""
from __future__ import annotations

import argparse
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile

from ldpc_tpu_torch import bench
from ldpc_tpu_torch.channel.awgn import gen_random_codewords
from ldpc_tpu_torch.codes.gf2 import gf2_nullspace
from ldpc_tpu_torch.codes.io import read_pcm
from ldpc_tpu_torch.config import SweepConfig
from ldpc_tpu_torch.decoders import make_decoder
from ldpc_tpu_torch.harness.experiment import run_experiment
from ldpc_tpu_torch.ops import admm_kernel
from scripts.torch_profile_alp import _union_us

TRACE = "build/torch_admm_trace.json"
SNR = -3.0
BATCH = 1024


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--trials", type=int, default=2 * BATCH)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda")
    seed = SweepConfig().seed
    h = read_pcm(str(bench.MATRIX))
    g, _ = gf2_nullspace(h)
    cw = gen_random_codewords(g, args.trials,
                              torch.Generator().manual_seed(seed), dev)
    dec = make_decoder("qp-admm", h, device=dev)

    def run():
        return run_experiment(dec, h, cw, SNR, seed + 1, batch_size=BATCH,
                              device=dev, warmup=False)

    run()
    torch.cuda.synchronize()
    launches = admm_kernel.ITERATE_LAUNCHES
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = run()
        wall = time.perf_counter() - t0
    launches = admm_kernel.ITERATE_LAUNCHES - launches
    cuda = torch.autograd.DeviceType.CUDA
    dev_events = [e for e in prof.events() if e.device_type == cuda]
    busy_us = _union_us([(e.time_range.start, e.time_range.end)
                         for e in dev_events])
    kern_us = sum(e.time_range.elapsed_us() for e in dev_events
                  if "admm_iterate_kernel" in e.name)
    d2h = sum(1 for e in dev_events if "DtoH" in e.name)
    per = res.total / BATCH
    print(f"device: {bench.card_stamp(dev)}")
    print(f"profiled run: QP-ADMM optimalH {SNR} dB, {res.total} trials on "
          f"{BATCH} lanes, streamed, FER {res.fer:.4f}, mean iterations "
          f"{res.sum_iterations / res.total:.1f}; wall {wall * 1e3:.3f} ms "
          f"(profiler on), device busy {busy_us / 1e3:.3f} ms, idle share "
          f"{1.0 - busy_us / 1e6 / wall:.4f}")
    print(f"admm_iterate_kernel: {kern_us / 1e3:.3f} ms over {launches} "
          f"launches, {kern_us / busy_us:.4f} of device busy time; device "
          f"events {len(dev_events)} ({len(dev_events) / per:.1f} per "
          f"{BATCH} trials); host reads (device-to-host copies) {d2h} "
          f"({d2h / per:.1f} per {BATCH} trials)")
    print(prof.key_averages().table(sort_by="self_device_time_total",
                                    row_limit=20, max_name_column_width=60))
    os.makedirs(os.path.dirname(TRACE), exist_ok=True)
    prof.export_chrome_trace(TRACE)


if __name__ == "__main__":
    main()
