"""Where the time of the port's AGC-ALP path goes, on one CUDA device.

Runs AGC-ALP (optimalH, -3 dB, batches of 128, the sweep app's
configuration) through ``run_experiment`` once to warm up (kernel build
included), then once more under ``torch.profiler``, and prints: the wall
time and device-busy time of the profiled run and the idle share; each of
the path's kernels' share of device time (the GF(2) elimination, the two
matvecs, the normal matrix, the fused Cholesky factor and solve, and the
blocked chain's diagonal block where n is past the fused kernels' limit),
the cuBLAS products and the rest; the device time under each phase of a
cut round (cut search, appends, Gaussian elimination, IPM solve), read
from the spans the program opens while a profiler records; the host reads
per batch
(device-to-host copies, each of which waits for the stream); and the kernels
ranked by device time. The Chrome trace goes to ``build/torch_agc_trace.json``
(gitignored). A 128-lane batch makes about 360,000 launches, so the
device spans are merged once and each range's share is read off the merged
list by bisection.

    python -m scripts.torch_profile_agc [--trials 256]
"""
from __future__ import annotations

import argparse
import bisect
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile

from ldpc_tpu_torch import bench
from ldpc_tpu_torch.channel.awgn import gen_random_codewords
from ldpc_tpu_torch.codes.gf2 import gf2_nullspace
from ldpc_tpu_torch.codes.io import read_pcm
from ldpc_tpu_torch.decoders import agc_alp
from ldpc_tpu_torch.harness.experiment import run_experiment
from scripts.torch_profile_alp import RANGE_NAMES, _device_ops, _union_us

TRACE = "build/torch_agc_trace.json"
SNR = -3.0
BATCH = 128
KERNELS = {"gf2_eliminate": "gf2_gauss_kernel", "gemv_fwd": "gemv_fwd_kernel",
           "gemv_tr": "gemv_tr_kernel", "normal_build": "normal_build_kernel",
           "chol_diag_inv": "chol_diag_inv_kernel",
           "chol_factor": "chol_factor_kernel",
           "chol_solve": "chol_solve_kernel"}


def _merge(spans):
    """Sorted disjoint (start, stop) intervals covering ``spans``."""
    out = []
    for start, stop in sorted(spans):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], stop)
        else:
            out.append([start, stop])
    return out


def _covered(merged, starts, lo, hi) -> float:
    """Length of the merged intervals inside [lo, hi]."""
    i = max(bisect.bisect_right(starts, lo) - 1, 0)
    total = 0.0
    while i < len(merged) and merged[i][0] < hi:
        total += max(0.0, min(hi, merged[i][1]) - max(lo, merged[i][0]))
        i += 1
    return total


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--trials", type=int, default=2 * BATCH)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    h = read_pcm(str(bench.MATRIX))
    g, _ = gf2_nullspace(h)
    cw = gen_random_codewords(g, args.trials,
                              torch.Generator().manual_seed(bench.SEED), dev)
    dec = agc_alp.AGCALPDecoder(h, device=dev)

    def run():
        return run_experiment(dec, h, cw, SNR, bench.SEED + 1,
                              batch_size=BATCH, device=dev, warmup=False)

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = run()
        wall = time.perf_counter() - t0
    batches = -(-args.trials // BATCH)
    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    ranges = (*RANGE_NAMES, "agc.gauss")
    dev_events = _device_ops(events)
    merged = _merge((e.time_range.start, e.time_range.end)
                    for e in dev_events)
    starts = [m[0] for m in merged]
    busy_us = sum(stop - start for start, stop in merged)
    print(f"device: {bench.card_stamp(dev)}")
    print(f"profiled run: AGC-ALP optimalH {SNR} dB, {res.total} trials in "
          f"{batches} batches of {BATCH}, FER {res.fer:.4f}, mean rounds "
          f"{res.sum_iterations / res.total:.3f}, dropped {res.sum_dropped}; "
          f"wall {wall * 1e3:.3f} ms (profiler on), device busy "
          f"{busy_us / 1e3:.3f} ms, idle share "
          f"{1.0 - busy_us / 1e6 / wall:.4f}")
    kernel_us = 0.0
    for name, sym in KERNELS.items():
        hits = [e for e in dev_events if sym in e.name]
        us = sum(e.time_range.elapsed_us() for e in hits)
        kernel_us += us
        print(f"{name} ({sym}): {us / 1e3:.3f} ms over {len(hits)} launches "
              f"({len(hits) / batches:.1f} per batch), {us / busy_us:.4f} of "
              f"device busy time")
    blas = [e for e in dev_events if not any(s in e.name
                                             for s in KERNELS.values())
            and any(k in e.name.lower() for k in ("gemm", "gemv", "cublas",
                                                  "cutlass", "potrf", "trsm"))]
    blas_us = sum(e.time_range.elapsed_us() for e in blas)
    print(f"the five kernels: {kernel_us / 1e3:.3f} ms "
          f"({kernel_us / busy_us:.4f}); cuBLAS/cuSOLVER products (bmm glue): "
          f"{blas_us / 1e3:.3f} ms ({blas_us / busy_us:.4f}) over "
          f"{len(blas)} launches; the rest (elementwise, reductions, copies) "
          f"{(busy_us - kernel_us - blas_us) / 1e3:.3f} ms "
          f"({1.0 - (kernel_us + blas_us) / busy_us:.4f})")
    d2h = sum(1 for e in dev_events if "DtoH" in e.name)
    print(f"host reads (device-to-host copies): {d2h} ({d2h / batches:.1f} "
          f"per batch); device launches {len(dev_events)} "
          f"({len(dev_events) / batches:.1f} per batch)")
    for name in ranges:
        marks = [e for e in events if e.name == name]
        host = sum(e.cpu_time_total for e in marks if e.device_type != cuda)
        on_dev = [(e.time_range.start, e.time_range.end) for e in marks
                  if e.device_type == cuda]
        busy_in = sum(_covered(merged, starts, lo, hi) for lo, hi in on_dev)
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
