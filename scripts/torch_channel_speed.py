"""The channel kernel (``csrc/awgn_channel.cu``) on one CUDA device: bit
for bit with its twin, and its time against the twin's and its bound.

At each of ``SHAPES`` (BP's 8192 lanes and ALP's 256 at optimalH's n =
280, an odd n, H02's 640) the inputs are codeword bits gathered from a
table and trial indices past 2**32 in a strided view, from a seed; the
kernel (``ops.channel_kernel.awgn_channel``) is held to the plain twin
(``channel.awgn.channel_ref`` on the same CUDA tensors) in y, the LLRs and
the hard-decision count, then timed warm by CUDA events: ``CALLS``
launches captured in a CUDA graph and replayed ``REPLAYS`` times, the
median over ``ROUNDS`` graphs (device time without the host's gaps; the
outputs, 18 MB at 8192 x 280, stay in the 50 MB L2 as the decoder then
reads them). The twin is timed the same way over ``TWIN_CALLS`` calls, and
its device launches a call are counted by ``torch.profiler``; the host's
us a call of both, enqueued back to back, stand beside. The bound is the
larger of the bytes (bits and trial indices in, y, the LLRs and the count
out) over 3.35 TB/s and the float64 instructions (each static FP64
instruction of the kernel's SASS, ``cuobjdump``, once a pair: an upper
count, since the slow paths of sin and cos are never taken here) over the
card's 16.7 T FP64 instructions a second (132 SMs x 64 lanes x 1.98 GHz).
Exits non-zero when the kernel differs from its twin. The last line is
one JSON object with every figure and the card (``nvidia-smi``'s name and
power limit).

    python -m scripts.torch_channel_speed
"""
from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import time

import torch

from ldpc_tpu_torch import bench
from ldpc_tpu_torch.channel import awgn
from ldpc_tpu_torch.ops import _build, channel_kernel

SHAPES = ((8192, 280), (256, 280), (8192, 281), (8192, 640))
CALLS = 20
TWIN_CALLS = 2
REPLAYS = 10
ROUNDS = 5
HBM_BYTES_PER_S = 3.35e12
FP64_INSTR_PER_S = 132 * 64 * 1.98e9
SEED = 2**31 + 7


def _inputs(bsz, n):
    gen = torch.Generator(device="cuda").manual_seed(bsz * 1000 + n)
    table = torch.randint(0, 2, (bsz + 5, n), generator=gen, device="cuda",
                          dtype=torch.uint8)
    rows = torch.randperm(bsz + 5, generator=gen, device="cuda")[:bsz]
    trials = (2**32 + 11 + 3 * torch.arange(2 * bsz, device="cuda"))
    return table.index_select(0, rows), trials.flip(0)[::2]


def _graph_ms(fn, calls):
    """(median, min, max) device ms a call: ``calls`` calls captured in a
    CUDA graph, replayed ``REPLAYS`` times, over ``ROUNDS`` graphs."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(ROUNDS):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(calls):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPLAYS):
            graph.replay()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / (REPLAYS * calls))
    return statistics.median(times), min(times), max(times)


def _host_us(fn, calls=200):
    """Host us a call, enqueued back to back (the card keeps up)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return host


def _device_launches(fn) -> int:
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    return sum(1 for e in prof.events() if e.device_type == cuda
               and not getattr(e, "is_user_annotation", False))


def _fp64_instructions():
    """(FP64 instructions, all instructions) in the kernel's SASS, or
    None without ``cuobjdump``."""
    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    if not os.path.isfile(tool):
        return None
    sass = subprocess.run([tool, "-sass", str(_build.LIB_PATH)],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    inside, fp64, total = False, 0, 0
    for line in sass.splitlines():
        if "Function :" in line:
            inside = "awgn_channel_kernel" in line
        elif inside:
            op = re.search(r"\*/\s+(?:@!?P\w+\s+)?([A-Z][A-Z0-9.]*)", line)
            if op:
                total += 1
                name = op.group(1)
                fp64 += name.split(".")[0] in (
                    "DFMA", "DADD", "DMUL", "DSETP", "DMNMX") or (
                    "F64" in name)
    return fp64, total


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_channel_speed: no CUDA device", file=sys.stderr)
        return 3
    dev = torch.device("cuda")
    _build.load()
    sass = _fp64_instructions()
    rows, ok = [], True
    for bsz, n in SHAPES:
        bits, trials = _inputs(bsz, n)
        sigma, scale = awgn.noise_scales(-3.0)
        key = awgn.noise_key(SEED)
        got = channel_kernel.awgn_channel(bits, trials, key, sigma, scale)
        want = awgn.channel_ref(bits, trials, SEED, sigma, scale)
        differ = {k: int((a != b).sum()) for k, a, b in
                  zip(("y", "llr", "hd"), got, want)}
        ok = ok and not any(differ.values())

        def run_kernel():
            return channel_kernel.awgn_channel(bits, trials, key, sigma,
                                               scale)

        def run_twin():
            return awgn.channel_ref(bits, trials, SEED, sigma, scale)

        kernel = _graph_ms(run_kernel, CALLS)
        twin = _graph_ms(run_twin, TWIN_CALLS)
        pairs = bsz * ((n + 1) // 2)
        bytes_ms = (bsz * n * (1 + 8) + bsz * 16) / HBM_BYTES_PER_S * 1e3
        fp64_ms = (None if sass is None
                   else sass[0] * pairs / FP64_INSTR_PER_S * 1e3)
        bound = max(bytes_ms, fp64_ms or 0.0)
        row = {"lanes": bsz, "n": n, "differ": differ,
               "kernel_ms": kernel, "twin_ms": twin,
               "twin_launches": _device_launches(run_twin),
               "host_us": _host_us(run_kernel),
               "twin_host_us": _host_us(run_twin, 20),
               "bytes_ms": bytes_ms, "fp64_ms": fp64_ms,
               "bound_ms": bound, "of_bound": bound / kernel[0]}
        rows.append(row)
        print(f"{bsz} x {n}: kernel {kernel[0]:.6f} ms "
              f"({kernel[1]:.6f}-{kernel[2]:.6f}), twin {twin[0]:.4f} ms "
              f"({row['twin_launches']} launches), bound {bound:.6f} ms "
              f"(bytes {bytes_ms:.6f}, fp64 {fp64_ms}), host "
              f"{row['host_us']:.1f} / {row['twin_host_us']:.1f} us a "
              f"call, differ {differ}", flush=True)
    print(json.dumps({"card": bench.card_stamp(dev), "torch":
                      torch.__version__, "cuda": torch.version.cuda,
                      "sass_fp64_total": sass, "ok": ok, "rows": rows}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
