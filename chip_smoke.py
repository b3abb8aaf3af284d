#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``ldpc_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. Phases, each
printing one line before the next starts:

1. device check: exits non-zero when ``torch.cuda.is_available()`` is false;
   prints the card, torch, CUDA and nvcc versions;
2. kernel build: compiles ``ldpc_tpu_torch/csrc/*.cu`` with nvcc and prints
   the seconds it took;
3. kernel vs its plain PyTorch twin on the card: the fused BP kernel and
   ``ops.bp_ref`` decode the same 8192 optimalH LLRs at -3 and at 0 dB
   (100 iterations). Bound: success flag and iteration count agree on at
   least 99.5 % of lanes, and the bits agree exactly on every lane where
   both succeeded at the same iteration; the only allowed source of
   disagreement is the order of float32 sums and the math library's
   log/tanh. Times each with CUDA events (3 repeats after a warm-up);
4. main path at full size: ``ldpc_tpu_torch.bench.main()`` (65,536 trials,
   batch 8192, -3 dB, 100 and 50 iterations) with the kernel's launch count
   reset before and read after; the FER must lie within |z| < 3.5 of the
   reference's 0.4860 (10,000 trials).

Then it prints the kernels' JSON line, the card's ``name, power.limit`` line
and, last, ``{"ok": true, "device": {...}}``. Any failed phase raises and
exits non-zero before that line. Imports nothing of JAX.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

SNRS = (-3.0, 0.0)
LANES = 8192
MAX_ITER = 100
AGREE_MIN = 0.995
REPEATS = 3


def _time_ms(fn, repeats: int = REPEATS) -> float:
    """Mean ms per call of ``fn`` on the current stream, after a warm-up."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(repeats):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / repeats


def phase_device():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs an "
              "NVIDIA GPU", file=sys.stderr)
        sys.exit(1)
    from ldpc_tpu_torch.bench import card_stamp
    from ldpc_tpu_torch.ops import _build
    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout
    print(f"[1 device] {card_stamp(torch.device('cuda', 0))} | torch "
          f"{torch.__version__} | CUDA {torch.version.cuda} | "
          f"{nvcc.strip().splitlines()[-1]} | {torch.cuda.device_count()} "
          f"device(s)", flush=True)


def phase_build():
    from ldpc_tpu_torch.ops import _build
    t0 = time.perf_counter()
    log = _build.build(force=True)
    _build.load()
    secs = time.perf_counter() - t0
    usage = " ".join(line.split("ptxas info    : ")[-1].strip()
                     for line in log.splitlines() if "Used" in line)
    print(f"[2 build] {_build.LIB_PATH.name} built in {secs:.2f} s ({usage})",
          flush=True)


def phase_kernel_vs_ref():
    import torch
    from ldpc_tpu_torch import bench
    from ldpc_tpu_torch.channel.awgn import channel_llr, gen_random_codewords
    from ldpc_tpu_torch.codes.gf2 import gf2_nullspace, is_codeword
    from ldpc_tpu_torch.codes.io import read_pcm
    from ldpc_tpu_torch.decoders.bp import BPDecoder
    from ldpc_tpu_torch.ops import bp_kernel
    from ldpc_tpu_torch.ops.bp_ref import bp_decode_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    h = read_pcm(str(bench.MATRIX))
    g, _ = gf2_nullspace(h)
    h_dev = torch.as_tensor(h, device=dev)
    dec = BPDecoder(h, max_iter=MAX_ITER, device=dev)
    cw = gen_random_codewords(g, LANES, torch.Generator().manual_seed(7), dev)
    trials = torch.arange(LANES, device=dev)
    rows = {}
    for snr in SNRS:
        _, llr = channel_llr(cw, snr, 11, trials)

        def kernel():
            return bp_kernel.bp_decode(llr, dec.row_col, dec.col_from_row,
                                       MAX_ITER)

        def ref():
            return bp_decode_ref(llr, dec.row_col, dec.row_mask, dec.col_mask,
                                 dec.row_from_col, dec.col_from_row, MAX_ITER)

        kb, ks, ki = kernel()
        r = ref()
        torch.cuda.synchronize()
        same = (ks == r.success) & (ki == r.iterations)
        agree = same.float().mean().item()
        both = same & ks
        bit_err = int((kb[both].int() - r.bits[both].int()).abs().max()) \
            if bool(both.any()) else 0

        def fer(bits, ok):
            good = ok & is_codeword(h_dev, bits) & (bits == cw).all(dim=-1)
            return 1.0 - good.float().mean().item()

        fer_k, fer_r = fer(kb, ks), fer(r.bits, r.success)
        ms, plain_ms = _time_ms(kernel), _time_ms(ref)
        print(f"[3 kernel-vs-ref] SNR {snr:+.1f} dB, {LANES} lanes: "
              f"{int((~same).sum())} lanes differ in success/iterations "
              f"(agree {agree:.6f}, bound {AGREE_MIN}); max |bits diff| on "
              f"agreeing successful lanes {bit_err}; FER kernel {fer_k:.4f} "
              f"ref {fer_r:.4f}; kernel {ms:.3f} ms, bp_ref {plain_ms:.3f} ms "
              f"per {LANES}-lane decode", flush=True)
        if agree < AGREE_MIN or bit_err != 0:
            raise AssertionError(f"kernel disagrees with bp_ref at SNR {snr}")
        rows[snr] = {"max_abs_err": bit_err, "ms": ms, "plain_ms": plain_ms,
                     "lanes_differ": int((~same).sum())}
    return rows


def phase_main_path():
    from ldpc_tpu_torch import bench
    from ldpc_tpu_torch.harness.reference_data import Z_BOUND, z_score
    from ldpc_tpu_torch.ops import bp_kernel

    bp_kernel.LAUNCHES = 0
    out = bench.main()
    launches = bp_kernel.LAUNCHES
    extra = out["extra"]
    z = z_score(extra["fer_100it"], extra["trials"], bench.FER_REF_100IT)
    print(f"[4 main path] {out['value']} cw/s at 100 it, {extra['cws_50it']} "
          f"cw/s at 50 it; FER {extra['fer_100it']} (z = {z:+.2f} against "
          f"{bench.FER_REF_100IT}), FER@50it {extra['fer_50it']}; "
          f"bp_decode launches {launches}", flush=True)
    if launches <= 0 or extra["bp_kernel_launches"] <= 0:
        raise AssertionError("the main path did not launch the BP kernel")
    if not abs(z) < Z_BOUND:
        raise AssertionError(f"FER {extra['fer_100it']} is {z:+.2f} sigma "
                             f"from the reference")
    if not (0.0 < out["value"] < float("inf") and extra["trials"] > 0):
        raise AssertionError(f"bad throughput {out['value']}")
    return launches


def main() -> int:
    phase_device()
    import torch
    from ldpc_tpu_torch.bench import card_stamp
    phase_build()
    rows = phase_kernel_vs_ref()
    launches = phase_main_path()
    head = rows[-3.0]
    kernels = [{
        "name": "bp_decode",
        "route": "cuda",
        "source": "ldpc_tpu_torch/csrc/bp_decode.cu",
        "replaces": "ldpc_tpu/ops/pallas/bp_kernel.py:43",
        "launches": launches,
        "max_abs_err": head["max_abs_err"],
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "lanes_differ": head["lanes_differ"],
        "shape": f"{LANES}x280 f32 llr, optimalH, {MAX_ITER} it, SNR -3 dB",
    }]
    print(json.dumps({"kernels": kernels}))
    print(card_stamp(torch.device("cuda", 0)))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
