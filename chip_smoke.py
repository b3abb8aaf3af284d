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
   reference's 0.4860 (10,000 trials);
5. PDHG chunk kernel vs its plain twin ``ops.pdhg_ref`` on the card: random
   signed-row LPs shaped like ``tests/test_pallas_pdhg.py``'s (256 lanes,
   n = 280, T = 128 and 896, 64 steps, ``average`` off and on, a third of
   the lanes inactive), and the real cut buffers of an ALP batch (256
   optimalH lanes at -3 dB) after its third round. Bounds: the JAX
   package's own between its kernel and XLA, |dx| <= 2e-5, |dy| <= 2e-4,
   |d err| <= 1e-5 (float32 sum order only; neither side uses fast math),
   and inactive lanes bit-identical. Times each with CUDA events;
6. ALP path at full width: ``apps.benchmark.run_sweep`` with decoders
   ``alp``, -3 dB, 2,048 trials (batch 256, optimalH, 896 cut rows per
   lane), CSVs under ``build/``, with the PDHG kernel's launch count reset
   before and read after. Gates: FER within |z| < 3.5 of the reference's
   0.9659 and launches > 0. Then the same 256 lanes decoded with
   ``lp_backend="kernel"`` and ``"xla"``: success agrees on >= 95 % of
   lanes (the solvers differ in float order and in their first chunk
   test).

Each phase prints its seconds. Then the script prints the kernels' JSON
line, the card's ``name, power.limit`` line and, last,
``{"ok": true, "device": {...}}``. Any failed phase raises and exits
non-zero before that line. Imports nothing of JAX.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

SNRS = (-3.0, 0.0)
LANES = 8192
MAX_ITER = 100
AGREE_MIN = 0.995
REPEATS = 3
# phases 5 and 6: the ALP path (DEFAULT_BATCH["alp"], lp_iters)
ALP_LANES = 256
ALP_SNR = -3.0
ALP_TRIALS = 2048
PDHG_STEPS = 64
PDHG_TIERS = (128, 896)
X_TOL, Y_TOL, ERR_TOL = 2e-5, 2e-4, 1e-5
ALP_AGREE_MIN = 0.95


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


def _ptxas_usage(log: str) -> str:
    """Registers, spills and shared memory per kernel from ``ptxas -v``."""
    out, name = [], None
    for line in log.splitlines():
        found = re.search(r"entry function '\w*?([a-z][a-z_]*_kernel)"
                          r"(ILb([01])E)?", line)
        if found:
            name = found.group(1) + (
                "" if found.group(2) is None else
                "<true>" if found.group(3) == "1" else "<false>")
        elif name and ("spill" in line or "Used" in line):
            out.append(f"{name}: {line.split(':', 1)[-1].strip()}")
    return "; ".join(out)


def phase_build():
    from ldpc_tpu_torch.ops import _build
    t0 = time.perf_counter()
    log = _build.build(force=True)
    _build.load()
    secs = time.perf_counter() - t0
    print(f"[2 build] {_build.LIB_PATH.name} built in {secs:.2f} s from "
          f"{len(_build._sources())} sources ({_ptxas_usage(log)})",
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


def _pdhg_compare(label, args, active, average):
    """One chunk through the kernel and through the twin on the same
    inputs: checks the bounds, times both, returns a row for the JSON."""
    import torch
    from ldpc_tpu_torch.ops import pdhg_kernel
    from ldpc_tpu_torch.ops.pdhg_ref import pdhg_chunk_ref

    def kernel():
        return pdhg_kernel.pdhg_chunk(*args, PDHG_STEPS, active=active,
                                      average=average)

    def ref():
        return pdhg_chunk_ref(*args, PDHG_STEPS, active=active,
                              average=average)

    (xk, yk, ek), (xr, yr, er) = kernel(), ref()
    torch.cuda.synchronize()
    x0, y0 = args[5], args[6]
    on = active
    dx = float((xk - xr)[on].abs().max())
    dy = float((yk - yr)[on].abs().max())
    de = float((ek - er)[on].abs().max())
    off = ~on
    through = (torch.equal(xk[off], x0[off]) and torch.equal(yk[off], y0[off])
               and bool((ek[off] == 0).all()))
    ms, plain_ms = _time_ms(kernel), _time_ms(ref)
    print(f"[5 pdhg-vs-ref] {label}: |dx| {dx:.3e} (bound {X_TOL}), |dy| "
          f"{dy:.3e} ({Y_TOL}), |d err| {de:.3e} ({ERR_TOL}); "
          f"{int(off.sum())} inactive lanes bit-identical: {through}; "
          f"kernel {ms:.3f} ms, pdhg_ref {plain_ms:.3f} ms per "
          f"{PDHG_STEPS}-step chunk", flush=True)
    if not (dx <= X_TOL and dy <= Y_TOL and de <= ERR_TOL and through):
        raise AssertionError(f"PDHG kernel disagrees with pdhg_ref ({label})")
    return {"max_abs_err": max(dx, dy, de), "ms": ms, "plain_ms": plain_ms}


def _alp_llrs(g, lanes, seed):
    import torch
    from ldpc_tpu_torch.channel.awgn import channel_llr, gen_random_codewords
    dev = torch.device("cuda")
    cw = gen_random_codewords(g, lanes, torch.Generator().manual_seed(seed),
                              dev)
    _, llr = channel_llr(cw, ALP_SNR, seed + 1,
                         torch.arange(lanes, device=dev))
    return llr


def phase_pdhg_vs_ref():
    import torch
    from ldpc_tpu_torch import bench
    from ldpc_tpu_torch.codes.gf2 import gf2_nullspace
    from ldpc_tpu_torch.codes.io import read_pcm
    from ldpc_tpu_torch.decoders.alp import ALPDecoder
    from ldpc_tpu_torch.ops.lp_solver import pdhg_steps

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    n = 280
    inactive = torch.arange(ALP_LANES, device=dev) % 3 == 0
    for t in PDHG_TIERS:
        # random signed rows; rows past 5T/16 zero with rhs 0
        rows = t * 5 // 16
        c = torch.randn((ALP_LANES, n), generator=gen, device=dev)
        a = torch.randint(-1, 2, (ALP_LANES, t, n), generator=gen,
                          device=dev).float()
        a[:, rows:] = 0.0
        b = torch.randn((ALP_LANES, t), generator=gen, device=dev).abs() * 3
        b[:, rows:] = 0.0
        x0 = torch.rand((ALP_LANES, n), generator=gen, device=dev)
        y0 = torch.zeros((ALP_LANES, t), device=dev)
        tau, sigma = pdhg_steps(a)
        for average in (False, True):
            _pdhg_compare(f"random LP {ALP_LANES}x{t}x{n}, average "
                          f"{average}", (c, a, b, tau, sigma, x0, y0),
                          ~inactive, average)
    # the real cut buffers of an ALP batch after its third round
    h = read_pcm(str(bench.MATRIX))
    g, _ = gf2_nullspace(h)
    dec = ALPDecoder(h, device=dev)
    llr = _alp_llrs(g, ALP_LANES, 23)
    st = dec._init_state(llr)
    for _ in range(3):
        st = dec._round_body(st)
    act = ~st["done"]
    r_max = int(torch.where(st["done"], 0, st["count"]).max())
    t = dec._tier(r_max)
    a_t = st["a"][:, :t]                     # the strided slice, as solved
    tau, sigma = pdhg_steps(a_t)
    args = (st["c"], a_t, st["rhs"][:, :t].contiguous(), tau, sigma,
            st["x"], st["y"][:, :t].contiguous())
    label = (f"ALP buffers after round 3, {ALP_LANES}x{t}x{n} (cap "
             f"{dec.capacity}), {int(act.sum())} working lanes, cuts "
             f"{int(st['count'].min())}-{int(st['count'].max())}")
    row = _pdhg_compare(label, args, act, False)
    row["shape"] = (f"{ALP_LANES}x{t}x{n} f32 cut slice (lane stride "
                    f"{dec.capacity}x{n}), {PDHG_STEPS} steps, ALP optimalH "
                    f"-3 dB after round 3")
    return row


def phase_alp_path():
    import torch
    from ldpc_tpu_torch import bench
    from ldpc_tpu_torch.apps.benchmark import run_sweep
    from ldpc_tpu_torch.codes.gf2 import gf2_nullspace
    from ldpc_tpu_torch.codes.io import read_pcm
    from ldpc_tpu_torch.config import SweepConfig
    from ldpc_tpu_torch.decoders import default_batch
    from ldpc_tpu_torch.decoders.alp import ALPDecoder
    from ldpc_tpu_torch.harness.reference_data import (REF_FER_OPT, SNR_GRID,
                                                       Z_BOUND, z_score)
    from ldpc_tpu_torch.ops import pdhg_kernel

    dev = torch.device("cuda")
    fer_ref = REF_FER_OPT["ALP"][SNR_GRID.index(ALP_SNR)]
    cfg = SweepConfig(matrix=str(bench.MATRIX), decoders=("alp",),
                      snrs=(ALP_SNR,), trials=ALP_TRIALS,
                      report="build/chip_smoke_alp.csv",
                      extended_report="build/chip_smoke_alp_extended.csv")
    os.makedirs("build", exist_ok=True)
    pdhg_kernel.LAUNCHES = 0
    t0 = time.perf_counter()
    rows = run_sweep(cfg, device=dev)
    secs = time.perf_counter() - t0
    launches = pdhg_kernel.LAUNCHES
    res = rows[0][2]
    z = z_score(res.fer, res.total, fer_ref)
    print(f"[6 alp path] run_sweep alp {ALP_SNR} dB, {res.total} trials in "
          f"batches of {default_batch('alp')}: {res.throughput:.1f} cw/s, FER "
          f"{res.fer:.4f} (z = {z:+.2f} against {fer_ref}), average rounds "
          f"{res.sum_iterations / res.total:.3f}, dropped "
          f"{res.sum_dropped}, pdhg_chunk launches {launches}, {secs:.2f} s "
          f"with warm-up", flush=True)
    if launches <= 0:
        raise AssertionError("the ALP path did not launch the PDHG kernel")
    if not abs(z) < Z_BOUND or res.total < ALP_TRIALS:
        raise AssertionError(f"ALP FER {res.fer} is {z:+.2f} sigma from the "
                             f"reference")
    if not 0.0 < res.throughput < float("inf"):
        raise AssertionError(f"bad throughput {res.throughput}")

    h = read_pcm(str(bench.MATRIX))
    g, _ = gf2_nullspace(h)
    llr = _alp_llrs(g, ALP_LANES, 31)
    out = {}
    for backend in ("kernel", "xla"):
        dec = ALPDecoder(h, lp_backend=backend, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[backend] = dec.decode_batch(llr)
        torch.cuda.synchronize()
        out[backend + "_s"] = time.perf_counter() - t0
    k, x = out["kernel"], out["xla"]
    same = k.success == x.success
    both = k.success & x.success
    agree = same.float().mean().item()
    bit_diff = int((k.bits[both] != x.bits[both]).any(dim=-1).sum())
    print(f"[6 alp path] {ALP_LANES} lanes, lp_backend kernel vs xla: "
          f"success agrees on {int(same.sum())} ({agree:.4f}, bound "
          f"{ALP_AGREE_MIN}); successes {int(k.success.sum())} / "
          f"{int(x.success.sum())}; lanes successful in both with other "
          f"bits {bit_diff} of {int(both.sum())}; mean rounds "
          f"{k.iterations.float().mean().item():.3f} / "
          f"{x.iterations.float().mean().item():.3f}; decode "
          f"{out['kernel_s']:.3f} s / {out['xla_s']:.3f} s", flush=True)
    if agree < ALP_AGREE_MIN:
        raise AssertionError("ALP kernel and xla backends disagree")
    return launches


def _timed(name, fn):
    t0 = time.perf_counter()
    out = fn()
    print(f"[{name}] {time.perf_counter() - t0:.2f} s", flush=True)
    return out


def main() -> int:
    t_start = time.perf_counter()
    phase_device()
    import torch
    from ldpc_tpu_torch.bench import card_stamp
    _timed("2 build", phase_build)
    rows = _timed("3 kernel-vs-ref", phase_kernel_vs_ref)
    launches = _timed("4 main path", phase_main_path)
    pdhg = _timed("5 pdhg-vs-ref", phase_pdhg_vs_ref)
    pdhg_launches = _timed("6 alp path", phase_alp_path)
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
    }, {
        "name": "pdhg_chunk",
        "route": "cuda",
        "source": "ldpc_tpu_torch/csrc/pdhg_chunk.cu",
        "replaces": "ldpc_tpu/ops/pallas/pdhg_kernel.py:72",
        "launches": pdhg_launches,
        "max_abs_err": pdhg["max_abs_err"],
        "ms": pdhg["ms"],
        "plain_ms": pdhg["plain_ms"],
        "shape": pdhg["shape"],
    }]
    print(f"[total] {time.perf_counter() - t_start:.2f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card_stamp(torch.device("cuda", 0)))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
