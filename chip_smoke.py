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
   test);
7. the AGC-ALP path's four kernels against their plain twins on the card,
   at AGC-ALP's shapes (128 lanes, optimalH, capacity 1408 x 280):
   the GF(2) elimination on an AGC-ALP batch's IPM solution after three
   cut rounds, a third of the lanes inactive (active lanes bit-identical,
   inactive lanes passed through); A x and A^T y on row slices of a
   (128, 1408, 280) buffer at T = 128 and 1408, and the normal matrix at
   T = 1152 and 1408 with d over 1e-8...1e8 as late in a Newton step
   (bound: the float32 summation bound T * 2**-23 * sum |terms| per entry,
   the products being exact for +-1/0 rows); the diagonal-block Cholesky on
   128 SPD 64 x 64 blocks and one that is not (within 1e-4 of the twin's
   scale, NaN in that lane only); and the whole blocked factor and solve
   on the batch's last normal matrix (its residual at most 10x that of
   ``cholesky_ex`` + ``cholesky_solve`` plus 1e-3 of |r|, the rule of
   ``tests/test_chol.py``). Times each with CUDA events;
8. AGC-ALP path at full width: ``run_sweep`` with decoders ``agc-alp``,
   -3 dB, 512 trials in batches of 128 (optimalH, ``max_rows`` 1000,
   capacity 1408, the IPM), CSVs under ``build/``, with the four kernels'
   launch counts reset before and read after. Gates: FER within |z| < 3.5
   of the reference's 0.8704, no cut dropped, every kernel launched. Then
   the same 128 lanes decoded with the kernel backends and with the plain
   ones (``ipm_matvec_backend``/``ipm_factor_backend``/``gauss_backend``
   ``"xla"``): success agrees on >= 95 % of lanes (the IPM's stop tests
   read float32 errors summed in another order).

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
# phases 7 and 8: the AGC-ALP path (DEFAULT_BATCH["agc-alp"], capacity)
AGC_LANES = 128
AGC_SNR = -3.0
AGC_TRIALS = 512
AGC_CAP = 1408
GEMV_TIERS = (128, 1408)
NORMAL_TIERS = (1152, 1408)
EPS32 = 2.0 ** -23
CHOL_TOL = 1e-4
AGC_AGREE_MIN = 0.95


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


# the AGC-ALP path's kernels: (wrapper module, its launch counter)
AGC_COUNTERS = {"gf2_eliminate": ("gauss_kernel", "LAUNCHES"),
                "gemv_fwd": ("gemv_kernel", "GEMV_LAUNCHES"),
                "gemv_tr": ("gemv_kernel", "GEMV_T_LAUNCHES"),
                "normal_build": ("gemv_kernel", "NORMAL_LAUNCHES"),
                "chol_diag_inv": ("chol_kernel", "LAUNCHES")}


def _agc_counts(reset: bool = False) -> dict:
    """Each AGC-ALP kernel's launch count; with ``reset``, set them to 0."""
    import importlib
    out = {}
    for name, (module, counter) in AGC_COUNTERS.items():
        mod = importlib.import_module(f"ldpc_tpu_torch.ops.{module}")
        if reset:
            setattr(mod, counter, 0)
        out[name] = getattr(mod, counter)
    return out


def _bounded(got, want, bound):
    """Max |got - want| and whether every entry is within ``bound``."""
    diff = (got - want).abs()
    return float(diff.max()), bool((diff <= bound).all())


def _agc_batch(h, g, rounds):
    """An AGC-ALP batch (128 optimalH lanes at -3 dB, kernels on) after
    ``rounds`` cut rounds, and the normal matrix of the first Newton step
    of its last solve (later steps' matrices grow so ill-conditioned that
    float32 Cholesky breaks down on some lanes, which the IPM freezes)."""
    import torch
    from ldpc_tpu_torch.decoders.agc_alp import AGCALPDecoder
    from ldpc_tpu_torch.ops import ipm_solver
    dec = AGCALPDecoder(h, device=torch.device("cuda"))
    dec.ipm_factor_backend = "blocked"      # what "auto" picks on CUDA
    st = dec._init_state(_alp_llrs(g, AGC_LANES, 41))
    seen = []
    factor = ipm_solver.blocked_cholesky

    def record(m, *args, **kwargs):
        seen.append(m)
        return factor(m, *args, **kwargs)

    ipm_solver.blocked_cholesky = record
    try:
        for _ in range(rounds):
            seen.clear()
            st = dec._round_body(st)
    finally:
        ipm_solver.blocked_cholesky = factor
    return dec, st, seen[0]


def phase_agc_kernels_vs_ref():
    import torch
    from ldpc_tpu_torch import bench
    from ldpc_tpu_torch.codes.gf2 import gf2_nullspace
    from ldpc_tpu_torch.codes.io import read_pcm
    from ldpc_tpu_torch.ops.chol import blocked_cho_solve, blocked_cholesky
    from ldpc_tpu_torch.ops.chol_kernel import chol_diag_inv
    from ldpc_tpu_torch.ops.chol_ref import chol_diag_inv_ref, cholesky_nan
    from ldpc_tpu_torch.ops.gauss_kernel import gf2_eliminate
    from ldpc_tpu_torch.ops.gemv_kernel import (batched_gemv, batched_gemv_t,
                                                normal_build)
    from ldpc_tpu_torch.ops.gemv_ref import gemv_ref, gemv_t_ref, normal_ref
    from ldpc_tpu_torch.ops.gf2_gauss import (fractional_column_order,
                                              gf2_eliminate_ordered)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    h = read_pcm(str(bench.MATRIX))
    g, _ = gf2_nullspace(h)
    m_rows, n = h.shape
    rows = {}

    def report(name, label, err, ok, kernel, ref, shape):
        ms, plain_ms = _time_ms(kernel), _time_ms(ref)
        print(f"[7 agc-kernels] {name}, {label}: max |diff| {err:.3e}, "
              f"within bound: {ok}; kernel {ms:.3f} ms, twin {plain_ms:.3f} "
              f"ms", flush=True)
        if not ok:
            raise AssertionError(f"{name} disagrees with its twin ({label})")
        rows.setdefault(name, []).append({"max_abs_err": err, "ms": ms,
                                          "plain_ms": plain_ms,
                                          "shape": shape})

    # the GF(2) elimination on a real IPM solution
    dec, st, m_real = _agc_batch(h, g, 3)
    u = st["x"]
    frac = ((u >= dec.gauss_eps) & (u <= 1.0 - dec.gauss_eps)).sum(dim=1)
    p = fractional_column_order(u, dec.gauss_eps)
    idx = p[:, None, :].expand(AGC_LANES, m_rows, n)
    h_perm = dec.h.expand(AGC_LANES, m_rows, n).gather(2, idx).contiguous()
    active = torch.arange(AGC_LANES, device=dev) % 3 != 0

    def gauss():
        return gf2_eliminate(h_perm, active)

    def gauss_ref():
        return gf2_eliminate_ordered(h_perm)

    got, want = gauss(), gauss_ref()
    torch.cuda.synchronize()
    bad = int((got[active] != want[active]).sum())
    through = torch.equal(got[~active], h_perm[~active])
    report("gf2_eliminate",
           f"{AGC_LANES}x{m_rows}x{n} after 3 rounds (fractional columns "
           f"per lane {frac.float().mean().item():.1f}), {bad} entries "
           f"differ on {int(active.sum())} active lanes, "
           f"{int((~active).sum())} inactive lanes passed through: {through}",
           float(bad), bad == 0 and through, gauss, gauss_ref,
           f"{AGC_LANES}x{m_rows}x{n} uint8, optimalH, IPM solution after 3 "
           f"cut rounds at -3 dB, a third of the lanes inactive")

    # A x, A^T y and the normal matrix on row slices of a full buffer
    gen = torch.Generator(device=dev).manual_seed(13)
    a_buf = torch.randint(-1, 2, (AGC_LANES, AGC_CAP, n), generator=gen,
                          device=dev).float()
    x = torch.rand((AGC_LANES, n), generator=gen, device=dev)
    for t in GEMV_TIERS:
        a = a_buf[:, :t]
        y = torch.rand((AGC_LANES, t), generator=gen, device=dev)
        shape = (f"{AGC_LANES}x{t}x{n} f32 row slice of a {AGC_LANES}x"
                 f"{AGC_CAP}x{n} buffer")
        err, ok = _bounded(batched_gemv(a, x), gemv_ref(a, x),
                           t * EPS32 * gemv_ref(a.abs(), x))
        report("gemv_fwd", f"T = {t}", err, ok,
               lambda: batched_gemv(a, x), lambda: gemv_ref(a, x), shape)
        err, ok = _bounded(batched_gemv_t(a, y), gemv_t_ref(a, y),
                           t * EPS32 * gemv_t_ref(a.abs(), y))
        report("gemv_tr", f"T = {t}", err, ok,
               lambda: batched_gemv_t(a, y), lambda: gemv_t_ref(a, y), shape)
    for t in NORMAL_TIERS:
        a = a_buf[:, :t]
        d = 10.0 ** (torch.rand((AGC_LANES, t), generator=gen, device=dev)
                     * 16.0 - 8.0)
        dxx = 10.0 ** (torch.rand((AGC_LANES, n), generator=gen, device=dev)
                       * 8.0 - 4.0)
        err, ok = _bounded(normal_build(a, d, dxx, 1e-6),
                           normal_ref(a, d, dxx, 1e-6),
                           t * EPS32 * normal_ref(a.abs(), d, dxx, 1e-6))
        report("normal_build", f"T = {t}, d over 1e-8..1e8", err, ok,
               lambda: normal_build(a, d, dxx, 1e-6),
               lambda: normal_ref(a, d, dxx, 1e-6),
               f"{AGC_LANES}x{t}x{n} f32 row slice -> {AGC_LANES}x{n}x{n}, "
               f"d over 1e-8..1e8")

    # the diagonal block: 128 SPD 64 x 64 blocks and one that is not
    nb = 64
    z = torch.randn((AGC_LANES + 1, nb, nb), generator=gen, device=dev)
    blocks = z @ z.transpose(1, 2) / nb + torch.eye(nb, device=dev)
    blocks[AGC_LANES // 2] = -torch.eye(nb, device=dev)
    good = torch.ones(AGC_LANES + 1, dtype=torch.bool, device=dev)
    good[AGC_LANES // 2] = False
    (lk, vk), (lr, vr) = chol_diag_inv(blocks), chol_diag_inv_ref(blocks)
    torch.cuda.synchronize()
    scale = max(float(lr[good].abs().max()), float(vr[good].abs().max()))
    err = max(float((lk - lr)[good].abs().max()),
              float((vk - vr)[good].abs().max()))
    nan_only = (bool(torch.isnan(lk[~good]).any())
                and bool(lk[good].isfinite().all())
                and bool(vk[good].isfinite().all()))
    report("chol_diag_inv",
           f"{AGC_LANES + 1}x{nb}x{nb}, NaN in the non-SPD lane only: "
           f"{nan_only}", err, err <= CHOL_TOL * scale and nan_only,
           lambda: chol_diag_inv(blocks), lambda: chol_diag_inv_ref(blocks),
           f"{AGC_LANES + 1}x{nb}x{nb} f32 (one lane not SPD)")

    # the whole blocked factor and solve on a real normal matrix
    r = torch.randn((AGC_LANES, n), generator=gen, device=dev)

    def blocked():
        return blocked_cho_solve(blocked_cholesky(m_real), r)

    def plain():
        return torch.cholesky_solve(r[..., None],
                                    cholesky_nan(m_real))[..., 0]

    xb, xp = blocked(), plain()
    torch.cuda.synchronize()
    fin_b, fin_p = xb.isfinite().all(dim=1), xp.isfinite().all(dim=1)
    both = fin_b & fin_p
    one_only = int((fin_b != fin_p).sum())

    def resid(v):
        return float((torch.bmm(m_real[both], v[both][..., None])[..., 0]
                      - r[both]).abs().max())

    rb, rp = resid(xb), resid(xp)
    rel = float((xb - xp)[both].abs().max()) / float(xp[both].abs().max())
    ms, plain_ms = _time_ms(blocked), _time_ms(plain)
    r_max = float(r.abs().max())
    diag = m_real.diagonal(dim1=1, dim2=2)
    print(f"[7 agc-kernels] blocked factor + solve on the batch's normal "
          f"matrix {tuple(m_real.shape)} (diagonal {float(diag.min()):.3e}"
          f"..{float(diag.max()):.3e}): residual {rb:.3e} vs cholesky_ex + "
          f"cholesky_solve {rp:.3e} on the {int(both.sum())} lanes both "
          f"factor (bound 10x + 1e-3 |r|), max |dx| / max |x| {rel:.3e}; "
          f"lanes broken down: blocked {int((~fin_b).sum())}, plain "
          f"{int((~fin_p).sum())}, in one only {one_only} (bound "
          f"{int((1.0 - AGC_AGREE_MIN) * AGC_LANES)}); blocked {ms:.3f} ms, "
          f"plain {plain_ms:.3f} ms", flush=True)
    if not (rb <= 10.0 * rp + 1e-3 * r_max
            and one_only <= (1.0 - AGC_AGREE_MIN) * AGC_LANES
            and int(both.sum()) >= AGC_AGREE_MIN * AGC_LANES):
        raise AssertionError("blocked factor + solve disagrees with "
                             "cholesky_ex + cholesky_solve")
    return rows


def phase_agc_path():
    import torch
    from ldpc_tpu_torch import bench
    from ldpc_tpu_torch.apps.benchmark import run_sweep
    from ldpc_tpu_torch.codes.gf2 import gf2_nullspace
    from ldpc_tpu_torch.codes.io import read_pcm
    from ldpc_tpu_torch.config import SweepConfig
    from ldpc_tpu_torch.decoders import default_batch
    from ldpc_tpu_torch.decoders.agc_alp import AGCALPDecoder
    from ldpc_tpu_torch.harness.reference_data import (REF_FER_OPT, SNR_GRID,
                                                       Z_BOUND, z_score)

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    fer_ref = REF_FER_OPT["AGC-ALP"][SNR_GRID.index(AGC_SNR)]
    cfg = SweepConfig(matrix=str(bench.MATRIX), decoders=("agc-alp",),
                      snrs=(AGC_SNR,), trials=AGC_TRIALS,
                      report="build/chip_smoke_agc.csv",
                      extended_report="build/chip_smoke_agc_extended.csv")
    os.makedirs("build", exist_ok=True)
    _agc_counts(reset=True)
    t0 = time.perf_counter()
    rows = run_sweep(cfg, device=dev)
    secs = time.perf_counter() - t0
    launches = _agc_counts()
    res = rows[0][2]
    z = z_score(res.fer, res.total, fer_ref)
    print(f"[8 agc path] run_sweep agc-alp {AGC_SNR} dB, {res.total} trials "
          f"in batches of {default_batch('agc-alp')}: {res.throughput:.2f} "
          f"cw/s, FER {res.fer:.4f} (z = {z:+.2f} against {fer_ref}), "
          f"average rounds {res.sum_iterations / res.total:.3f}, dropped "
          f"{res.sum_dropped}, launches {launches}, {secs:.2f} s with "
          f"warm-up", flush=True)
    if min(launches.values()) <= 0:
        raise AssertionError(f"the AGC-ALP path did not launch every kernel: "
                             f"{launches}")
    if not abs(z) < Z_BOUND or res.total < AGC_TRIALS:
        raise AssertionError(f"AGC-ALP FER {res.fer} is {z:+.2f} sigma from "
                             f"the reference")
    if res.sum_dropped != 0:
        raise AssertionError(f"AGC-ALP dropped {res.sum_dropped} cuts")
    if not 0.0 < res.throughput < float("inf"):
        raise AssertionError(f"bad throughput {res.throughput}")

    h = read_pcm(str(bench.MATRIX))
    g, _ = gf2_nullspace(h)
    llr = _alp_llrs(g, AGC_LANES, 43)
    out = {}
    for backend in ("kernel", "plain"):
        if backend == "kernel":
            dec = AGCALPDecoder(h, device=dev)
        else:
            dec = AGCALPDecoder(h, gauss_backend="xla", device=dev)
            dec.ipm_matvec_backend = dec.ipm_factor_backend = "xla"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = dec._run_loop(llr)
        out[backend] = (dec._finish(st), st)
        torch.cuda.synchronize()
        out[backend + "_s"] = time.perf_counter() - t0
    (k, kst), (p, pst) = out["kernel"], out["plain"]
    same = k.success == p.success
    agree = same.float().mean().item()
    both = k.success & p.success
    bit_diff = int((k.bits[both] != p.bits[both]).any(dim=-1).sum())

    def mean(v):
        return v.float().mean().item()

    print(f"[8 agc path] {AGC_LANES} lanes, kernel vs plain backends: success "
          f"agrees on {int(same.sum())} ({agree:.4f}, bound "
          f"{AGC_AGREE_MIN}); successes {int(k.success.sum())} / "
          f"{int(p.success.sum())}; lanes successful in both with other bits "
          f"{bit_diff} of {int(both.sum())}; mean rounds "
          f"{mean(kst['rounds']):.3f} / {mean(pst['rounds']):.3f}; mean "
          f"cum_h {mean(kst['cum_h']):.3f} / {mean(pst['cum_h']):.3f}, "
          f"cum_g {mean(kst['cum_g']):.3f} / {mean(pst['cum_g']):.3f} per "
          f"lane; dropped {int(kst['dropped'].sum())} / "
          f"{int(pst['dropped'].sum())}; decode {out['kernel_s']:.3f} s / "
          f"{out['plain_s']:.3f} s", flush=True)
    if agree < AGC_AGREE_MIN:
        raise AssertionError("AGC-ALP kernel and plain backends disagree")
    return launches


def _worst_and_last(rows):
    """One JSON row from per-shape rows: the largest error, the times and
    shape of the last (deepest) shape."""
    last = dict(rows[-1])
    last["max_abs_err"] = max(r["max_abs_err"] for r in rows)
    return last


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
    agc_rows = _timed("7 agc-kernels", phase_agc_kernels_vs_ref)
    agc_launches = _timed("8 agc path", phase_agc_path)
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
    # each new kernel: its largest error over the shapes checked, its time
    # at the deepest shape checked
    for name, src, replaces in (
            ("gf2_eliminate", "gf2_gauss.cu",
             "ldpc_tpu/ops/pallas/gauss_kernel.py:64"),
            ("gemv_fwd", "gemv.cu", "ldpc_tpu/ops/pallas/gemv_kernel.py:79"),
            ("gemv_tr", "gemv.cu", "ldpc_tpu/ops/pallas/gemv_kernel.py:87"),
            ("normal_build", "normal_build.cu",
             "ldpc_tpu/ops/pallas/gemv_kernel.py:142"),
            ("chol_diag_inv", "chol_diag_inv.cu",
             "ldpc_tpu/ops/pallas/chol_kernel.py:45")):
        row = _worst_and_last(agc_rows[name])
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"ldpc_tpu_torch/csrc/{src}", "replaces": replaces,
            "launches": agc_launches[name],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "shape": row["shape"]})
    print(f"[total] {time.perf_counter() - t_start:.2f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card_stamp(torch.device("cuda", 0)))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
