"""QP-ADMM's throughput on one CUDA device: the sweep's streamed and batched
runs, the optimizer's population decode and the batch width.

Decodes with the port's public API only (``make_decoder``,
``run_experiment``, ``decode_qp_admm_population``), so that the same
script also times a tree from before the iteration kernel: run it with
that tree's package first on ``PYTHONPATH`` (``PYTHONPATH=<tree> python
<this file>``). On optimalH at -3 dB with the sweep app's seeds (codewords
from 239239239, noise from the next seed), at QP-ADMM's defaults
(alpha 1.2, mu 0.55, ``max_iter`` 10,000):

* ``--trials`` (2,048) trials at ``--batch`` 1024, streamed and batched (the
  order streamed, batched, batched, streamed): cw/s, FER and its z
  against the golden 0.2751, mean iterations, seconds;
* the population decode of the 8 chain incumbents of
  ``data/optimize_state.json`` (caps as the optimizer buckets them) at 256
  trials each, alpha 1.95, mu 0.5: ms per decode at ``max_iter`` 1,000 (a
  full evaluation's decode) and ms per iteration over a 64-iteration
  decode (few lanes stop that early), each by the host clock around a
  synchronised call, the median of three after a warm-up;
* streamed cw/s at each of ``--widths`` (1,024, 2,048 and 4,096 lanes) on
  ``--width-trials`` (8,192) trials;
* the iteration kernel alone (``ops.admm_kernel.admm_iterate`` on packed
  tables, which both trees have): device ms per iteration of one
  ``KERNEL_ITERS``-iteration launch from fresh state with no pair stopping,
  by CUDA events, the median of three after a warm-up, at the sweep's
  ``--batch`` optimalH lanes and at the population's 8 x 256; and at
  ``--batch`` lanes for each of ``TIER_SHAPES``: optimalH padded to caps
  that put it in each of the kernel's tiers, a 640 x 1280 code of row
  weight 6 (``wide_code``, a cascade of 3,200 / 10,240 rows) and H02
  (520 x 640, 72 slots a variable: XLA's windows of 32) at the feasible
  alpha 0.9, mu 0.5 of ``scripts/run_h02_bench.sh``, each beside its
  operation bound (``shapes_bound_ms``: the float32 operations of one
  iteration on the real rows, ``ops.admm_kernel.iteration_work``, over 67
  TFLOP/s).

Runs of one tree must give equal counters at every width and runner;
prints one line per run and exits non-zero when they differ or a FER lies
outside ``Z_BOUND``. The last line is one JSON object with every figure
and the card (``nvidia-smi``'s name and power limit).

    python -m scripts.torch_admm_speed [--trials 2048] [--widths 1024 4096]
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np
import torch

from ldpc_tpu_torch import bench
from ldpc_tpu_torch.apps.optimize_h import TABLES, _caps_for
from ldpc_tpu_torch.channel.awgn import (gen_random_codewords, noise_scales,
                                         transmit)
from ldpc_tpu_torch.codes.gf2 import gf2_nullspace
from ldpc_tpu_torch.codes.io import read_pcm
from ldpc_tpu_torch.codes.qc import QCMatrix
from ldpc_tpu_torch.config import OptimizeConfig, SweepConfig
from ldpc_tpu_torch.decoders import make_decoder
from ldpc_tpu_torch.decoders.admm import (ADMMStructure,
                                          decode_qp_admm_population)
from ldpc_tpu_torch.harness.experiment import COUNTERS, run_experiment
from ldpc_tpu_torch.harness.reference_data import (REF_FER_OPT, SNR_GRID,
                                                   Z_BOUND, z_score)
from ldpc_tpu_torch.ops import admm_kernel

SNR = -3.0
BATCH = 1024
POP_TRIALS = 256
POP_ITERS = 1000
POP_CHUNK = 64
KERNEL_ITERS = 512
F32_OPS_PER_S = 67e12   # the H100 SXM's float32 peak outside the tensor cores
# (label, caps) of the kernel's per-shape times: optimalH at its size and
# padded into the second, third and global tier, the wide code and H02
TIER_SHAPES = (("optimalH", {}),
               ("optimalH@1280/5120/32",
                dict(n_var_cap=1280, n_con_cap=5120, k_max_cap=32)),
               ("optimalH@2048/6144/72",
                dict(n_var_cap=2048, n_con_cap=6144, k_max_cap=72)),
               ("optimalH@9000/10000/24",
                dict(n_var_cap=9000, n_con_cap=10000, k_max_cap=24)),
               ("wide 640x1280", {}), ("H02", {}))
H02_PARAMS = (0.9, 0.5)   # alpha, mu: H02's e_min of 2 fails the defaults


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _host_ms(fn, dev, repeats: int = 3) -> float:
    """Median host ms of a synchronised call of ``fn`` after a warm-up."""
    fn()
    _sync(dev)
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _population(dev, seed, trials):
    """The state file's chain incumbents as one population: stacked tables
    on ``dev``, LLRs (8, trials, n) at -3 dB, the codeword length and the
    caps."""
    with open(bench.MATRIX.parent / "optimize_state.json") as f:
        state = json.load(f)
    hs = [QCMatrix(OptimizeConfig().block_size,
                   np.array(c["present"], bool),
                   np.array(c["shifts"], np.int64)).to_dense()
          for c in state["chains"]]
    hs = [h for h in hs if gf2_nullspace(h)[1]]
    caps = _caps_for(hs)
    structs = [ADMMStructure.from_h(h, **caps) for h in hs]
    tables = {k: torch.from_numpy(np.stack([getattr(s, k) for s in structs]))
              .to(dev) for k in TABLES}
    idx = torch.arange(trials, dtype=torch.int64, device=dev)
    llrs = []
    for h in hs:
        cw = gen_random_codewords(gf2_nullspace(h)[0], trials,
                                  torch.Generator().manual_seed(seed), dev)
        llrs.append(noise_scales(SNR)[1] * transmit(cw, SNR, seed + 1, idx))
    return tables, torch.stack(llrs), hs[0].shape[1], caps


def wide_code() -> np.ndarray:
    """A 640 x 1280 quasi-cyclic code from a seed, column weight 3 and row
    weight 6 (circulants of 160; block row i leaves out block columns 2i
    and 2i + 1)."""
    present = np.ones((4, 8), bool)
    for i in range(4):
        present[i, 2 * i:2 * i + 2] = False
    shifts = np.random.default_rng(7).integers(0, 160, (4, 8))
    return QCMatrix(160, present, shifts).to_dense()


def _ops_bound_ms(tables, lanes):
    """The least device ms of one iteration of ``lanes`` lanes on the
    packed ``tables``: ``admm_kernel.iteration_work``'s float32 operations
    over the float32 peak; None for a tree without that count."""
    if not hasattr(admm_kernel, "iteration_work"):
        return None
    ops = admm_kernel.iteration_work(tables, lanes, 1)[0]
    return ops / F32_OPS_PER_S * 1e3


def _tier_ms(dev, seed, lanes) -> tuple[dict, dict]:
    """Device ms per iteration (``_kernel_ms``) of ``lanes`` lanes at -3
    dB for each of ``TIER_SHAPES``, and each one's operation bound, keyed
    by label and the cascade's (n_var, n_con, k)."""
    out, bounds = {}, {}
    for label, caps in TIER_SHAPES:
        h = (wide_code() if label.startswith("wide") else
             read_pcm(str(bench.MATRIX.parent / "H02.txt"))
             if label == "H02" else read_pcm(str(bench.MATRIX)))
        alpha, mu = H02_PARAMS if label == "H02" else (1.2, 0.55)
        s = ADMMStructure.from_h(h, **caps)
        tables = admm_kernel.pack_tables(
            {k: torch.from_numpy(getattr(s, k))[None].to(dev)
             for k in TABLES})
        cw = gen_random_codewords(gf2_nullspace(h)[0], lanes,
                                  torch.Generator().manual_seed(seed), dev)
        llr = noise_scales(SNR)[1] * transmit(
            cw, SNR, seed + 1, torch.arange(lanes, device=dev))
        key = f"{label} {(s.n_var, s.n_con, s.var_con.shape[1])}"
        out[key] = _kernel_ms(tables, llr[None], h.shape[1], alpha, mu)
        bounds[key] = _ops_bound_ms(tables, lanes)
    return out, bounds


def _kernel_ms(tables, llrs, n, alpha, mu) -> float:
    """Device ms per iteration of one KERNEL_ITERS-iteration launch of the
    kernel on ``tables`` (packed) from fresh state of ``llrs`` (P, B, n),
    no pair stopping; CUDA events, the median of three after a warm-up."""
    p_count, bsz = llrs.shape[:2]
    n_var, n_con = tables["e"].shape[1], tables["b"].shape[1]
    q = torch.cat([llrs, llrs.new_zeros((p_count, bsz, n_var - n))],
                  dim=2).transpose(0, 1).reshape(bsz, -1).contiguous()
    fresh = (q, (q > 0).float(), q.new_zeros((bsz, p_count * n_con)),
             q.new_zeros((bsz, p_count * n_con)),
             torch.zeros((bsz, p_count), dtype=torch.bool, device=q.device),
             torch.zeros((bsz, p_count), dtype=torch.int32, device=q.device))
    times = []
    for _ in range(4):
        state = [t.clone() for t in fresh]
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        admm_kernel.admm_iterate(*state, tables, alpha, mu, float("-inf"),
                                 2 ** 31 - 1, KERNEL_ITERS)
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / KERNEL_ITERS)
    return statistics.median(times[1:])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--trials", type=int, default=2048)
    p.add_argument("--batch", type=int, default=BATCH)
    p.add_argument("--widths", type=int, nargs="+",
                   default=[1024, 2048, 4096])
    p.add_argument("--width-trials", type=int, default=8192)
    p.add_argument("--pop-trials", type=int, default=POP_TRIALS)
    p.add_argument("--label", default="")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = torch.device(args.device)
    seed = SweepConfig().seed
    fer_ref = REF_FER_OPT["QP-ADMM"][SNR_GRID.index(SNR)]
    h = read_pcm(str(bench.MATRIX))
    g, _ = gf2_nullspace(h)
    cw = gen_random_codewords(g, max(args.trials, args.width_trials),
                              torch.Generator().manual_seed(seed), dev)
    dec = make_decoder("qp-admm", h, device=dev)
    rows, bad = [], []

    def run(kind, trials, width, streaming):
        t0 = time.perf_counter()
        res = run_experiment(dec, h, cw[:trials], SNR, seed + 1, width,
                             device=dev, streaming=streaming)
        row = {"run": kind, "trials": res.total, "width": width,
               "cw_s": res.throughput, "fer": res.fer,
               "z": z_score(res.fer, res.total, fer_ref),
               "mean_iterations": res.sum_iterations / res.total,
               "seconds": time.perf_counter() - t0,
               "counters": [getattr(res, k) for k in COUNTERS]}
        print(" ".join(f"{k} {v}" for k, v in row.items()), flush=True)
        if not abs(row["z"]) < Z_BOUND:
            bad.append(f"{kind} width {width}: FER {res.fer} z {row['z']}")
        rows.append(row)
        return row

    sweep = [run(kind, args.trials, args.batch, kind == "streamed")
             for kind in ("streamed", "batched", "batched", "streamed")]
    if any(r["counters"] != sweep[0]["counters"] for r in sweep):
        bad.append("the sweep's runs differ in their counters")

    tables, llrs, n, caps = _population(dev, seed, args.pop_trials)

    def pop(iters):
        return decode_qp_admm_population(tables, n, llrs, 1.95, 0.5, iters,
                                         1e-5)

    pop_ms = _host_ms(lambda: pop(POP_ITERS), dev)
    chunk_ms = _host_ms(lambda: pop(POP_CHUNK), dev)
    res = pop(POP_ITERS)
    population = {"lanes": list(llrs.shape[:2]), "caps": caps,
                  "ms_per_decode": pop_ms, "max_iter": POP_ITERS,
                  "mean_iterations": float(res.iterations.float().mean()),
                  "ms_per_iteration": chunk_ms / POP_CHUNK,
                  "chunk_iterations": POP_CHUNK}
    print(" ".join(f"{k} {v}" for k, v in population.items()), flush=True)

    kernel = {}
    if dev.type == "cuda":
        llr = noise_scales(SNR)[1] * transmit(
            cw[:args.batch], SNR, seed + 1,
            torch.arange(args.batch, device=dev))
        one = admm_kernel.pack_tables({k: getattr(dec, k)[None]
                                       for k in TABLES})
        kernel["optimalH_ms_per_iteration"] = _kernel_ms(
            one, llr[None], h.shape[1], 1.2, 0.55)
        kernel["optimalH_lanes"] = args.batch
        kernel["population_ms_per_iteration"] = _kernel_ms(
            admm_kernel.pack_tables(tables), llrs, n, 1.95, 0.5)
        kernel["population_lanes"] = list(llrs.shape[:2])
        kernel["iterations_a_launch"] = KERNEL_ITERS
        (kernel["shapes_ms_per_iteration"],
         kernel["shapes_bound_ms"]) = _tier_ms(dev, seed, args.batch)
        print(" ".join(f"{k} {v}" for k, v in kernel.items()), flush=True)

    widths = [run("width", args.width_trials, w, True) for w in args.widths]
    if any(r["counters"] != widths[0]["counters"] for r in widths):
        bad.append("the widths differ in their counters")
    print(json.dumps({"admm_speed": rows, "population": population,
                      "kernel": kernel,
                      "label": args.label, "snr": SNR,
                      "card": bench.card_stamp(dev)}), flush=True)
    for msg in bad:
        print(f"FAILED: {msg}", file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
