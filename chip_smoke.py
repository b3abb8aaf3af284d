#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``ldpc_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. Phases, each
printing one line before the next starts:

1. device check: exits non-zero when ``torch.cuda.is_available()`` is false;
   prints the card, torch, CUDA and nvcc versions;
2. kernel build: compiles ``ldpc_tpu_torch/csrc/*.cu`` with nvcc and prints
   the seconds it took, ptxas's registers and spills per kernel, and the
   QP-ADMM iteration kernel's tier at optimalH, H02 and the optimizer's
   caps (threads and lanes a block, shared bytes a block, registers and
   local bytes a thread, blocks per SM); then compiles the native host core
   (``ldpc_tpu_torch/_native/ldpc_host.cpp``) with g++ into
   ``build/ldpc_tpu_torch/libldpc_host.so`` and prints g++'s version, the
   seconds and the library's path;
3. kernel vs its plain PyTorch twin on the card: the fused BP kernel and
   ``ops.bp_ref`` decode the same 8192 optimalH LLRs at -3 and at 0 dB
   (100 iterations). Bound: success flag and iteration count agree on at
   least 99.5 % of lanes, and the bits agree exactly on every lane where
   both succeeded at the same iteration; the only allowed source of
   disagreement is the order of float32 sums and the math library's
   log/tanh. Times each with CUDA events (3 repeats after a warm-up). Then
   ``BPDecoder`` with ``variant="minsum"`` and with ``fixed_iters=True``
   decodes 1,024 of the lanes on the card through ``decode_batch`` (the
   plain decode, no kernel launch), held to the same decoder on the CPU
   for the same LLRs by the same rule;
4. main path at full size: ``ldpc_tpu_torch.bench.main()`` (65,536 trials,
   batch 8192, -3 dB, 100 and 50 iterations) with the BP kernel's and the
   channel kernel's launch counts reset before and read after; the FER must
   lie within |z| < 3.5 of the reference's 0.4860 (10,000 trials), and the
   channel kernel must have launched once a batch (the harness's
   ``COUNTS["batches"]`` over the same run);
5. PDHG chunk kernel vs its plain twin ``ops.pdhg_ref`` on the card: random
   signed-row LPs shaped like ``tests/test_pallas_pdhg.py``'s (256 lanes,
   n = 280, every row tier of the ALP path, T = 128 ... 896, and n = 640,
   H02's tiers that need clusters of 4 and 8 blocks, T = 640, 896, 1408,
   2176; 64 steps, ``average`` off and on, a third of the lanes inactive,
   each a row slice of a deeper buffer), and the real cut buffers of an
   ALP batch (256 optimalH lanes at -3 dB) after its third round. Bounds:
   the JAX package's own between its kernel and XLA, |dx| <= 2e-5,
   |dy| <= 2e-4, |d err| <= 1e-5 (float32 sum order only; neither side uses
   fast math),
   inactive lanes bit-identical, a second call bit-identical, no lane
   flagged; then a slice with entries outside {-1, 0, 1} must be flagged
   in exactly its lanes. Prints each tier's layout (blocks per lane, row
   groups, threads, shared memory). Times each with CUDA events;
6. ALP path at full width: ``apps.benchmark.run_sweep`` with decoders
   ``alp``, -3 dB, 2,048 trials (batch 256, optimalH, 896 cut rows per
   lane), CSVs under ``build/``, with the PDHG kernel's launch count reset
   before and read after, and its launches per row tier. Gates: FER within
   |z| < 3.5 of the reference's 0.9659 and launches > 0. Then the same 256
   lanes decoded with
   ``lp_backend="kernel"`` and ``"xla"``: success agrees on >= 95 % of
   lanes (the solvers differ in float order and in their first chunk
   test);
7. the AGC-ALP path's six kernels against their plain twins on the card,
   at AGC-ALP's shapes (128 lanes, optimalH, capacity 1408 x 280):
   the GF(2) elimination on an AGC-ALP batch's IPM solution after three
   cut rounds, on H02 (520 x 640) in the column order of seeded LP points
   and on seeded 63 x 283 matrices, a third of the lanes inactive in each
   (active lanes bit-identical, inactive lanes passed through, a second
   call bit-identical; device time as a CUDA graph and time by events,
   beside the first design's 0.226 ms, the bound and the time per column
   step); A x and A^T y on the packed int8 copy
   (``pack_rows``) of row slices of a (128, 1408, 280) buffer at every row
   tier of the path (T = 128 ... 1408) and on a slice ragged in every
   dimension (3 x 63 x 283), each call bit-identical to a second one, and
   the normal matrix on the same packed copy at T = 128, 512, 1152 and 1408
   and on the ragged slice, with d over 1e-8...1e8 as late in a Newton
   step, M exactly symmetric and a second call bit-identical (bound: the
   float32 summation bound, the length of the sum (n for A x, T otherwise)
   * 2**-23 * sum |terms| per entry, the products being exact for +-1/0
   rows and the kernel's three bf16 planes of d); the
   diagonal-block Cholesky on 128 SPD 64 x 64 blocks and one that is not
   (within 1e-4 of the twin's scale, NaN in that lane only); and the whole
   blocked factor and solve on the batch's last normal matrix (its residual
   at most 10x that of ``cholesky_ex`` + ``cholesky_solve`` plus 1e-3 of
   |r|, the rule of ``tests/test_chol.py``). Times each with CUDA events,
   the diagonal-block kernel also as a CUDA graph (device time);
   the matvecs, their plain versions, ``bmm`` on the float32 slice and the
   pack as CUDA graphs of calls (device time), warm and with a cold L2,
   beside each one's bound, and the host's cost per call apart; the normal
   matrix the same way beside ``baddbmm`` on the float32 slice. Last the
   IPM step's two kernels (``csrc/ipm_step.cu``: the step lengths and the
   masked update, XLA fusions in JAX) against their twins
   (``ops/ipm_ref.py``) bit for bit at T = 128, 640 and 1408 (128 lanes,
   n = 280), at 256 lanes of T = 1408 and at H02's deepest tier (T = 2176,
   n = 640; lanes with NaN and inf directions, all-positive directions,
   ties, steps clamped to 1, steps past the box), each with its launch
   plan (``ipm_step_plan``), timed as a CUDA graph of calls cold (inputs
   rotated past the L2) and warm, and by events, beside its twin's eager
   ops (counted and timed the same ways), its bound (bytes over the HBM
   rate) and the launch floor: an empty kernel of the plan's grid timed
   the same way;
8. AGC-ALP path at full width: ``run_sweep`` with decoders ``agc-alp``,
   -3 dB, 512 trials in batches of 128 (optimalH, ``max_rows`` 1000,
   capacity 1408, the IPM as CUDA graphs, the default on CUDA), which
   streams (``streaming="auto"``: finished lanes refilled after each cut
   round), CSVs under ``build/``, with the seven kernels' launch counts
   reset before and read after, and the matvecs' and the normal matrix's
   launches per row tier. Gates: FER within |z| < 3.5 of the reference's
   0.8704, no cut dropped, every kernel launched. Then the same 512 trials
   streamed with the IPM as CUDA graphs and with ``ipm_graphs = False``
   (the eager loop), each lane's bits, success, rounds, ``cum_h``,
   ``cum_g`` and dropped cuts recorded as it finishes: the two must be
   equal lane by lane, in every counter and in every kernel's launches;
   cw/s of both. Printed beside it: the first 256 of those trials on the
   batched runner (``streaming=False``), each run's FER, rounds, cut counts
   (``cum_h``/``cum_g``), cw/s and host syncs per 128 trials (torch's sync
   debug mode), then each runner's launches per 128 trials with graphs and
   without, counted in separate runs under a dispatch mode: host launches
   (non-view ATen operations, the hand-written kernels outside a graph and
   one per graph replay) and device operations (the same with each replay
   counted as its graph's kernel, copy and memset nodes); the graph run's
   host launches streamed must be at most a tenth of the eager run's. The
   peak device memory of the phase and the solve shapes captured. Then the
   same 128 lanes decoded with the kernel backends and with the plain ones
   (``ipm_matvec_backend``/``ipm_factor_backend``/``gauss_backend``
   ``"xla"``): success agrees on >= 95 % of lanes (the IPM's stop tests
   read float32 errors summed in another order);
9. ALP on H02 (520 x 640, capacity 2176): ``run_sweep`` with decoders
   ``alp``, -7 dB, 256 trials in one batch, with the PDHG kernel's launch
   counts reset before and read after and printed per row tier. H02 has
   no golden FER, so this is no parity check: it must run to its end with
   no cut dropped and launch the kernel at T >= 640 (clusters of 4 blocks
   per lane);
10. QP-ADMM path: ``run_sweep`` with decoders ``qp-admm``, -3 dB, 2,048
    trials in batches of 1024 (alpha 1.2, mu 0.55, ``max_iter`` 10,000),
    which streams; FER within |z| < 3.5 of 0.2751, mean iterations, cw/s
    and host syncs per 1024 trials. The same trials on the batched runner,
    then batched and streamed again (the order alternated, for the cw/s of
    each runner): all eight counters of every run equal (no quantity of
    QP-ADMM couples lanes). 64 of the lanes decoded on the card and on the
    CPU at ``max_iter`` 2,000: bits and success equal.
    A 64-iteration chunk at 1024 lanes: ms per iteration, dispatches per
    iteration and the kernel's launches per chunk.
    The iteration kernel (``csrc/admm_iterate.cu``) against its twin
    (``ops/admm_ref.py``) on the card at the batch's 1024 optimalH lanes:
    the state after 32 and after 512 iterations and the batched decode at
    ``max_iter`` 10,000 (bits, success, iterations), equal on every lane
    but ``sum2`` ties (the kernel sums sum2 in its own order), which are
    printed with both sum2 values after reruns that reach equal states;
    any other difference fails. Device ms per iteration of one 512-iteration
    launch (no lane stopping) by CUDA events, the twin's by events over 32
    iterations, and the bound (operations: the float32 work of an
    iteration; the chunk's bytes over its iterations are far below).
    H02 at the defaults (e_min 2: 2 * 0.55 <= 1.2), 64 lanes: FER 1.0 and
    no lane successful. H02 at alpha 0.9, mu 0.5 (``run_h02_bench.sh``'s
    feasible pair) at -5 dB, where lanes stop and its 72 slots a variable
    are summed in XLA's windows of 32: the kernel's state against its
    twin's after 32 and 512 iterations on 64 lanes (equal but on sum2
    ties), those lanes decoded on the card and on the CPU at ``max_iter``
    200 (bits and success equal), and the kernel's device ms per
    iteration at 1024 H02 lanes beside optimalH's, with its bound;
11. Full LP: ``run_sweep`` with decoders ``full-lp``, -3 dB, 512 trials in
    batches of 256, 2,000 PDHG steps (no golden FER: the reference leaves
    this decoder out, ``main.cpp:36``); 32 lanes on the card and on the
    CPU: x within 1e-4, bits and success equal on the lanes whose every
    coordinate lies 1e-3 from 0.5 and from ``int_tol``; with TF32 allowed
    the decode refuses;
12. the fused multi-SNR runner: BP-100 over -4, -3 and -2 dB as one run of
    3 x 8,192 lanes, against three single-SNR runs of the same trials:
    all counters equal; each point's z against the golden curve printed;
13. the apps: ``qpadmm_grid`` over 3 x 3 cells around (1.2, 0.55) at 256
    trials, each cell's FER equal to a ``QPADMMDecoder`` run at that cell
    on the same LLRs; ``validate`` for QP-ADMM at -3 dB with
    ``max_trials`` 2,048: verdict PASS;
14. the matrix optimizer (``apps.optimize_h.optimize``) at the reference's
    width (8 x 14 blocks of 20, 160 x 280), resumed from a copy of the JAX
    package's ``data/optimize_state.json`` (8 chains, generation 26,208,
    best FER 0.362) under ``build/`` for two rounds of 8 proposals: screens
    of 256 trials at 600 iterations, full evaluations of 1,000 trials at
    1,000 iterations, alpha 1.95, mu 0.5, -3 dB, the final evaluation cut
    to 2,000 trials. Prints the seconds of each generation, of the screen,
    full and final evaluations, the host's seconds per generation in
    ``gf2_nullspace``, ``ADMMStructure.from_h`` and the codeword draw and
    which path built the tables (the native host core, or NumPy under
    ``LDPC_TPU_NO_NATIVE``), and
    ms and dispatches per iteration of the population decode at 2,048
    lanes. Gates: (a) the population decode of the 8 chain incumbents at
    256 trials equals 8 single-structure ``decode_qp_admm`` calls on the
    card lane by lane (bits, success, iterations); (b) 64 of those lanes
    equal the CPU's (``max_iter`` 1,000); (c) the final FER is recomputed
    exactly by a ``QPADMMDecoder`` of the best matrix on the same codewords
    and LLRs; (d) the state file is strict JSON that round-trips, at
    generation 26,224, and its FER is not above the resumed one. Then the
    iteration kernel against its twin at the population's shape (the 8
    incumbents x 256 lanes at their caps 1280 / 5120 / 32): the state
    after 32 and 512 iterations equal on every pair but sum2 ties, device
    ms per iteration of one 512-iteration launch with no pair stopping
    (events), the twin's, and the bound on the real rows (not the caps).
15. worlds of processes over ``torch.distributed``, each started by
    ``torchrun`` as ``chip_smoke.py --world DIR BACKEND`` (one JSON file of
    results per rank under ``build/chip_smoke_worlds/``): (a) a world of 1
    over NCCL runs ``apps.scaling_bench`` at its defaults (optimalH, 65,536
    trials, 4,096 lanes, BP-50, -3 dB; ``bp_decode`` launches > 0) and the
    same trials unsharded in that process (all eight counters equal), then
    the unsharded references of (b) and (c); (b) a world of 2 on the one
    card over gloo: BP sharded at the same configuration, ALP at 512 trials
    in batches of 256 (one per rank; ``pdhg_chunk`` launches > 0) and
    QP-ADMM streamed at 256 trials on 64 lanes a rank, each rank's summed
    counters equal to the unsharded run's in all eight fields, and
    ``scaling_bench``'s line for the world (its efficiency on one card is
    a functional figure, not a scaling claim); (c) the optimizer at the
    reference's width, population 2 for 2 generations at a small budget,
    over the world of 2 against the world of 1: the same state file and
    log lines, rank 1 silent. Then two ranks on the card over NCCL must
    fail ("Duplicate GPU detected"). A world that fails or has not ended
    after 300 s (killed with its process group) fails the phase.
16. the native host core on the card's host: ``gf2_nullspace`` and
    ``ADMMStructure.from_h`` (the core) against their NumPy bodies
    (``_nullspace_numpy``, ``_from_h_numpy``) on ``data/H.txt``,
    ``optimalH.txt``, ``H02.txt`` and ``H05.txt`` and on 200 QC mutations
    of the state file's 8 chain incumbents, drawn as ``optimize_h`` draws
    them (25 generations; singular ones among them): G and ok equal, and
    every table equal with no caps and at ``optimize_h._caps_for`` caps
    (each file alone, each generation's 8 together). Any difference fails
    the phase. Prints ms per call of both paths. The core is no GPU kernel:
    its line comes before the kernels' JSON line, not in it.
17. the optimizer's before/after tool (``scripts/torch_opt_before_after.py``,
    the port of ``scripts/opt_before_after.py``) on a copy of the JAX
    package's run under ``build/`` (its state and ``data/optimalH_tpu.txt``)
    at 2,000 trials: the initial, optimized, optimalH and H05 matrices at
    the objective's config (alpha 1.95, mu 0.5, 1,000 iterations) and the
    report's (1.2, 0.55, 10,000), -3 dB. Gates: the record has the keys of
    the JAX run's ``reports/optimize_before_after.json``, and optimalH's
    and H05's FERs at both configs lie within |z| < 3.5 of that run's
    (10,000 trials); the iteration kernel launched.
18. the channel kernel (``csrc/awgn_channel.cu``: the trial-keyed noise,
    BPSK, the LLR scaling and the hard-decision count in one launch) against
    its plain twin (``channel.awgn.channel_ref`` on the same card tensors)
    at the main path's shapes, 8192 x 280 (BP) and 256 x 280 (ALP): optimalH
    codewords gathered by a permutation from a deeper table, trial indices
    past 2**32 as a strided view, a seed past 2**31, one noise scale and
    one a lane (two SNRs alternating). Gate: y, the LLRs and the count equal
    the twin's bit for bit, one launch a call. Times each as a CUDA graph
    of calls (device time, warm) and by events, the twin as a CUDA graph,
    beside the bound: the bytes (bits and trial indices in, y, the LLRs and
    the count out) over the HBM rate.

Phases 10-17 reset every kernel's launch count before their path and print
the counts after it (phase 12 runs BP's kernel, phase 15 BP's, the PDHG
kernel and QP-ADMM's in every rank, phase 16 none: it runs on the host);
QP-ADMM's iteration kernel must have launched on phases 10, 13, 14, 15 and
17, the channel kernel on phases 10, 12, 13 and 14.
Each phase prints its seconds. Then the script prints the host core's JSON
line, the kernels' JSON line, the card's ``name, power.limit`` line and,
last,
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
VARIANT_LANES = 1024
# phases 5 and 6: the ALP path (DEFAULT_BATCH["alp"], lp_iters)
ALP_LANES = 256
ALP_SNR = -3.0
ALP_TRIALS = 2048
PDHG_STEPS = 64
# every row tier of the ALP path (decoders/alp.py, capacity 896)
PDHG_TIERS = (128, 256, 384, 512, 640, 896)
# H02's width and its tiers that need clusters of 4 and 8 blocks per lane
H02_N = 640
H02_PDHG_TIERS = (640, 896, 1408, 2176)
H02_SNR = -7.0
H02_TRIALS = 256
X_TOL, Y_TOL, ERR_TOL = 2e-5, 2e-4, 1e-5
ALP_AGREE_MIN = 0.95
# phases 7 and 8: the AGC-ALP path (DEFAULT_BATCH["agc-alp"], capacity)
AGC_LANES = 128
AGC_SNR = -3.0
AGC_TRIALS = 512
AGC_CAP = 1408
# every row tier of the AGC-ALP path (decoders/alp.py, capacity 1408)
GEMV_TIERS = (128, 256, 384, 512, 640, 896, 1152, 1408)
WARM_CALLS = 8      # calls of the warm graph (the same inputs each call)
GRAPH_REPLAYS = 5
HOST_CALLS = 200
COLD_ROUNDS = 2
NORMAL_TIERS = (128, 512, 1152, 1408)
EPS32 = 2.0 ** -23
# the H100 SXM's published peaks (NVIDIA's data sheet, 700 W): HBM3 bytes
# per second, float32 outside the tensor cores (an FMA counts two), dense
# bf16 on the tensor cores; INT32 is 64 lanes per SM per clock, 132 SMs at
# 1.98 GHz
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9
# special functions (logf, tanhf): 16 per SM per clock
SFU_OPS_PER_S = 16 * 132 * 1.98e9
L2_BYTES = 50 * 2 ** 20
CHOL_TOL = 1e-4
# the GF(2) elimination: a shape ragged in both dimensions, and the first
# (row-per-thread) design's time at 128 x 160 x 280 by events (PERF.md §6)
GAUSS_RAGGED = (63, 283)
FIRST_GAUSS_MS = 0.226
AGC_AGREE_MIN = 0.95
AGC_BATCHED = 256
# the IPM step's two kernels: (lanes, T, n) held to their twins, the
# path's tiers (optimalH) first, then 256 lanes and H02's deepest tier
IPM_SHAPES = ((AGC_LANES, 128, 280), (AGC_LANES, 640, 280),
              (AGC_LANES, AGC_CAP, 280), (2 * AGC_LANES, AGC_CAP, 280),
              (AGC_LANES, 2176, H02_N))
# phases 10-13: QP-ADMM (DEFAULT_BATCH["qp-admm"] = 1024, so 2048 trials
# stream), Full LP, the fused multi-SNR BP run and the apps
ADMM_SNR = -3.0
ADMM_TRIALS = 2048
ADMM_CPU_LANES = 64
ADMM_CPU_ITERS = 2000   # the card-vs-CPU decode's max_iter, as the gpu test's
ADMM_H02_LANES = 64
# H02 where QP-ADMM decodes: scripts/run_h02_bench.sh's feasible (alpha,
# mu), at -5 dB, where lanes stop; its CPU decode cut to 200 iterations
# (the twin takes ~50 ms an iteration there at 64 lanes on the card's host)
ADMM_H02_PARAMS = (0.9, 0.5)
ADMM_H02_SNR = -5.0
ADMM_H02_CPU_ITERS = 200
ADMM_CHUNK = 64
ADMM_STATE_ITERS = (32, 512)   # the kernel's state against its twin's
ADMM_TIMED_ITERS = 512         # one launch, timed by events
ADMM_TWIN_ITERS = 32
# the kernel's tiers printed by the build phase: (label, (n_var, n_con, k))
ADMM_SHAPES = (("optimalH", (700, 2320, 24)), ("H02", (1260, 4520, 72)),
               ("the optimizer's caps", (1280, 5120, 32)),
               ("caps of the third tier", (2048, 6144, 72)),
               ("a 640 x 1280 code of row weight 6", (3200, 10240, 12)),
               ("caps of 9,000 / 10,000", (9000, 10000, 24)))
LP_TRIALS = 512
LP_CPU_LANES = 32
LP_X_TOL = 1e-4     # |x card - x CPU| after 2000 steps (GEMM sum order)
LP_MARGIN = 1e-3    # lanes this far from 0.5 and int_tol decide alike
MULTI_SNRS = (-4.0, -3.0, -2.0)
GRID_TRIALS = 256
# phase 14: the optimizer resumed from the JAX package's state for two
# rounds; its final evaluation cut from 10,000 trials to 2,000
OPT_STATE = "data/optimize_state.json"
OPT_ROUNDS = 2
OPT_FINAL_TRIALS = 2000
OPT_CPU_LANES = 8       # per candidate: 64 lanes on the card and the CPU
OPT_CHUNK = 64          # iterations of the timed population decode
# phase 15: worlds of processes started by torchrun
WORLD_DIR = "build/chip_smoke_worlds"
WORLD_TIMEOUT_S = 300   # a world that has not ended by then is killed
WORLD_ALP_TRIALS = 512  # two ALP batches of 256: one per rank of 2
WORLD_ADMM_TRIALS = 256
WORLD_ADMM_LANES = 128  # streamed: 64 lanes per rank of 2
WORLD_ADMM_ITERS = 2000  # QP-ADMM's cap in the check (the failing trials'
# run to it sets the stream's tail)
WORLD_OPT = dict(trials=128, final_trials=256, screen_trials=64,
                 screen_iters=200, admm_max_iter=300, generations=4,
                 population=2)  # 2 generations of 2 proposals, -3 dB
# phase 17: the optimizer's before/after tool (scripts/
# torch_opt_before_after.py) on a copy of the JAX package's run, its
# 10,000 trials cut to 2,000; the JAX run's record beside it
BA_STATE = "build/chip_smoke_before_after_state.json"
BA_OPTIMIZED = "data/optimalH_tpu.txt"
BA_JAX = "reports/optimize_before_after.json"
BA_TRIALS = 2000
BA_GATED = ("fer_reference_optimalH", "fer_H05",
            "report_fer_reference_optimalH", "report_fer_H05")
# phase 18: the channel kernel at the main path's shapes (BP, ALP)
CHANNEL_SHAPES = ((LANES, 280), (ALP_LANES, 280))
CHANNEL_SEED = 2**31 + 7
CHANNEL_SNRS = (-3.0, 0.0)  # the per-lane form alternates the two
CHANNEL_CALLS = 20          # calls of the timed graph
CHANNEL_TWIN_CALLS = 2
# phase 16: the native host core against NumPy on the card's host
NATIVE_FILES = ("H", "optimalH", "H02", "H05")
NATIVE_GENERATIONS = 25  # of the state file's 8 chains: 200 mutations
NATIVE_SEED = 0
NATIVE_REPEATS = 5       # calls per file and path; the median is printed


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


def _graph_ms(fn, args_list, replays: int = GRAPH_REPLAYS) -> float:
    """Mean device ms per call of ``fn(*args)`` over ``args_list``, the calls
    captured once in a CUDA graph (after a warm-up call on a side stream)
    and the graph replayed: the host's cost of each call is left out, so a
    kernel of a few microseconds is timed, not its launch (:func:`_host_us`
    reads that)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*args_list[0])
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for args in args_list:
            fn(*args)
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (replays * len(args_list))


def _host_us(fn, calls: int = HOST_CALLS) -> float:
    """Mean host microseconds to enqueue one call of ``fn`` (the card
    idle before; what a host-bound path pays per call)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    secs = time.perf_counter() - t0
    torch.cuda.synchronize()
    return secs / calls * 1e6


def _bound(nbytes, ops, ops_per_s) -> dict:
    """The least time the card could take for the work: the larger of the
    bytes over the HBM rate and the operations over their peak rate."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / ops_per_s * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


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
        found = re.search(r"entry function '\w*?([a-z][a-z0-9_]*_kernel)"
                          + TEMPLATE_ARGS, line)
        if found:
            name = found.group(1) + _template(found.group(2))
        elif name and ("spill" in line or "Used" in line):
            out.append(f"{name}: {line.split(':', 1)[-1].strip()}")
    return "; ".join(out)


# a kernel's template arguments in its mangled name: bools and ints
TEMPLATE_ARGS = r"(I(?:L[bi]-?\d+E)+E)?"


def _template(mangled) -> str:
    """``<0,1>`` from ``ILb0ELb1EE``, ``<8>`` from ``ILi8EE``; "" for none."""
    if mangled is None:
        return ""
    return "<" + ",".join(re.findall(r"L[bi](-?\d+)E", mangled)) + ">"


SASS_OPS = ("LDS", "LDSM", "PRMT", "LOP3", "FADD", "FFMA", "HMUL2", "HMMA",
            "I2F", "SYNCS", "SHFL", "MUFU", "BAR")


def _sass_mix(lib: str) -> str:
    """Static counts of all instructions and of a few opcodes in the SASS
    of the kernels (``cuobjdump -sass``), to read that the int8 unpack of
    the packed-row kernels compiled to PRMT + FADD, that the normal matrix
    runs on the tensor cores (HMMA, fed by LDSM), and how large the unrolled
    diagonal-block and BP kernels are, and that the GF(2) elimination's
    block barriers are the two around its column loop (BAR 2): the counts
    cover the whole kernel, not only its loops."""
    from collections import Counter

    from ldpc_tpu_torch.ops import _build
    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    if not os.path.isfile(tool):
        return f"not read ({tool} not found)"
    sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            found = re.search(r"\d((?:gemv_[a-z_]*|normal_build|pdhg_chunk|"
                              r"chol_diag_inv|bp_decode|gf2_gauss)_kernel)"
                              + TEMPLATE_ARGS, line)
            name = (found.group(1) + _template(found.group(2))
                    if found else None)
            if name:
                counts[name] = Counter()
        elif name:
            op = re.search(r"\*/\s+(?:@!?P\w+\s+)?([A-Z][A-Z0-9]*)", line)
            if op:
                counts[name][op.group(1)] += 1
    return "; ".join(f"{k}: {sum(c.values())} instructions, " + ", ".join(
        f"{o} {c[o]}" for o in SASS_OPS) for k, c in counts.items())


def phase_build():
    from ldpc_tpu_torch.ops import _build
    t0 = time.perf_counter()
    log = _build.build(force=True)
    _build.load()
    secs = time.perf_counter() - t0
    print(f"[2 build] {_build.LIB_PATH.name} built in {secs:.2f} s from "
          f"{len(_build._sources())} sources ({_ptxas_usage(log)})",
          flush=True)
    print(f"[2 build] SASS of the kernels: "
          f"{_sass_mix(str(_build.LIB_PATH))}", flush=True)
    from ldpc_tpu_torch.ops import admm_kernel
    for label, shape in ADMM_SHAPES:
        plan = admm_kernel.admm_plan(*shape)
        occ = admm_kernel.admm_occupancy(*shape)
        print(f"[2 build] admm_iterate at {label} (n_var, n_con, k) "
              f"{shape}: tier {plan['tier']}, {plan['threads']} threads "
              f"and {plan['lanes']} lanes a block, {plan['smem_bytes']} "
              f"shared bytes a block, {occ['registers']} registers and "
              f"{occ['local_bytes']} local bytes a thread, "
              f"{occ['blocks_per_sm']} blocks per SM on {occ['sms']} SMs",
              flush=True)

    from ldpc_tpu_torch import _native
    gxx = subprocess.run([_native.gxx_path(), "--version"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.splitlines()[0]
    t0 = time.perf_counter()
    _native.build(force=True)
    if _native.load() is None:
        raise AssertionError("LDPC_TPU_NO_NATIVE is set: the host core "
                             "is switched off")
    print(f"[2 build] host core {_native.LIB_PATH} built by {gxx} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)


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
              f"ref {fer_r:.4f}; average iterations "
              f"{ki.float().mean().item():.3f}; kernel {ms:.3f} ms, bp_ref "
              f"{plain_ms:.3f} ms per {LANES}-lane decode", flush=True)
        if agree < AGREE_MIN or bit_err != 0:
            raise AssertionError(f"kernel disagrees with bp_ref at SNR {snr}")

        # bytes: the LLRs in, bits, flag and count out; operations: two phi
        # per edge and iteration run, each a logf and a tanhf
        edges, iters = int(h.sum()), int(ki.sum())
        rows[snr] = {"max_abs_err": bit_err, "ms": ms, "plain_ms": plain_ms,
                     "lanes_differ": int((~same).sum()), "library_ms": None,
                     **_bound(llr.numel() * 5 + LANES * 5,
                              4 * edges * iters, SFU_OPS_PER_S)}

    # minsum and fixed_iters run on the card through decode_batch (the plain
    # decode), held to the same decoder on the CPU by the kernel's rule
    _, llr = channel_llr(cw[:VARIANT_LANES], SNRS[0], 11,
                         trials[:VARIANT_LANES])
    for variant, fixed in (("minsum", False), ("sumprod", True)):
        kw = dict(max_iter=MAX_ITER, variant=variant, fixed_iters=fixed)
        before = bp_kernel.LAUNCHES
        t0 = time.perf_counter()
        got = BPDecoder(h, **kw, device=dev).decode_batch(llr)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        cpu = BPDecoder(h, **kw, device="cpu").decode_batch(llr.cpu())
        same = ((got.success.cpu() == cpu.success)
                & (got.iterations.cpu() == cpu.iterations))
        both = same & cpu.success
        bits_same = torch.equal(got.bits.cpu()[both], cpu.bits[both])
        exact = all(torch.equal(u.cpu(), v) for u, v in zip(got[:3], cpu[:3]))
        agree = same.float().mean().item()
        print(f"[3 kernel-vs-ref] BPDecoder variant {variant}, fixed_iters "
              f"{fixed}, {VARIANT_LANES} lanes at {SNRS[0]:+.1f} dB on the "
              f"card: {int((~same).sum())} lanes differ from the CPU in "
              f"success/iterations (agree {agree:.6f}, bound {AGREE_MIN}); "
              f"bits equal on agreeing successful lanes {bits_same}; all "
              f"outputs bit-identical {exact}; successes "
              f"{int(got.success.sum())}; bp_decode launches "
              f"{bp_kernel.LAUNCHES - before}; {secs:.3f} s", flush=True)
        if agree < AGREE_MIN or not bits_same:
            raise AssertionError(f"BP {variant} fixed_iters={fixed} on the "
                                 f"card disagrees with the CPU")
    return rows


def phase_main_path():
    from ldpc_tpu_torch import bench
    from ldpc_tpu_torch.harness import experiment
    from ldpc_tpu_torch.harness.reference_data import Z_BOUND, z_score
    from ldpc_tpu_torch.ops import bp_kernel, channel_kernel

    bp_kernel.LAUNCHES = 0
    channel_kernel.LAUNCHES = 0
    batches = experiment.COUNTS["batches"]
    out = bench.main()
    launches = bp_kernel.LAUNCHES
    channel_launches = channel_kernel.LAUNCHES
    batches = experiment.COUNTS["batches"] - batches
    extra = out["extra"]
    z = z_score(extra["fer_100it"], extra["trials"], bench.FER_REF_100IT)
    print(f"[4 main path] {out['value']} cw/s at 100 it, {extra['cws_50it']} "
          f"cw/s at 50 it; FER {extra['fer_100it']} (z = {z:+.2f} against "
          f"{bench.FER_REF_100IT}), FER@50it {extra['fer_50it']}; "
          f"bp_decode launches {launches}; awgn_channel launches "
          f"{channel_launches} over {batches} batches", flush=True)
    if launches <= 0 or extra["bp_kernel_launches"] <= 0:
        raise AssertionError("the main path did not launch the BP kernel")
    if batches <= 0 or channel_launches != batches:
        raise AssertionError(f"the main path launched the channel kernel "
                             f"{channel_launches} times over {batches} "
                             f"batches, not once a batch")
    if not abs(z) < Z_BOUND:
        raise AssertionError(f"FER {extra['fer_100it']} is {z:+.2f} sigma "
                             f"from the reference")
    if not (0.0 < out["value"] < float("inf") and extra["trials"] > 0):
        raise AssertionError(f"bad throughput {out['value']}")
    return launches, channel_launches


def _pdhg_compare(label, args, active, average):
    """One chunk through the kernel and through the twin on the same
    inputs: checks the bounds, that a second call gives the same bits and
    that no lane is flagged, times both, returns a row for the JSON."""
    import torch
    from ldpc_tpu_torch.ops import pdhg_kernel
    from ldpc_tpu_torch.ops.pdhg_ref import pdhg_chunk_ref

    def kernel():
        return pdhg_kernel.pdhg_chunk(*args, PDHG_STEPS, active=active,
                                      average=average)

    def ref():
        return pdhg_chunk_ref(*args, PDHG_STEPS, active=active,
                              average=average)

    (xk, yk, ek, flag), again, (xr, yr, er) = kernel(), kernel(), ref()
    torch.cuda.synchronize()
    x0, y0 = args[5], args[6]
    on = active
    dx = float((xk - xr)[on].abs().max())
    dy = float((yk - yr)[on].abs().max())
    de = float((ek - er)[on].abs().max())
    off = ~on
    through = (torch.equal(xk[off], x0[off]) and torch.equal(yk[off], y0[off])
               and bool((ek[off] == 0).all()))
    same = all(torch.equal(u, v) for u, v in zip((xk, yk, ek, flag), again))
    flagged = int(flag.sum())
    ms, plain_ms = _time_ms(kernel), _time_ms(ref)
    print(f"[5 pdhg-vs-ref] {label}: |dx| {dx:.3e} (bound {X_TOL}), |dy| "
          f"{dy:.3e} ({Y_TOL}), |d err| {de:.3e} ({ERR_TOL}); "
          f"{int(off.sum())} inactive lanes bit-identical: {through}; repeat "
          f"bit-identical: {same}; lanes flagged {flagged}; kernel "
          f"{ms:.3f} ms, pdhg_ref {plain_ms:.3f} ms per {PDHG_STEPS}-step "
          f"chunk", flush=True)
    if not (dx <= X_TOL and dy <= Y_TOL and de <= ERR_TOL and through
            and same and flagged == 0):
        raise AssertionError(f"PDHG kernel disagrees with pdhg_ref ({label})")
    # bytes: A once, the vectors in and out; operations: A^T y and
    # A (2x' - x) per step on the active lanes
    _, t, n = args[1].shape
    vec_bytes = 4 * sum(v.numel() for v in args if v is not args[1])
    return {"t": t, "average": average, "max_abs_err": max(dx, dy, de),
            "ms": ms, "plain_ms": plain_ms, "library_ms": None,
            **_bound(4 * args[1].numel() + 2 * vec_bytes,
                     int(on.sum()) * PDHG_STEPS * 4 * t * n, F32_OPS_PER_S)}


def _pdhg_flags(args, active):
    """Entries outside {-1, 0, 1} in four lanes of a slice (first and last
    entry, one lane inactive, a NaN): the kernel must flag exactly the
    active ones, as the tensor-op report does."""
    import torch
    from ldpc_tpu_torch.ops import pdhg_kernel
    a = args[1].clone()
    t = a.shape[1]
    inactive = int((~active).nonzero()[0])
    on = active.nonzero()[:, 0].tolist()
    a[on[0], 0, 0] = 0.5
    a[on[1], t - 1, -1] = -2.0
    a[on[2], t // 2 + 1, 17] = float("nan")
    a[inactive, 3, 3] = 7.0
    flag = pdhg_kernel.pdhg_chunk(args[0], a, *args[2:], 2,
                                  active=active)[3]
    want = pdhg_kernel.outside_set(a, active)
    torch.cuda.synchronize()
    ok = torch.equal(flag, want) and int(want.sum()) == 3
    print(f"[5 pdhg-vs-ref] T = {t}: entries outside {{-1, 0, 1}} in lanes "
          f"{on[:3]} and the inactive lane {inactive}: flagged "
          f"{flag.nonzero()[:, 0].tolist()}, as the tensor-op report: {ok}",
          flush=True)
    if not ok:
        raise AssertionError(f"PDHG kernel's flag is wrong at T = {t}")


def _alp_llrs(g, lanes, seed):
    import torch
    from ldpc_tpu_torch.channel.awgn import channel_llr, gen_random_codewords
    dev = torch.device("cuda")
    cw = gen_random_codewords(g, lanes, torch.Generator().manual_seed(seed),
                              dev)
    _, llr = channel_llr(cw, ALP_SNR, seed + 1,
                         torch.arange(lanes, device=dev))
    return llr


def _pdhg_tiers(n, shapes, gen, inactive):
    """Phase 5's random LPs at width ``n``: random signed rows in a buffer
    as deep as the last tier, each tier a row slice of it, rows past 5T/8
    zero with rhs 0; kernel against twin at each tier, ``average`` off and
    on, then the flag test. Returns one row per (tier, average)."""
    import torch
    from ldpc_tpu_torch.ops import pdhg_kernel
    from ldpc_tpu_torch.ops.lp_solver import pdhg_steps
    dev = inactive.device
    out = []
    a_buf = torch.randint(-1, 2, (ALP_LANES, shapes[-1], n),
                          generator=gen, device=dev).float()
    for t in shapes:
        rows = t * 5 // 8
        c = torch.randn((ALP_LANES, n), generator=gen, device=dev)
        a = a_buf.clone()[:, :t]
        a[:, rows:] = 0.0
        b = torch.randn((ALP_LANES, t), generator=gen, device=dev).abs() * 3
        b[:, rows:] = 0.0
        x0 = torch.rand((ALP_LANES, n), generator=gen, device=dev)
        y0 = torch.zeros((ALP_LANES, t), device=dev)
        tau, sigma = pdhg_steps(a)
        args = (c, a, b, tau, sigma, x0, y0)
        for average in (False, True):
            plan = pdhg_kernel.kernel_plan(n, t, average)
            row = _pdhg_compare(
                f"random LP {ALP_LANES}x{t}x{n}, average {average}, "
                f"{plan['blocks_per_lane']} block(s) per lane, "
                f"{plan['row_groups']} row groups, {plan['threads']} "
                f"threads, {plan['smem_bytes']} B shared", args, ~inactive,
                average)
            out.append({**row, **plan, "n": n})
        _pdhg_flags(args, ~inactive)
        del a, args
    return out


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
    inactive = torch.arange(ALP_LANES, device=dev) % 3 == 0
    tiers = []
    for n, shapes in ((280, PDHG_TIERS), (H02_N, H02_PDHG_TIERS)):
        tiers += _pdhg_tiers(n, shapes, gen, inactive)
    n = 280
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
    row["tiers"] = tiers
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
    pdhg_kernel.reset_tier_counts()
    t0 = time.perf_counter()
    rows = run_sweep(cfg, device=dev)
    secs = time.perf_counter() - t0
    launches = pdhg_kernel.LAUNCHES
    tiers = dict(sorted(pdhg_kernel.TIER_LAUNCHES.items()))
    res = rows[0][2]
    z = z_score(res.fer, res.total, fer_ref)
    print(f"[6 alp path] run_sweep alp {ALP_SNR} dB, {res.total} trials in "
          f"batches of {default_batch('alp')}: {res.throughput:.1f} cw/s, FER "
          f"{res.fer:.4f} (z = {z:+.2f} against {fer_ref}), average rounds "
          f"{res.sum_iterations / res.total:.3f}, dropped "
          f"{res.sum_dropped}, pdhg_chunk launches {launches}, {secs:.2f} s "
          f"with warm-up", flush=True)
    print(f"[6 alp path] pdhg_chunk launches per row tier T: {tiers}",
          flush=True)
    if launches <= 0 or sum(tiers.values()) != launches:
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
    return launches, tiers


# the AGC-ALP path's kernels: (wrapper module, its launch counter)
AGC_COUNTERS = {"gf2_eliminate": ("gauss_kernel", "LAUNCHES"),
                "gemv_fwd": ("gemv_kernel", "GEMV_LAUNCHES"),
                "gemv_tr": ("gemv_kernel", "GEMV_T_LAUNCHES"),
                "normal_build": ("gemv_kernel", "NORMAL_LAUNCHES"),
                "chol_diag_inv": ("chol_kernel", "LAUNCHES"),
                "ipm_step_len": ("ipm_kernel", "STEP_LEN_LAUNCHES"),
                "ipm_update": ("ipm_kernel", "UPDATE_LAUNCHES")}


# every kernel of the port
ALL_COUNTERS = {"bp_decode": ("bp_kernel", "LAUNCHES"),
                "pdhg_chunk": ("pdhg_kernel", "LAUNCHES"), **AGC_COUNTERS,
                "admm_iterate": ("admm_kernel", "ITERATE_LAUNCHES"),
                "awgn_channel": ("channel_kernel", "LAUNCHES")}


def _agc_counts(reset: bool = False, counters=AGC_COUNTERS) -> dict:
    """Each kernel's launch count (the AGC-ALP kernels unless ``counters``
    says otherwise); with ``reset``, set them to 0."""
    import importlib
    out = {}
    for name, (module, counter) in counters.items():
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
    dec.ipm_graphs = False      # every factor call on the host, recorded
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


def _permuted(h, u, eps):
    """H (m, n) on the card in each lane's fractional-first column order of
    u (B, n): AGC-ALP's input to the elimination."""
    import torch
    from ldpc_tpu_torch.ops.gf2_gauss import fractional_column_order
    bsz, (m, n) = u.shape[0], h.shape
    idx = fractional_column_order(u, eps)[:, None, :].expand(bsz, m, n)
    return h.to(torch.uint8).expand(bsz, m, n).gather(2, idx).contiguous()


def _gauss_xor_words(h_perm, active):
    """The 32-bit word XORs the elimination needs on the active lanes, as
    the twin's loop runs it: for each pivot, the other rows with a 1 in its
    column at that step, times ceil(n / 32) words of a packed row."""
    import torch
    hm = h_perm[active].clone()
    bsz, m, n = hm.shape
    rows = torch.arange(m, device=hm.device)
    rank = torch.zeros((bsz,), dtype=torch.int64, device=hm.device)
    xors = torch.zeros((), dtype=torch.int64, device=hm.device)
    for col in range(n):
        if bsz == 0 or int(rank.min()) >= m:
            break
        cand = (hm[:, :, col] == 1) & (rows >= rank[:, None])
        has = cand.any(dim=1)
        t = cand.to(torch.uint8).argmax(dim=1)
        r = rank.clamp_max(m - 1)
        row_r = hm.gather(1, r[:, None, None].expand(bsz, 1, n))
        row_t = hm.gather(1, t[:, None, None].expand(bsz, 1, n))
        oh_r = ((rows == rank[:, None]) & has[:, None])[..., None]
        oh_t = ((rows == t[:, None]) & has[:, None])[..., None]
        hm = torch.where(oh_r, row_t, torch.where(oh_t, row_r, hm))
        elim = (hm[:, :, col] == 1) & ~oh_r[..., 0] & has[:, None]
        xors += elim.sum()
        hm = hm ^ (elim[..., None].to(torch.uint8) * row_t)
        rank = rank + has.to(torch.int64)
    return int(xors) * -(-n // 32)


def _gauss_case(h_perm, active, label, before_ms):
    """The GF(2) elimination kernel against its twin on one batch: active
    lanes bit-identical, inactive lanes passed through, a second call
    bit-identical; its device time (CUDA graph), its time by events, the
    twin's, and the bound. The kernel's chain is one step per column until
    a lane's rank reaches m: the columns each active lane processes (the
    last row's pivot column + 1 for a lane of full rank, else n) give the
    time per column step, device time over the longest lane's columns."""
    import torch
    from ldpc_tpu_torch.ops.gauss_kernel import gauss_plan, gf2_eliminate
    from ldpc_tpu_torch.ops.gf2_gauss import gf2_eliminate_ordered

    bsz, m, n = h_perm.shape
    got, want = gf2_eliminate(h_perm, active), gf2_eliminate_ordered(h_perm)
    again = gf2_eliminate(h_perm, active)
    torch.cuda.synchronize()
    bad = int((got[active] != want[active]).sum())
    through = torch.equal(got[~active], h_perm[~active])
    repeat = torch.equal(again, got)
    ranks = got[active].any(dim=2).sum(dim=1)
    last_pivot = got[active][:, m - 1, :].to(torch.int32).argmax(dim=1)
    cols = torch.where(ranks == m, last_pivot + 1, n)
    row = {"max_abs_err": float(bad), "shape": label,
           "ms": _time_ms(lambda: gf2_eliminate(h_perm, active)),
           "plain_ms": _time_ms(lambda: gf2_eliminate_ordered(h_perm)),
           "device_ms": _graph_ms(gf2_eliminate,
                                  [(h_perm, active)] * WARM_CALLS),
           "library_ms": None,
           "columns_mean": float(cols.float().mean()),
           "columns_max": int(cols.max())}
    # bytes: H in and out once and the flags; operations: the word XORs of
    # the row reduction on packed rows that this batch needs
    row.update(_bound(2 * h_perm.numel() + active.numel(),
                      _gauss_xor_words(h_perm, active), INT32_OPS_PER_S))
    row["ns_per_column"] = row["device_ms"] * 1e6 / row["columns_max"]
    plan = gauss_plan(m, n)
    print(f"[7 agc-kernels] gf2_eliminate, {label}: {bad} entries differ "
          f"on {int(active.sum())} active lanes, {bsz - int(active.sum())} "
          f"inactive lanes passed through: {through}, repeat bit-identical: "
          f"{repeat}; kernel {row['device_ms']:.5f} ms of device time (CUDA "
          f"graph), {row['ms']:.5f} ms by events"
          + ("" if before_ms is None else
             f" (the first, row-per-thread design: {before_ms} ms by events)")
          + f", twin {row['plain_ms']:.3f} ms; bound {row['bound_ms']:.5f} "
          f"ms by {row['bound_by']}, {row['bound_ms'] / row['device_ms']:.4f}"
          f" of it; columns per active lane {row['columns_mean']:.1f} mean, "
          f"{row['columns_max']} max: {row['ns_per_column']:.1f} ns per "
          f"column step; plan {plan}", flush=True)
    if bad or not through or not repeat:
        raise AssertionError(f"gf2_eliminate disagrees with its twin "
                             f"({label})")
    return row


def _copies(t, nbytes):
    """``t`` and enough copies of it that together they fill twice the L2."""
    return [t] + [t.clone() for _ in range(-(-2 * L2_BYTES // nbytes))]


def _gemv_tiers(a_buf, gen):
    """Phase 7's matvecs. At every row tier T, on the row slice
    ``a_buf[:, :T]`` and its packed int8 copy: each kernel held to its plain
    version on the same copy within the float32 summation bound, and
    bit-identical on a second call; then timed warm (the same inputs again)
    and cold (rotating over copies that fill twice the L2) beside its plain
    version, the one library call on the float32 slice (``bmm``) and the
    pack. Last, a case ragged in every dimension (B = 3, T = 63, n = 283).
    Returns per-tier rows for each kernel and the ragged case's errors."""
    import torch
    from ldpc_tpu_torch.ops.gemv_kernel import (batched_gemv, batched_gemv_t,
                                                pack_rows)
    from ldpc_tpu_torch.ops.gemv_ref import gemv_ref, gemv_t_ref, unpack_rows

    def on_copy(twin, n):
        """The kernel's plain version: the float32 twin on the unpacked
        copy."""
        return lambda m, v: twin(unpack_rows(m, n), v)

    def check(name, kern, twin, a, a8, exact, v, label):
        """Within terms * 2**-23 * |A||v|, terms the length of each sum:
        n for A x, T for A^T y."""
        terms = a.shape[2] if name == "gemv_fwd" else a.shape[1]
        got, again = kern(a8, v), kern(a8, v)
        err, ok = _bounded(got, on_copy(twin, a.shape[2])(a8, v),
                           terms * EPS32 * twin(a.abs(), v))
        same = torch.equal(got, again)
        if not (ok and same and bool(exact)):
            raise AssertionError(f"{name} disagrees with its twin ({label}): "
                                 f"within bound {ok}, repeat identical "
                                 f"{same}, packed copy exact {bool(exact)}")
        return err

    dev = a_buf.device
    bsz, _, n = a_buf.shape
    x = torch.rand((bsz, n), generator=gen, device=dev)
    out = {"gemv_fwd": [], "gemv_tr": []}
    for t in GEMV_TIERS:
        a = a_buf[:, :t]
        y = torch.rand((bsz, t), generator=gen, device=dev)
        a8, exact = pack_rows(a)
        # the bytes of A the function needs: one per entry of the slice,
        # not the copy's pad columns (a layout choice of the kernels)
        i8_bytes, f32_bytes = bsz * t * n, 4 * bsz * t * n
        copies8 = _copies(a8, a8.numel())
        copies32 = _copies(a, f32_bytes)
        pack = {"pack_ms": _graph_ms(pack_rows, [(a,)] * WARM_CALLS),
                "pack_cold_ms": _graph_ms(pack_rows,
                                          [(c,) for c in copies32])}
        cases = (("gemv_fwd", x, batched_gemv, gemv_ref,
                  lambda m, v: torch.bmm(m, v[..., None])),
                 ("gemv_tr", y, lambda m, v: batched_gemv_t(m, v, n),
                  gemv_t_ref, lambda m, v: torch.bmm(v[:, None], m)))
        for name, v, kern, twin, lib in cases:
            err = check(name, kern, twin, a, a8, exact, v, f"T = {t}")
            plain = on_copy(twin, n)
            vec_bytes = 4 * (bsz * n + bsz * t)
            row = {"t": t, "max_abs_err": err, **pack,
                   **_bound(i8_bytes + vec_bytes, 2 * bsz * t * n,
                            F32_OPS_PER_S),
                   "f32_bound_ms": _bound(f32_bytes + vec_bytes,
                                          2 * bsz * t * n,
                                          F32_OPS_PER_S)["bound_ms"],
                   "shape": f"{bsz}x{t}x{n} row slice of a {bsz}x{AGC_CAP}x"
                            f"{n} buffer, packed to int8 {tuple(a8.shape)}"}
            for key, fn, m, rot in (("ms", kern, a8, copies8),
                                    ("plain_ms", plain, a8, copies8),
                                    ("library_ms", lib, a, copies32)):
                row[key] = _graph_ms(fn, [(m, v)] * WARM_CALLS)
                row["cold_" + key] = _graph_ms(fn, [(c, v) for c in rot],
                                               COLD_ROUNDS)
            row["frac"] = row["bound_ms"] / row["cold_ms"]
            row["f32_frac"] = row["f32_bound_ms"] / row["cold_ms"]
            print(f"[7 agc-kernels] {name} T = {t} (int8 "
                  f"{i8_bytes / 1e6:.1f} MB): max |diff| {err:.3e} within "
                  f"bound, repeat bit-identical; warm kernel "
                  f"{row['ms']:.5f} ms, plain {row['plain_ms']:.5f}, bmm "
                  f"{row['library_ms']:.5f}; cold kernel "
                  f"{row['cold_ms']:.5f}, plain {row['cold_plain_ms']:.5f}, "
                  f"bmm {row['cold_library_ms']:.5f}; bound int8 "
                  f"{row['bound_ms']:.5f} ms (cold fraction "
                  f"{row['frac']:.3f}), f32 {row['f32_bound_ms']:.5f} ms "
                  f"({row['f32_frac']:.3f}); pack warm {pack['pack_ms']:.5f} "
                  f"cold {pack['pack_cold_ms']:.5f} ms", flush=True)
            out[name].append(row)
        del copies8, copies32
    # the host's cost per call, which the host-bound path pays at any T
    out["host_us"] = {
        "gemv_fwd": (_host_us(lambda: batched_gemv(a8, x)),
                     _host_us(lambda: torch.bmm(a, x[..., None]))),
        "gemv_tr": (_host_us(lambda: batched_gemv_t(a8, y, n)),
                    _host_us(lambda: torch.bmm(y[:, None], a)))}
    print("[7 agc-kernels] host us per call (wrapper / bmm): " + ", ".join(
        f"{k} {w:.1f} / {b:.1f}" for k, (w, b) in out["host_us"].items()),
        flush=True)
    # ragged in every dimension: a lane-strided slice, n not a multiple of 16
    a = torch.randint(-1, 2, (3, 70, 283), generator=gen,
                      device=dev).float()[:, :63]
    a8, exact = pack_rows(a)
    x = torch.rand((3, 283), generator=gen, device=dev)
    y = torch.rand((3, 63), generator=gen, device=dev)
    ragged = {"gemv_fwd": check("gemv_fwd", batched_gemv, gemv_ref, a, a8,
                                exact, x, "ragged"),
              "gemv_tr": check("gemv_tr",
                               lambda m, v: batched_gemv_t(m, v, 283),
                               gemv_t_ref, a, a8, exact, y, "ragged")}
    print(f"[7 agc-kernels] gemv ragged 3x63x283 (packed {tuple(a8.shape)}): "
          f"max |diff| fwd {ragged['gemv_fwd']:.3e}, tr "
          f"{ragged['gemv_tr']:.3e}, within bound, repeat bit-identical",
          flush=True)
    out["gemv_ragged"] = ragged
    return out


def _normal_tiers(a_buf, gen):
    """Phase 7's normal matrix. At each of NORMAL_TIERS, on the packed int8
    copy of the row slice ``a_buf[:, :T]`` with d over 1e-8...1e8: the
    kernel held to ``normal_ref`` on the float32 slice within the float32
    summation bound T * 2**-23 * normal_ref(|a|, d, dxx) per entry (the
    largest share of it used is printed), M
    exactly symmetric and a second call bit-identical; then timed as CUDA
    graphs of calls (device time), warm (the same inputs again) and cold
    (rotating over copies of the packed rows that fill twice the L2),
    beside its plain version (``normal_ref`` on the unpacked copy), the one
    library call for the product (``baddbmm`` on the float32 slice, A d and
    the diagonal made outside the timed call) and the bound. Last, a slice
    ragged in every dimension (3 x 63 x 283). Returns the per-tier rows and
    the ragged case's error."""
    import torch
    from ldpc_tpu_torch.ops.gemv_kernel import normal_build, pack_rows
    from ldpc_tpu_torch.ops.gemv_ref import normal_ref, unpack_rows

    delta = 1e-6

    def check(a, a8, exact, d, dxx, label):
        n = a.shape[2]
        got, again = (normal_build(a8, d, dxx, delta, n) for _ in range(2))
        want = normal_ref(a, d, dxx, delta)
        bound = a.shape[1] * EPS32 * normal_ref(a.abs(), d, dxx, delta)
        err, ok = _bounded(got, want, bound)
        used = float(torch.nan_to_num((got - want).abs() / bound).max())
        same = torch.equal(got, again)
        sym = torch.equal(got, got.transpose(1, 2))
        if not (ok and same and sym and bool(exact)):
            raise AssertionError(
                f"normal_build disagrees with its twin ({label}): within "
                f"bound {ok}, repeat identical {same}, symmetric {sym}, "
                f"packed copy exact {bool(exact)}")
        return err, used

    def weights(bsz, t, n):
        d = 10.0 ** (torch.rand((bsz, t), generator=gen, device=dev)
                     * 16.0 - 8.0)
        dxx = 10.0 ** (torch.rand((bsz, n), generator=gen, device=dev)
                       * 8.0 - 4.0)
        return d, dxx

    dev = a_buf.device
    bsz, _, n = a_buf.shape
    out = []
    for t in NORMAL_TIERS:
        a = a_buf[:, :t]
        d, dxx = weights(bsz, t, n)
        a8, exact = pack_rows(a)
        err, used = check(a, a8, exact, d, dxx, f"T = {t}")
        copies8 = _copies(a8, a8.numel())
        # the one library call, A^T (A d) + diag
        a_d = a * d[..., None]
        base = torch.diag_embed(dxx + delta)
        # bytes: the int8 rows, d, dxx in, M out; operations: three bf16
        # planes on the tiles on or above the diagonal, two per multiply-add
        row = {"t": t, "max_abs_err": err, "err_over_bound": used,
               **_bound(bsz * t * n + 4 * bsz * (t + n) + 4 * bsz * n * n,
                        3 * bsz * t * n * (n + 1), BF16_OPS_PER_S),
               "f32_bound_ms": _bound(
                   4 * (a.numel() + d.numel() + dxx.numel())
                   + 4 * bsz * n * n, bsz * t * n * (n + 1),
                   F32_OPS_PER_S)["bound_ms"],
               "shape": f"{bsz}x{t}x{n} row slice packed to int8 "
                        f"{tuple(a8.shape)} -> {bsz}x{n}x{n}, d over "
                        f"1e-8..1e8, device time (CUDA graph)"}
        row["warm_ms"] = _graph_ms(
            lambda m: normal_build(m, d, dxx, delta, n), [(a8,)] * WARM_CALLS)
        row["ms"] = _graph_ms(lambda m: normal_build(m, d, dxx, delta, n),
                              [(c,) for c in copies8], COLD_ROUNDS)
        row["plain_ms"] = _graph_ms(
            lambda m: normal_ref(unpack_rows(m, n), d, dxx, delta),
            [(a8,)] * WARM_CALLS)
        row["library_ms"] = _graph_ms(
            lambda m: torch.baddbmm(base, m.transpose(1, 2), a_d),
            [(a,)] * WARM_CALLS)
        print(f"[7 agc-kernels] normal_build T = {t}: max |diff| {err:.3e} "
              f"within bound (at most {used:.4f} of it), symmetric, repeat "
              f"bit-identical; kernel warm "
              f"{row['warm_ms']:.5f} ms, cold {row['ms']:.5f}, plain "
              f"{row['plain_ms']:.5f}, baddbmm {row['library_ms']:.5f}; "
              f"bound {row['bound_ms']:.5f} ms by {row['bound_by']} "
              f"(fraction {row['bound_ms'] / row['ms']:.3f}), f32 FMA bound "
              f"{row['f32_bound_ms']:.5f} ms", flush=True)
        out.append(row)
        del copies8, a_d, base
    a = torch.randint(-1, 2, (3, 70, 283), generator=gen,
                      device=dev).float()[:, :63]
    a8, exact = pack_rows(a)
    d, dxx = weights(3, 63, 283)
    ragged, used = check(a, a8, exact, d, dxx, "ragged")
    print(f"[7 agc-kernels] normal_build ragged 3x63x283 (packed "
          f"{tuple(a8.shape)}): max |diff| {ragged:.3e} within bound (at "
          f"most {used:.4f} of it), symmetric, repeat bit-identical",
          flush=True)
    return out, ragged


def _ipm_case(lanes, t, n, gen):
    """A Newton step's inputs: ``lanes`` lanes of interior values and
    random directions at T rows and n columns, and special lanes: NaN in
    dx (1) and in dy (2), infinite directions (3), all-positive
    directions, so both steps are 1 (4), one ratio in many
    places (5), directions so small that the steps clamp to 1 (6), steps
    past the box and the floors (7). Step lengths for the update drawn in
    [0, 1.2)."""
    import torch
    dev = torch.device("cuda")
    inf = float("inf")

    def pos(w):
        return torch.rand((lanes, w), generator=gen, device=dev) * 5.0 + 1e-3

    def dirs(w):
        return torch.randn((lanes, w), generator=gen, device=dev) * 2.0

    x = torch.rand((lanes, n), generator=gen, device=dev) * 0.998 + 1e-3
    v = {"s": pos(t), "x": x, "y": pos(t), "zl": pos(n), "zu": pos(n)}
    d = {"ds": dirs(t), "dx": dirs(n), "dy": dirs(t), "dzl": dirs(n),
         "dzu": dirs(n), "adx": dirs(t)}
    d["dx"][1, 3] = float("nan")
    d["dy"][2, -1] = float("nan")
    d["ds"][3, 2], d["dx"][3, 1] = -inf, -inf
    d["dy"][3, 0], d["dzl"][3, 0] = inf, inf
    for k in ("ds", "dy", "dzl", "dzu"):
        d[k][4] = d[k][4].abs()
    d["dx"][4] = 0.0
    for k in ("s", "y"):
        v[k][5, ::3] = 0.75
    for k in ("ds", "dy"):
        d[k][5, ::3] = -1.5
    v["x"][5, ::4], d["dx"][5, ::4] = 0.25, -0.5
    v["zl"][5, ::5], d["dzl"][5, ::5] = 1.0, -2.0
    for k in d:
        d[k][6] *= 1e-5
    d["dx"][7] = torch.where(d["dx"][7] < 0, -4.0, 4.0)
    d["ds"][7], d["dy"][7] = -10.0, -10.0
    v["w"] = 1.0 - v["x"]
    v["ax"] = torch.randn((lanes, t), generator=gen, device=dev) * 3.0
    ap = torch.rand(lanes, generator=gen, device=dev) * 1.2
    ad = torch.rand(lanes, generator=gen, device=dev) * 1.2
    return v, d, ap, ad


def _ipm_step_tiers(gen):
    """Phase 7's IPM step kernels at each shape of IPM_SHAPES: the step
    lengths and the masked update held to their twins bit for bit (NaN,
    inf, all-positive, tied, clamped lanes included), then timed as CUDA
    graphs of calls (device time) cold (rotating over copies of every
    input that fill twice the L2: the bound's HBM bytes) and warm (the same
    inputs each call, in L2 as on the solve's path, where the Newton step
    has just written them), and by events (with the host's launch), beside
    the twins' ~50 and ~30 eager ops (cold, counted and by events) and the
    launch floor: an empty kernel of the same grid
    (``ipm_kernel.empty_kernel``) as a CUDA graph of calls. Bound: bytes
    (each input read once, each output written once, ``step_len_bytes`` /
    ``update_bytes``) over the HBM rate. Returns per-shape rows for each
    kernel."""
    import torch
    from ldpc_tpu_torch.ops.ipm_kernel import (empty_kernel, ipm_step_len,
                                               ipm_step_plan, ipm_update,
                                               step_len_bytes, update_bytes)
    from ldpc_tpu_torch.ops.ipm_ref import ipm_step_len_ref, ipm_update_ref

    def same(a, b):
        return torch.equal(a.view(torch.int32), b.view(torch.int32))

    def rotation(call, nbytes):
        """``call`` and copies of its tensors that fill twice the L2."""
        def clone(a):
            return (tuple(u.clone() for u in a) if isinstance(a, tuple)
                    else a.clone())
        return [call] + [tuple(clone(a) for a in call)
                         for _ in range(-(-2 * L2_BYTES // nbytes))]

    rows = {"ipm_step_len": [], "ipm_update": []}
    dev = torch.device("cuda")
    for lanes, t, n in IPM_SHAPES:
        v, d, ap, ad = _ipm_case(lanes, t, n, gen)
        args = (v["s"], d["ds"], v["x"], d["dx"], v["w"], v["y"], d["dy"],
                v["zl"], d["dzl"], v["zu"], d["dzu"])
        state = tuple(v[k] for k in ("x", "w", "s", "y", "zl", "zu", "ax"))
        dirs = tuple(d[k] for k in ("dx", "dy", "ds", "dzl", "dzu", "adx"))
        got, want = ipm_step_len(*args), ipm_step_len_ref(*args)
        got_u = ipm_update(tuple(u.clone() for u in state), dirs, ap, ad)
        want_u = ipm_update_ref(state, dirs, ap, ad)
        torch.cuda.synchronize()
        exact = (all(same(g, w) for g, w in zip(got, want)),
                 all(same(g, w) for g, w in zip(got_u, want_u)))
        special = (float(got[0][4]) == float(got[1][4]) == 1.0
                   and float(got[0][6]) == float(got[1][6]) == 1.0
                   and same(got_u[2][1], state[2][1].clamp_min(1e-12))
                   and same(got_u[6][2], state[6][2])
                   and bool(torch.isfinite(got_u[0]).all()))
        plan = ipm_step_plan(lanes, t, n, all(
            u.data_ptr() % 16 == 0 for u in (*args, *state, *dirs)))
        floor_ms = _graph_ms(lambda: empty_kernel(plan, dev),
                             [()] * WARM_CALLS)
        timed = {
            "ipm_step_len": (ipm_step_len, ipm_step_len_ref, args,
                             step_len_bytes(lanes, t, n)),
            "ipm_update": (ipm_update, ipm_update_ref,
                           (tuple(u.clone() for u in state), dirs, ap, ad),
                           update_bytes(lanes, t, n))}
        for (name, (kern, twin, call, nbytes)), ok in zip(timed.items(),
                                                          exact):
            cold = rotation(call, nbytes)
            row = {"max_abs_err": 0.0, "library_ms": None, "t": t,
                   "n": n, "lanes": lanes, "plan": plan,
                   "floor_ms": floor_ms,
                   "shape": f"{lanes}x{t}x{n} f32 (rows x columns per lane)",
                   "ms": _graph_ms(kern, cold, COLD_ROUNDS),
                   "warm_ms": _graph_ms(kern, [call] * WARM_CALLS),
                   "plain_ms": _graph_ms(twin, cold, COLD_ROUNDS),
                   "events_ms": _time_ms(lambda: kern(*call)),
                   "plain_events_ms": _time_ms(lambda: twin(*call)),
                   "plain_launches": _launches(lambda: twin(*call)),
                   **_bound(nbytes, 0, F32_OPS_PER_S)}
            del cold
            print(f"[7 agc-kernels] {name} {row['shape']}, plan {plan}: "
                  f"bit for bit with its twin {ok} (special lanes "
                  f"{special}); device {row['ms']:.6f} ms cold, "
                  f"{row['warm_ms']:.6f} ms warm (CUDA graphs; launch "
                  f"floor {floor_ms:.6f}), {row['events_ms']:.5f} ms by "
                  f"events; twin {row['plain_launches']} eager ops, "
                  f"{row['plain_ms']:.5f} ms device cold, "
                  f"{row['plain_events_ms']:.5f} ms by events; bound "
                  f"{row['bound_ms']:.6f} ms by {row['bound_by']} "
                  f"({row['bound_ms'] / row['ms']:.3f} of the cold time)",
                  flush=True)
            if not (ok and special):
                raise AssertionError(f"{name} differs from its twin at "
                                     f"{row['shape']}")
            rows[name].append(row)
    return rows


def phase_agc_kernels_vs_ref():
    import torch
    from ldpc_tpu_torch import bench
    from ldpc_tpu_torch.codes.gf2 import gf2_nullspace
    from ldpc_tpu_torch.codes.io import read_pcm
    from ldpc_tpu_torch.ops.chol import blocked_cho_solve, blocked_cholesky
    from ldpc_tpu_torch.ops.chol_kernel import chol_diag_inv
    from ldpc_tpu_torch.ops.chol_ref import chol_diag_inv_ref, cholesky_nan

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

    # the GF(2) elimination on a real IPM solution, on H02 and on a ragged
    # shape, a third of the lanes inactive in each
    dec, st, m_real = _agc_batch(h, g, 3)
    u = st["x"]
    frac = ((u >= dec.gauss_eps) & (u <= 1.0 - dec.gauss_eps)).sum(dim=1)
    active = torch.arange(AGC_LANES, device=dev) % 3 != 0
    gen = torch.Generator(device=dev).manual_seed(7)
    h02 = torch.from_numpy(read_pcm(str(bench.MATRIX.parent / "H02.txt")))
    u02 = torch.rand((AGC_LANES, h02.shape[1]), generator=gen, device=dev)
    u02[torch.rand(u02.shape, generator=gen, device=dev) < 0.25] = 0.0
    u02[torch.rand(u02.shape, generator=gen, device=dev) < 0.05] = 1.0
    ragged = (torch.rand((AGC_LANES, *GAUSS_RAGGED), generator=gen,
                         device=dev) < 0.1).to(torch.uint8)
    rows["gf2_eliminate"] = [
        _gauss_case(_permuted(dec.h, u, dec.gauss_eps), active,
                    f"optimalH {AGC_LANES}x{m_rows}x{n} uint8, IPM solution "
                    f"after 3 cut rounds at -3 dB (fractional columns per "
                    f"lane {frac.float().mean().item():.1f})", FIRST_GAUSS_MS),
        _gauss_case(_permuted(h02.to(dev), u02, dec.gauss_eps), active,
                    f"H02 {AGC_LANES}x{h02.shape[0]}x{h02.shape[1]} uint8, "
                    f"seeded LP points", None),
        _gauss_case(ragged, active,
                    f"ragged {AGC_LANES}x{GAUSS_RAGGED[0]}x"
                    f"{GAUSS_RAGGED[1]} uint8, seeded entries 1 with "
                    f"probability 0.1", None)]

    # A x, A^T y and the normal matrix on the packed copy of row slices of
    # a full buffer
    gen = torch.Generator(device=dev).manual_seed(13)
    a_buf = torch.randint(-1, 2, (AGC_LANES, AGC_CAP, n), generator=gen,
                          device=dev).float()
    rows.update(_gemv_tiers(a_buf, gen))
    rows["normal_build"], rows["normal_ragged"] = _normal_tiers(a_buf, gen)

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
    # bytes: the blocks in, the factor and its inverse out; operations: nb^3/3
    # for the factor and as many for the triangular inverse, per block
    rows["chol_diag_inv"][-1].update(library_ms=None, **_bound(
        3 * 4 * blocks.numel(), (AGC_LANES + 1) * 2 * nb ** 3 / 3,
        F32_OPS_PER_S))
    # a kernel of microseconds: beside its time by events (``ms``, as in
    # earlier runs) its device time as a CUDA graph of calls, without the
    # host's cost of each launch
    chol_row = rows["chol_diag_inv"][-1]
    chol_row["device_ms"] = _graph_ms(chol_diag_inv, [(blocks,)] * WARM_CALLS)
    print(f"[7 agc-kernels] chol_diag_inv {chol_row['ms']:.5f} ms by events, "
          f"{chol_row['device_ms']:.5f} ms of device time (CUDA graph) per "
          f"call; bound {chol_row['bound_ms']:.5f} ms by "
          f"{chol_row['bound_by']}", flush=True)

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
    rows.update(_ipm_step_tiers(gen))
    return rows


class _HostReads:
    """Counts the host's waits on the card (reads back to the host and the
    runners' synchronisations) as the warnings of torch's sync debug
    mode."""

    def __enter__(self):
        import warnings
        import torch
        self._catch = warnings.catch_warnings(record=True)
        self._seen = self._catch.__enter__()
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        self.n = 0
        return self

    def __exit__(self, *exc):
        import torch
        torch.cuda.set_sync_debug_mode("default")
        self.n = sum("synchroniz" in str(w.message) for w in self._seen)
        self._catch.__exit__(*exc)


def _launch_counts(fn):
    """Runs ``fn`` and counts what it sends to the card: (host launches,
    device operations, graphs captured meanwhile). Both count the ATen
    operations that are not views (each launches about one kernel; this
    counts dispatches, not kernels) and the hand-written kernels' launches
    made outside a CUDA graph; then the host adds one launch per graph
    replay and the device each replay's kernel, copy and memset nodes.
    Without graphs the two are equal. A graph captured inside ``fn`` would
    add its warm-up's and capture's dispatches: callers run ``fn`` once
    before."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from ldpc_tpu_torch.ops import ipm_graph

    class Ops(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not func.is_view:
                self.n += 1
            return func(*args, **(kwargs or {}))

    def tallies():
        return (sum(_agc_counts(counters=ALL_COUNTERS).values()),
                ipm_graph.CALLS, ipm_graph.REPLAYS, ipm_graph.NODES,
                ipm_graph.CAPTURES)

    before = tallies()
    with Ops() as ops:
        fn()
    kern, calls, replays, nodes, captures = (
        a - b for a, b in zip(tallies(), before))
    outside = ops.n + kern - calls
    return outside + replays, outside + nodes, captures


def _launches(fn):
    """The host launches of ``fn`` (:func:`_launch_counts`)."""
    return _launch_counts(fn)[0]


class _LaneLog:
    """Records, after each streamed cut round of AGC-ALP, every lane that
    finished in it: its bits, success, rounds, ``cum_h``, ``cum_g`` and
    dropped cuts (-1 in the lanes that did not finish), on the device. Two
    streamed runs of the same trials decode alike lane by lane exactly when
    their records are equal."""

    def __enter__(self):
        import torch
        from ldpc_tpu_torch.decoders.agc_alp import AGCALPDecoder as cls
        chunk = cls.stream_chunk
        self.cls, self.rows = cls, []
        log = self

        def stream_chunk(dec, st):
            before = st["done"].clone()
            st = chunk(dec, st)
            res = dec._finish(st)
            rec = torch.cat([res.bits.to(torch.int32),
                             res.success[:, None].to(torch.int32)]
                            + [st[k][:, None].to(torch.int32) for k in
                               ("rounds", "cum_h", "cum_g", "dropped")],
                            dim=1)
            log.rows.append(torch.where((st["done"] & ~before)[:, None],
                                        rec, -1))
            return st

        cls.stream_chunk = stream_chunk
        return self

    def __exit__(self, *exc):
        del self.cls.stream_chunk

    def same_as(self, other) -> tuple[bool, int]:
        """(equal records, the first round whose records differ or -1)."""
        import torch
        for i, (a, b) in enumerate(zip(self.rows, other.rows)):
            if not torch.equal(a, b):
                return False, i
        if len(self.rows) != len(other.rows):
            return False, min(len(self.rows), len(other.rows))
        return True, -1


class _CutTally:
    """Sums AGC-ALP's ``cum_h`` and ``cum_g`` over the trials a run
    finishes, on the device, around the decoder's own methods: in a
    streamed run each lane in the ``stream_chunk`` that finishes it, in a
    batched run every lane of each ``_run_loop``. The first ``skip`` chunks
    are left out (the streamed runner's warm-up is one chunk)."""

    def __init__(self, skip: int = 0):
        self.skip = skip

    def __enter__(self):
        import torch
        from ldpc_tpu_torch.decoders.agc_alp import AGCALPDecoder as cls
        chunk, loop = cls.stream_chunk, cls._run_loop
        self.cls, self.sums, self.chunks = cls, None, 0
        tally = self

        def add(st, lanes):
            got = [(st[k] * lanes).sum() for k in ("cum_h", "cum_g")]
            got.append(lanes.sum())
            tally.sums = got if tally.sums is None else [
                a + b for a, b in zip(tally.sums, got)]

        def stream_chunk(dec, st):
            before = st["done"].clone()
            st = chunk(dec, st)
            tally.chunks += 1
            if tally.chunks > tally.skip:
                add(st, st["done"] & ~before)
            return st

        def run_loop(dec, llrs):
            st = loop(dec, llrs)
            add(st, torch.ones_like(st["done"]))
            return st

        cls.stream_chunk, cls._run_loop = stream_chunk, run_loop
        return self

    def __exit__(self, *exc):
        del self.cls.stream_chunk, self.cls._run_loop

    def per_trial(self, trials):
        """Mean ``cum_h`` and ``cum_g`` per trial; the tally must have seen
        each of the run's ``trials`` finish once."""
        cum_h, cum_g, lanes = (int(x) for x in self.sums)
        if lanes != trials:
            raise AssertionError(f"the cut tally saw {lanes} lanes finish, "
                                 f"the run {trials}")
        return cum_h / trials, cum_g / trials


def _agc_line(label, res, fer_ref, cuts, reads, secs):
    from ldpc_tpu_torch.harness.reference_data import z_score
    z = z_score(res.fer, res.total, fer_ref)
    cum_h, cum_g = cuts.per_trial(res.total)
    per = AGC_LANES / res.total
    print(f"[8 agc path] {label}: {res.total} trials, FER {res.fer:.4f} (z = "
          f"{z:+.2f} against {fer_ref}), mean rounds "
          f"{res.sum_iterations / res.total:.3f}, mean cum_h {cum_h:.3f} / "
          f"cum_g {cum_g:.3f}, dropped {res.sum_dropped}, "
          f"{res.throughput:.2f} cw/s, host syncs {reads.n} "
          f"({reads.n * per:.1f} per {AGC_LANES} trials), {secs:.2f} s",
          flush=True)
    return z


def phase_agc_path():
    import torch
    from ldpc_tpu_torch import bench
    from ldpc_tpu_torch.apps.benchmark import run_sweep
    from ldpc_tpu_torch.channel.awgn import gen_random_codewords
    from ldpc_tpu_torch.codes.gf2 import gf2_nullspace
    from ldpc_tpu_torch.codes.io import read_pcm
    from ldpc_tpu_torch.config import SweepConfig
    from ldpc_tpu_torch.decoders import default_batch
    from ldpc_tpu_torch.decoders.agc_alp import AGCALPDecoder
    from ldpc_tpu_torch.harness.experiment import COUNTERS, run_experiment
    from ldpc_tpu_torch.harness.reference_data import (REF_FER_OPT, SNR_GRID,
                                                       Z_BOUND, z_score)
    from ldpc_tpu_torch.ops import gemv_kernel, ipm_graph, ipm_solver

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats(dev)
    fer_ref = REF_FER_OPT["AGC-ALP"][SNR_GRID.index(AGC_SNR)]
    cfg = SweepConfig(matrix=str(bench.MATRIX), decoders=("agc-alp",),
                      snrs=(AGC_SNR,), trials=AGC_TRIALS,
                      report="build/chip_smoke_agc.csv",
                      extended_report="build/chip_smoke_agc_extended.csv")
    os.makedirs("build", exist_ok=True)
    _agc_counts(reset=True)
    gemv_kernel.reset_tier_counts()
    captures = ipm_graph.CAPTURES
    with _CutTally(skip=1) as cuts, _HostReads() as reads:
        t0 = time.perf_counter()
        rows = run_sweep(cfg, device=dev)
        secs = time.perf_counter() - t0
    launches = _agc_counts()
    tiers = {"gemv_fwd": dict(sorted(gemv_kernel.GEMV_TIER_LAUNCHES.items())),
             "gemv_tr": dict(sorted(gemv_kernel.GEMV_T_TIER_LAUNCHES.items())),
             "normal_build": dict(sorted(
                 gemv_kernel.NORMAL_TIER_LAUNCHES.items()))}
    res = rows[0][2]
    z = _agc_line(f"run_sweep agc-alp {AGC_SNR} dB, batches of "
                  f"{default_batch('agc-alp')}, streamed (the default), the "
                  f"IPM as CUDA graphs (the default)", res, fer_ref, cuts,
                  reads, secs)
    print(f"[8 agc path] streamed run's launches {launches}; per row tier "
          f"T: {tiers}; IPM graphs captured in the run "
          f"{ipm_graph.CAPTURES - captures} (four per solve shape)",
          flush=True)
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
    cw = gen_random_codewords(g, AGC_TRIALS,
                              torch.Generator().manual_seed(cfg.seed), dev)

    def decoder(graphs):
        dec = AGCALPDecoder(h, device=dev)
        dec.ipm_graphs = None if graphs else False
        return dec

    def run(dec, trials, streaming):
        return run_experiment(dec, h, cw[:trials], AGC_SNR, cfg.seed + 1,
                              AGC_LANES, device=dev, warmup=False,
                              streaming=streaming)

    # the same trials with the IPM as CUDA graphs and as the eager loop:
    # equal lane by lane, equal launches of every kernel
    ab = {}
    for mode in ("graph", "eager"):
        dec = decoder(mode == "graph")
        _agc_counts(reset=True)
        with _LaneLog() as log:
            t0 = time.perf_counter()
            out = run(dec, AGC_TRIALS, True)
            secs = time.perf_counter() - t0
        ab[mode] = (out, log, _agc_counts())
        print(f"[8 agc path] {mode}: {out.total} trials streamed, FER "
              f"{out.fer:.4f} (z = {z_score(out.fer, out.total, fer_ref):+.2f}"
              f"), mean rounds {out.sum_iterations / out.total:.3f}, "
              f"{out.throughput:.2f} cw/s ({secs:.2f} s, the lane log on), "
              f"launches {ab[mode][2]}", flush=True)
    (gres, glog, gl), (eres, elog, el) = ab["graph"], ab["eager"]
    lanes_same, first = glog.same_as(elog)
    same_counters = all(getattr(gres, k) == getattr(eres, k)
                        for k in COUNTERS)
    print(f"[8 agc path] graph vs eager on the same {AGC_TRIALS} trials: "
          f"every lane's bits, success, rounds, cum_h, cum_g and dropped "
          f"equal {lanes_same} (first differing round {first}, of "
          f"{len(glog.rows)} / {len(elog.rows)}); counters equal "
          f"{same_counters}; every kernel's launches equal {gl == el}",
          flush=True)
    if not (lanes_same and same_counters and gl == el):
        raise AssertionError("AGC-ALP with the IPM as CUDA graphs differs "
                             "from the eager loop")

    # the first AGC_BATCHED of those trials on the batched runner, then the
    # launches per AGC_LANES trials of each runner and mode, counted apart
    # (after one uncounted run, so that no graph is captured inside)
    with _CutTally() as bcuts, _HostReads() as breads:
        t0 = time.perf_counter()
        bres = run(decoder(True), AGC_BATCHED, False)
        bsecs = time.perf_counter() - t0
    _agc_line(f"run_experiment(streaming=False), the first {AGC_BATCHED} "
              f"trials, batched", bres, fer_ref, bcuts, breads, bsecs)
    if bres.sum_dropped != 0:
        raise AssertionError(f"batched AGC-ALP dropped {bres.sum_dropped}")
    per = {}
    for mode in ("graph", "eager"):
        dec = decoder(mode == "graph")
        for label, trials, streaming in (("streamed", 2 * AGC_LANES, True),
                                         ("batched", AGC_LANES, False)):
            if mode == "graph":
                run(dec, trials, streaming)
            host, device, caught = _launch_counts(
                lambda: run(dec, trials, streaming))
            per[mode, label] = (host * AGC_LANES / trials,
                                device * AGC_LANES / trials, caught)
    print(f"[8 agc path] launches per {AGC_LANES} trials (non-view ATen "
          f"operations plus the hand-written kernels outside a graph, plus "
          f"one per graph replay on the host or the replay's kernel, copy "
          f"and memset nodes on the device; counted on {2 * AGC_LANES} "
          f"trials streamed and {AGC_LANES} batched): " + "; ".join(
              f"{mode} {label} host {h_:.1f}, device {d_:.1f} (graphs "
              f"captured inside {c_})" for (mode, label), (h_, d_, c_)
              in per.items()), flush=True)
    ratio = per["graph", "streamed"][0] / per["eager", "streamed"][0]
    print(f"[8 agc path] host launches streamed, graph / eager: {ratio:.4f} "
          f"(bound 0.1); IPM solve shapes captured "
          f"{len(ipm_solver._graph_solves)}, peak device memory in the phase "
          f"{torch.cuda.max_memory_allocated(dev) / 2 ** 30:.3f} GiB "
          f"(reserved {torch.cuda.memory_reserved(dev) / 2 ** 30:.3f} GiB)",
          flush=True)
    if not ratio <= 0.1:
        raise AssertionError(f"graph host launches are {ratio:.4f} of the "
                             f"eager run's")

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
    return launches, tiers


def phase_h02_alp():
    import torch
    from ldpc_tpu_torch import bench
    from ldpc_tpu_torch.apps.benchmark import run_sweep
    from ldpc_tpu_torch.config import SweepConfig
    from ldpc_tpu_torch.ops import pdhg_kernel

    dev = torch.device("cuda")
    cfg = SweepConfig(matrix=str(bench.MATRIX.parent / "H02.txt"),
                      decoders=("alp",), snrs=(H02_SNR,), trials=H02_TRIALS,
                      batch_size=H02_TRIALS,
                      report="build/chip_smoke_h02.csv",
                      extended_report="build/chip_smoke_h02_extended.csv")
    os.makedirs("build", exist_ok=True)
    pdhg_kernel.LAUNCHES = 0
    pdhg_kernel.reset_tier_counts()
    t0 = time.perf_counter()
    rows = run_sweep(cfg, device=dev)
    secs = time.perf_counter() - t0
    launches = pdhg_kernel.LAUNCHES
    tiers = dict(sorted(pdhg_kernel.TIER_LAUNCHES.items()))
    res = rows[0][2]
    print(f"[9 h02 alp] run_sweep alp on H02 (520x640) {H02_SNR} dB, "
          f"{res.total} trials in one batch: {res.throughput:.1f} cw/s, FER "
          f"{res.fer:.4f} (no golden FER for H02), average rounds "
          f"{res.sum_iterations / res.total:.3f}, dropped {res.sum_dropped}, "
          f"pdhg_chunk launches {launches}, {secs:.2f} s with warm-up",
          flush=True)
    blocks = {t: pdhg_kernel.kernel_plan(H02_N, t)["blocks_per_lane"]
              for t in tiers}
    print(f"[9 h02 alp] pdhg_chunk launches per row tier T: {tiers}; blocks "
          f"per lane by T: {blocks}", flush=True)
    if launches <= 0 or sum(tiers.values()) != launches or max(tiers) < 640:
        raise AssertionError(f"ALP on H02 did not launch the PDHG kernel at "
                             f"T >= 640: {tiers}")
    if res.total != H02_TRIALS or res.sum_dropped != 0:
        raise AssertionError(f"ALP on H02: {res.total} trials, "
                             f"{res.sum_dropped} cuts dropped")
    if not (0.0 <= res.fer <= 1.0 and 0.0 < res.throughput < float("inf")):
        raise AssertionError(f"ALP on H02: FER {res.fer}, throughput "
                             f"{res.throughput}")
    return launches, tiers


def _path_counts(phase, counts, need=()):
    """Prints each kernel's launches on a phase's path (counted from 0
    just before it); the kernels in ``need`` must have launched."""
    print(f"[{phase}] kernel launches on this path: {counts}", flush=True)
    missing = [k for k in need if counts[k] <= 0]
    if missing:
        raise AssertionError(f"the path did not launch {missing}")


def _same_counters(a, b) -> bool:
    from ldpc_tpu_torch.harness.experiment import COUNTERS
    return all(getattr(a, k) == getattr(b, k) for k in COUNTERS)


def _admm_start(dec, llr):
    """Fresh (q, v, z, yl, done, it) of ``dec`` for ``llr``, a population
    of one."""
    st = dec.stream_init(llr)
    return (st["q"], st["v"], st["z"], st["yl"], st["done"][:, None],
            st["it"][:, None])


def _admm_states_vs_twin(dec, llr, iters_list, label=""):
    """The iteration kernel against its twin on the card from fresh lanes
    of ``llr`` (B, n): the state after each of ``iters_list`` iterations
    (``dec.max_iter`` among them: the batched decode, its bits too), equal
    on every lane but sum2 ties (printed); any other difference fails.
    Returns the largest |difference| in v, z and yl."""
    import torch
    from ldpc_tpu_torch.ops import admm_kernel
    from ldpc_tpu_torch.ops.admm_ref import admm_iterate_ref, stop_ties
    kern, twin = admm_kernel.admm_iterate, admm_iterate_ref
    start = _admm_start(dec, llr)
    tables = dec._population()
    args = (tables, dec.alpha, dec.mu, dec.eps_stop, dec.max_iter)
    bsz = llr.shape[0]
    err = 0.0
    for iters in iters_list:
        t0 = time.perf_counter()
        got = kern(*(t.clone() for t in start), *args, iters)
        want = twin(*start, *args, iters)
        ties, others = stop_ties(start, got, want, *args[:4], kern, twin)
        keep = torch.ones((bsz, 1), dtype=torch.bool, device=llr.device)
        for lane, cand, *_ in ties:
            keep[lane, cand] = False
        same = {}
        for key, a, b in zip(("v", "z", "yl", "done", "it"), got, want):
            a, b = a.view(bsz, 1, -1)[keep], b.view(bsz, 1, -1)[keep]
            same[key] = torch.equal(a, b)
            if key in ("v", "z", "yl"):
                err = max(err, float((a - b).abs().max()))
        label_it = ("the batched decode" if iters == dec.max_iter else
                    f"{iters} iterations")
        extra = ""
        if iters == dec.max_iter:       # the decode's bits, as it reads v
            bits = [r[0][:, :dec.n][keep[:, 0]] > 0.5 for r in (got, want)]
            same["bits"] = torch.equal(*bits)
            extra = f", mean iterations {float(got[4].float().mean()):.1f}"
        print(f"[10 qp-admm path] admm_iterate against its twin, {bsz} "
              f"lanes{label}, {label_it} (max_iter {dec.max_iter}): equal "
              f"outside "
              f"ties {same}{extra}; lanes done {int(got[3].sum())}; sum2 "
              f"ties (lane, candidate, iteration, kernel sum2, twin sum2) "
              f"{ties}; other differences {others}; "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        if others or not all(same.values()):
            raise AssertionError(f"admm_iterate differs from its twin: "
                                 f"{same}, {others}")
    return err


def _admm_ms(dec, llr) -> float:
    """Device ms per iteration of one ADMM_TIMED_ITERS-iteration launch of
    the kernel from fresh lanes of ``llr``, no lane stopping (events)."""
    from ldpc_tpu_torch.ops import admm_kernel
    start = _admm_start(dec, llr)
    tables = dec._population()
    never = (float("-inf"), 2 ** 31 - 1)
    copies = [tuple(t.clone() for t in start) for _ in range(REPEATS + 1)]
    return _time_ms(lambda: admm_kernel.admm_iterate(
        *copies.pop(), tables, dec.alpha, dec.mu, *never,
        ADMM_TIMED_ITERS)) / ADMM_TIMED_ITERS


def _admm_kernel_vs_twin(dec, llr):
    """Phase 10's check of QP-ADMM's iteration kernel against its twin on
    the card at the batch's width (``llr`` (B, n) on the card, ``dec`` at
    the defaults): the state after ADMM_STATE_ITERS iterations from fresh
    lanes and the batched decode's state at ``dec.max_iter``, each equal on
    every lane but sum2 ties (printed); then device ms per iteration of one
    ADMM_TIMED_ITERS-iteration launch with no lane stopping (events), the
    twin's over ADMM_TWIN_ITERS, and the bound. Returns the JSON row's
    numbers."""
    from ldpc_tpu_torch.ops import admm_kernel
    from ldpc_tpu_torch.ops.admm_ref import admm_iterate_ref
    err = _admm_states_vs_twin(dec, llr, ADMM_STATE_ITERS + (dec.max_iter,))
    start = _admm_start(dec, llr)
    tables = dec._population()
    bsz, n_con = llr.shape[0], dec.structure.n_con
    never = (float("-inf"), 2 ** 31 - 1)
    ms = _admm_ms(dec, llr)
    plain = _time_ms(lambda: admm_iterate_ref(
        *start, tables, dec.alpha, dec.mu, *never,
        ADMM_TWIN_ITERS)) / ADMM_TWIN_ITERS
    n_var = dec.structure.n_var
    ops, nbytes = admm_kernel.iteration_work(tables, bsz,
                                              ADMM_TIMED_ITERS)
    bound = _bound(nbytes, ops, F32_OPS_PER_S)
    print(f"[10 qp-admm path] admm_iterate at {bsz} lanes: "
          f"{ms:.6f} ms per iteration of device time (one "
          f"{ADMM_TIMED_ITERS}-iteration launch, events), twin "
          f"{plain:.6f} ms ({ADMM_TWIN_ITERS} iterations, events), bound "
          f"{bound['bound_ms']:.6f} ms ({bound['bound_by']}: {ops} float32 "
          f"operations per iteration; {nbytes:.0f} bytes per iteration); "
          f"kernel/bound {ms / bound['bound_ms']:.1f}", flush=True)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain,
            "library_ms": None, **bound,
            "shape": f"{bsz} lanes x optimalH (n_var {n_var}, n_con "
                     f"{n_con}), alpha {dec.alpha}, mu {dec.mu}, -3 dB, ms "
                     f"per iteration of a {ADMM_TIMED_ITERS}-iteration "
                     f"launch"}


def phase_qpadmm_path():
    import torch
    from ldpc_tpu_torch import bench
    from ldpc_tpu_torch.apps.benchmark import run_sweep
    from ldpc_tpu_torch.channel.awgn import gen_random_codewords, noise_scales
    from ldpc_tpu_torch.codes.gf2 import gf2_nullspace
    from ldpc_tpu_torch.codes.io import read_pcm
    from ldpc_tpu_torch.config import SweepConfig
    from ldpc_tpu_torch.decoders import default_batch
    from ldpc_tpu_torch.decoders.admm import QPADMMDecoder
    from ldpc_tpu_torch.harness.experiment import channel_step, run_experiment
    from ldpc_tpu_torch.harness.reference_data import (REF_FER_OPT, SNR_GRID,
                                                       Z_BOUND, z_score)
    from ldpc_tpu_torch.ops import admm_kernel

    dev = torch.device("cuda")
    fer_ref = REF_FER_OPT["QP-ADMM"][SNR_GRID.index(ADMM_SNR)]
    bsz = default_batch("qp-admm")
    cfg = SweepConfig(matrix=str(bench.MATRIX), decoders=("qp-admm",),
                      snrs=(ADMM_SNR,), trials=ADMM_TRIALS,
                      report="build/chip_smoke_admm.csv",
                      extended_report="build/chip_smoke_admm_extended.csv")
    os.makedirs("build", exist_ok=True)
    _agc_counts(reset=True, counters=ALL_COUNTERS)
    with _HostReads() as reads:
        t0 = time.perf_counter()
        rows = run_sweep(cfg, device=dev)
        secs = time.perf_counter() - t0
    counts = _agc_counts(counters=ALL_COUNTERS)
    _path_counts("10 qp-admm path", counts,
                 need=("admm_iterate", "awgn_channel"))
    res = rows[0][2]
    z = z_score(res.fer, res.total, fer_ref)
    print(f"[10 qp-admm path] run_sweep qp-admm {ADMM_SNR} dB, {res.total} "
          f"trials in batches of {bsz}, streamed (the default): "
          f"{res.throughput:.1f} cw/s, FER {res.fer:.4f} (z = {z:+.2f} "
          f"against {fer_ref}), mean iterations "
          f"{res.sum_iterations / res.total:.1f}, host syncs {reads.n} "
          f"({reads.n * bsz / res.total:.1f} per {bsz} trials), {secs:.2f} s "
          f"with warm-up", flush=True)
    if not abs(z) < Z_BOUND or res.total != ADMM_TRIALS:
        raise AssertionError(f"QP-ADMM FER {res.fer} is {z:+.2f} sigma from "
                             f"the reference")

    h = read_pcm(str(bench.MATRIX))
    g, _ = gf2_nullspace(h)
    cw = gen_random_codewords(g, ADMM_TRIALS,
                              torch.Generator().manual_seed(cfg.seed), dev)
    dec = QPADMMDecoder(h, device=dev)

    def run(streaming):
        return run_experiment(dec, h, cw, ADMM_SNR, cfg.seed + 1, bsz,
                              device=dev, warmup=False, streaming=streaming)

    with _HostReads() as breads:
        bres = run(False)
    same = _same_counters(res, bres)
    print(f"[10 qp-admm path] the same trials batched: {bres.throughput:.1f} "
          f"cw/s, FER {bres.fer:.4f}, mean iterations "
          f"{bres.sum_iterations / bres.total:.1f}, host syncs {breads.n} "
          f"({breads.n * bsz / bres.total:.1f} per {bsz} trials); all eight "
          f"counters equal to the streamed run's: {same}", flush=True)
    if not same:
        raise AssertionError(f"streamed {res} and batched {bres} differ")
    again = [run(False), run(True)]
    order = [("streamed", res), ("batched", bres), ("batched", again[0]),
             ("streamed", again[1])]
    print(f"[10 qp-admm path] cw/s in run order (streamed, batched, batched, "
          f"streamed): " + ", ".join(f"{k} {r.throughput:.1f}"
                                     for k, r in order), flush=True)
    if not all(_same_counters(res, r) for r in again):
        raise AssertionError(f"the repeated runs differ: {again}")

    # one iteration at the batch's width: device time per iteration and
    # what it dispatches (a chunk of ADMM_CHUNK iterations from fresh lanes,
    # none of which finishes that early at -3 dB)
    y = channel_step(cw[:bsz], torch.arange(bsz, device=dev), ADMM_SNR,
                     cfg.seed + 1)
    llr = noise_scales(ADMM_SNR)[1] * y
    dec.stream_chunk_iters = ADMM_CHUNK
    st = dec.stream_chunk(dec.stream_init(llr))              # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = dec.stream_chunk(st)
    torch.cuda.synchronize()
    ms_it = (time.perf_counter() - t0) * 1e3 / ADMM_CHUNK
    fresh = dec.stream_init(llr)
    launches0 = admm_kernel.ITERATE_LAUNCHES
    ops = _launches(lambda: fresh.update(dec.stream_chunk(fresh)))
    per_it = ops / int(fresh["it"].max())
    print(f"[10 qp-admm path] {bsz} lanes, {ADMM_CHUNK}-iteration chunks: "
          f"{ms_it:.4f} ms per iteration by the host clock, {per_it:.4f} "
          f"dispatches per iteration (non-view ATen operations and kernel "
          f"launches), admm_iterate launches per chunk "
          f"{admm_kernel.ITERATE_LAUNCHES - launches0}", flush=True)
    del dec.stream_chunk_iters
    row = _admm_kernel_vs_twin(dec, llr)
    row["launches"] = counts["admm_iterate"]

    llr = llr[:ADMM_CPU_LANES]
    card = QPADMMDecoder(h, max_iter=ADMM_CPU_ITERS,
                         device=dev).decode_batch(llr)
    t0 = time.perf_counter()
    cpu = QPADMMDecoder(h, max_iter=ADMM_CPU_ITERS,
                        device="cpu").decode_batch(llr.cpu())
    cpu_s = time.perf_counter() - t0
    bits_ok = torch.equal(card.bits.cpu(), cpu.bits)
    succ_ok = torch.equal(card.success.cpu(), cpu.success)
    it_same = int((card.iterations.cpu() == cpu.iterations).sum())
    print(f"[10 qp-admm path] {ADMM_CPU_LANES} lanes on the card and on the "
          f"CPU at max_iter {ADMM_CPU_ITERS}: bits equal {bits_ok}, success equal {succ_ok}, iterations "
          f"equal on {it_same} lanes (sum2 is summed in another order); "
          f"CPU {cpu_s:.2f} s", flush=True)
    if not (bits_ok and succ_ok):
        raise AssertionError("QP-ADMM on the card differs from the CPU")

    h02 = read_pcm(str(bench.MATRIX.parent / "H02.txt"))
    g02, _ = gf2_nullspace(h02)
    dec02 = QPADMMDecoder(h02, device=dev)
    cw02 = gen_random_codewords(g02, ADMM_H02_LANES,
                                torch.Generator().manual_seed(cfg.seed), dev)
    y02 = channel_step(cw02, torch.arange(ADMM_H02_LANES, device=dev),
                       ADMM_SNR, cfg.seed + 1)
    t0 = time.perf_counter()
    r02 = dec02.decode_batch(noise_scales(ADMM_SNR)[1] * y02)
    correct = r02.success & (r02.bits == cw02).all(-1)
    fer02 = 1.0 - correct.float().mean().item()
    e_min = dec02.structure.e_min
    print(f"[10 qp-admm path] H02 (520x640) at alpha 1.2, mu 0.55 "
          f"(e_min {e_min}: e_min * mu > alpha is {e_min * 0.55 > 1.2}), "
          f"{ADMM_H02_LANES} lanes: FER {fer02:.4f}, successes "
          f"{int(r02.success.sum())}, nonzero bits "
          f"{int(r02.bits.sum())}, {time.perf_counter() - t0:.2f} s",
          flush=True)
    if fer02 != 1.0 or bool(r02.success.any()) or bool(r02.bits.any()):
        raise AssertionError("QP-ADMM on H02 at the defaults must fail")
    row["h02_ms"] = _admm_h02_feasible(h02, g02, cfg.seed, row["ms"])
    return row


def _admm_h02_feasible(h02, g02, seed, optimal_ms) -> float:
    """Phase 10 on H02 at ADMM_H02_PARAMS and ADMM_H02_SNR, where its 72
    slots a variable are summed in XLA's windows of 32: the kernel's state
    against its twin's after ADMM_STATE_ITERS iterations on ADMM_H02_LANES
    lanes (equal but on sum2 ties), the card's decode against the CPU's
    (bits and success equal), and the kernel's device ms per iteration at
    the batch's width beside optimalH's (``optimal_ms``). Returns H02's."""
    import torch
    from ldpc_tpu_torch.channel.awgn import gen_random_codewords, noise_scales
    from ldpc_tpu_torch.decoders import default_batch
    from ldpc_tpu_torch.decoders.admm import QPADMMDecoder
    from ldpc_tpu_torch.harness.experiment import channel_step
    from ldpc_tpu_torch.ops import admm_kernel
    from ldpc_tpu_torch.ops.admm_ref import admm_iterate_ref
    dev = torch.device("cuda")
    alpha, mu = ADMM_H02_PARAMS
    bsz = default_batch("qp-admm")
    dec = QPADMMDecoder(h02, alpha=alpha, mu=mu, device=dev)
    cw = gen_random_codewords(g02, bsz, torch.Generator().manual_seed(seed),
                              dev)
    llr = noise_scales(ADMM_H02_SNR)[1] * channel_step(
        cw, torch.arange(bsz, device=dev), ADMM_H02_SNR, seed + 1)
    lanes = llr[:ADMM_H02_LANES]
    where = f"at alpha {alpha}, mu {mu}, {ADMM_H02_SNR} dB"
    _admm_states_vs_twin(dec, lanes, ADMM_STATE_ITERS, f" of H02 {where}")
    t0 = time.perf_counter()
    card = QPADMMDecoder(h02, alpha=alpha, mu=mu,
                         max_iter=ADMM_H02_CPU_ITERS,
                         device=dev).decode_batch(lanes)
    cpu = QPADMMDecoder(h02, alpha=alpha, mu=mu,
                        max_iter=ADMM_H02_CPU_ITERS,
                        device="cpu").decode_batch(lanes.cpu())
    bits_ok = torch.equal(card.bits.cpu(), cpu.bits)
    succ_ok = torch.equal(card.success.cpu(), cpu.success)
    stopped = int((cpu.iterations < ADMM_H02_CPU_ITERS).sum())
    print(f"[10 qp-admm path] H02 {where}, {ADMM_H02_LANES} lanes on the "
          f"card and on the CPU at max_iter {ADMM_H02_CPU_ITERS}: bits equal "
          f"{bits_ok}, success equal {succ_ok}, iterations equal on "
          f"{int((card.iterations.cpu() == cpu.iterations).sum())} lanes, "
          f"{stopped} lanes stopped before max_iter; "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    if not (bits_ok and succ_ok):
        raise AssertionError("QP-ADMM on H02 on the card differs from the "
                             "CPU")
    ms = _admm_ms(dec, llr)
    tables = dec._population()
    never = (float("-inf"), 2 ** 31 - 1)
    start = _admm_start(dec, llr)
    plain = _time_ms(lambda: admm_iterate_ref(
        *start, tables, alpha, mu, *never,
        ADMM_TWIN_ITERS)) / ADMM_TWIN_ITERS
    ops, nbytes = admm_kernel.iteration_work(tables, bsz, ADMM_TIMED_ITERS)
    bound = _bound(nbytes, ops, F32_OPS_PER_S)
    print(f"[10 qp-admm path] admm_iterate at {bsz} lanes of H02 (n_var "
          f"{dec.structure.n_var}, n_con {dec.structure.n_con}, 72 slots a "
          f"variable in windows of 32), alpha {alpha}, mu {mu}: {ms:.6f} ms "
          f"per iteration of device time (one {ADMM_TIMED_ITERS}-iteration "
          f"launch, events) beside optimalH's {optimal_ms:.6f}; twin "
          f"{plain:.6f} ms ({ADMM_TWIN_ITERS} iterations, events); bound "
          f"{bound['bound_ms']:.6f} ms ({bound['bound_by']}: {ops} float32 "
          f"operations per iteration); kernel/bound "
          f"{ms / bound['bound_ms']:.1f}", flush=True)
    return ms


def phase_full_lp():
    import numpy as np
    import torch
    from ldpc_tpu_torch import bench
    from ldpc_tpu_torch.apps.benchmark import run_sweep
    from ldpc_tpu_torch.codes.gf2 import gf2_nullspace
    from ldpc_tpu_torch.codes.io import read_pcm
    from ldpc_tpu_torch.config import SweepConfig
    from ldpc_tpu_torch.decoders import default_batch
    from ldpc_tpu_torch.decoders.lp import FullLPDecoder

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = SweepConfig(matrix=str(bench.MATRIX), decoders=("full-lp",),
                      snrs=(ADMM_SNR,), trials=LP_TRIALS,
                      report="build/chip_smoke_lp.csv",
                      extended_report="build/chip_smoke_lp_extended.csv")
    _agc_counts(reset=True, counters=ALL_COUNTERS)
    t0 = time.perf_counter()
    rows = run_sweep(cfg, device=dev)
    secs = time.perf_counter() - t0
    _path_counts("11 full lp", _agc_counts(counters=ALL_COUNTERS))
    res = rows[0][2]
    print(f"[11 full lp] run_sweep full-lp {ADMM_SNR} dB, {res.total} trials "
          f"in batches of {default_batch('full-lp')}, 2000 iterations: "
          f"{res.throughput:.1f} cw/s, "
          f"FER {res.fer:.4f} (no golden: the reference comments this "
          f"decoder out, main.cpp:36), {secs:.2f} s with warm-up",
          flush=True)
    if res.total != LP_TRIALS or not 0.0 < res.throughput < float("inf"):
        raise AssertionError(f"Full LP: {res.total} trials, "
                             f"{res.throughput} cw/s")

    h = read_pcm(str(bench.MATRIX))
    g, _ = gf2_nullspace(h)
    llr = _alp_llrs(g, LP_CPU_LANES, 53)
    card, cpu = FullLPDecoder(h, device=dev), FullLPDecoder(h, device="cpu")
    x = card.solve(llr).cpu()
    xc = cpu.solve(llr.cpu())
    dx = float((x - xc).abs().max())
    xv, xcv = x[:, :card.n].numpy(), xc[:, :card.n].numpy()

    def clear(v):       # every coordinate LP_MARGIN from each threshold
        t = card.int_tol
        dist = np.min(np.stack([abs(v - 0.5), abs(v - t), abs(v - 1 + t)]),
                      axis=0)
        return (dist >= LP_MARGIN).all(axis=1)

    sure = torch.from_numpy(clear(xv) & clear(xcv))
    a, b = card.decode_batch(llr), cpu.decode_batch(llr.cpu())
    same = (torch.equal(a.bits.cpu()[sure], b.bits[sure])
            and torch.equal(a.success.cpu()[sure], b.success[sure]))
    print(f"[11 full lp] {LP_CPU_LANES} lanes on the card and on the CPU: "
          f"max |dx| {dx:.3e} (bound {LP_X_TOL}), bits and success equal on "
          f"the {int(sure.sum())} lanes clear of 0.5 and int_tol by "
          f"{LP_MARGIN}: {same}", flush=True)
    if not (dx <= LP_X_TOL and same):
        raise AssertionError("Full LP on the card differs from the CPU")
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        card.decode_batch(llr[:2])
        refused = False
    except RuntimeError:
        refused = True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[11 full lp] with TF32 allowed the decode refuses: {refused}",
          flush=True)
    if not refused:
        raise AssertionError("Full LP ran with TF32 allowed")


def phase_multi_snr():
    import torch
    from ldpc_tpu_torch import bench
    from ldpc_tpu_torch.channel.awgn import gen_random_codewords
    from ldpc_tpu_torch.codes.gf2 import gf2_nullspace
    from ldpc_tpu_torch.codes.io import read_pcm
    from ldpc_tpu_torch.decoders.bp import BPDecoder
    from ldpc_tpu_torch.harness.experiment import (run_experiment,
                                                   run_multi_snr_experiment)
    from ldpc_tpu_torch.harness.reference_data import (REF_FER_OPT, SNR_GRID,
                                                       z_score)

    dev = torch.device("cuda")
    h = read_pcm(str(bench.MATRIX))
    g, _ = gf2_nullspace(h)
    cw = gen_random_codewords(g, LANES, torch.Generator().manual_seed(
        bench.SEED), dev)
    dec = BPDecoder(h, max_iter=MAX_ITER, device=dev)
    run_multi_snr_experiment(dec, h, cw[:LANES // 8], MULTI_SNRS,
                             bench.SEED + 1, LANES, device=dev)   # warm-up
    _agc_counts(reset=True, counters=ALL_COUNTERS)
    fused = run_multi_snr_experiment(dec, h, cw, MULTI_SNRS, bench.SEED + 1,
                                     LANES, device=dev, warmup=False)
    counts = _agc_counts(counters=ALL_COUNTERS)
    _path_counts("12 multi-snr", counts, need=("bp_decode", "awgn_channel"))
    elapsed = sum(r.time_sec for r in fused)
    print(f"[12 multi-snr] BP-{MAX_ITER} over {MULTI_SNRS} dB as one run of "
          f"{len(MULTI_SNRS)} x {LANES} lanes in batches of {LANES}: "
          f"{len(MULTI_SNRS) * LANES / elapsed:.0f} cw/s", flush=True)
    ok, single_s = True, 0.0
    for snr, fres in zip(MULTI_SNRS, fused):
        single = run_experiment(dec, h, cw, snr, bench.SEED + 1, LANES,
                                device=dev, warmup=False)
        single_s += single.time_sec
        same = _same_counters(fres, single)
        ok &= same
        ref = REF_FER_OPT["BP"][SNR_GRID.index(snr)]
        print(f"[12 multi-snr] {snr} dB: FER {fres.fer:.4f} (z = "
              f"{z_score(fres.fer, fres.total, ref):+.2f} against {ref}), "
              f"mean iterations {fres.sum_iterations / fres.total:.2f}; "
              f"counters equal to a single-SNR run: {same}", flush=True)
    print(f"[12 multi-snr] fused {elapsed * 1e3:.3f} ms against the "
          f"single-SNR runs' {single_s * 1e3:.3f} ms", flush=True)
    if not ok:
        raise AssertionError("the fused multi-SNR run differs from the "
                             "single-SNR runs")


def phase_apps():
    import numpy as np
    import torch
    from ldpc_tpu_torch import bench
    from ldpc_tpu_torch.apps import qpadmm_grid, validate
    from ldpc_tpu_torch.codes.io import read_pcm
    from ldpc_tpu_torch.config import GridSearchConfig
    from ldpc_tpu_torch.decoders.admm import QPADMMDecoder

    dev = torch.device("cuda")
    cfg = GridSearchConfig(matrix=str(bench.MATRIX), trials=GRID_TRIALS,
                           alpha_min=1.1, alpha_max=1.3, alpha_count=3,
                           mu_min=0.5, mu_max=0.6, mu_count=3,
                           grid_out="build/chip_smoke_grid.csv")
    _agc_counts(reset=True, counters=ALL_COUNTERS)
    t0 = time.perf_counter()
    fers, best = qpadmm_grid.run_grid(cfg, device=dev,
                                      log=lambda *a, **k: None)
    secs = time.perf_counter() - t0
    _path_counts("13 apps", _agc_counts(counters=ALL_COUNTERS),
                 need=("admm_iterate", "awgn_channel"))
    h = read_pcm(cfg.matrix)
    cw, llr = qpadmm_grid.grid_channel(cfg, h, dev)
    diff = []
    for (a, m), fer in fers.items():
        res = QPADMMDecoder(h, alpha=a, mu=m, max_iter=cfg.admm_max_iter,
                            eps_stop=cfg.admm_eps_stop,
                            device=dev).decode_batch(llr)
        correct = res.success & (res.bits == cw).all(-1)
        want = (1.0 - correct.to(torch.float32).mean()).item()
        if fer != want:
            diff.append(((a, m), fer, want))
    by_cell = {(round(float(a), 3), round(float(m), 3)): round(f, 4)
               for (a, m), f in fers.items()}
    print(f"[13 apps] qpadmm_grid, 3 x 3 cells around (1.2, 0.55), "
          f"{GRID_TRIALS} trials, one decode of {len(fers) * GRID_TRIALS} "
          f"lanes: {secs:.2f} s; FER by cell {by_cell}; "
          f"best {best[0]:.4f} at ({best[1]:.3f}, {best[2]:.3f}); cells "
          f"differing from a QPADMMDecoder run at that cell: {diff}",
          flush=True)
    if diff or not np.isfinite(best[0]):
        raise AssertionError(f"grid cells differ: {diff}")
    t0 = time.perf_counter()
    rows = validate.validate(decoders=("qp-admm",), snrs=(ADMM_SNR,),
                             max_trials=ADMM_TRIALS, device=dev,
                             report="build/chip_smoke_validate.csv",
                             log=lambda *a, **k: None)
    r = rows[0]
    print(f"[13 apps] validate qp-admm {ADMM_SNR} dB, --max-trials "
          f"{ADMM_TRIALS}: FER {r['fer']:.4f} against {r['ref']} (z = "
          f"{r['z']:+.2f}, n = {r['n']}), {r['verdict']}, "
          f"{r['throughput']:.1f} cw/s, {time.perf_counter() - t0:.2f} s",
          flush=True)
    if r["verdict"] != "PASS":
        raise AssertionError(f"validate: {r}")


def _refuse_constant(token):
    raise ValueError(f"the state file holds the non-JSON token {token}")


class _OptimizerRun:
    """Records the evaluator of an ``optimize`` run and the seconds of each
    of its evaluations (each ends with a host read, so the wall time
    includes the card's work), and prints the run's log lines. Per
    generation it keeps the seconds since the one before (the first from
    the line that precedes the loop) and the host's seconds in the
    evaluator's three per-candidate steps in that time."""

    def __init__(self):
        self.calls, self.gens = [], []
        self.ev, self._host0, self._t0 = None, None, None

    def evaluator(self, base):
        run = self

        class Timed(base):
            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                run.ev = self

            def evaluate(self, candidates, seed, trials, trial_batch=512,
                         max_iter=None):
                t0 = time.perf_counter()
                out = super().evaluate(candidates, seed, trials,
                                       trial_batch, max_iter)
                run.calls.append((len(candidates), trials, max_iter,
                                  time.perf_counter() - t0))
                return out

        return Timed

    def _host(self):
        return {k: t.total for k, t in self.ev.host_s.items()}

    def log(self, *args, **kwargs):
        line = " ".join(str(a) for a in args)
        print(f"[14 optimizer] {line.strip()}", flush=True)
        if line.startswith(("initial chain screen FERs", "\tgeneration")):
            now, t = self._host(), time.perf_counter()
            if self._t0 is not None:
                self.gens.append((t - self._t0, {k: now[k] - self._host0[k]
                                                 for k in now}))
            self._host0, self._t0 = now, t


def _admm_population_vs_twin(tables, llrs, n, alpha, mu, max_iter):
    """Phase 14's check of the iteration kernel against its twin at the
    population's shape (the incumbents at their caps, ``llrs`` (P, B, n)):
    the state after ADMM_STATE_ITERS iterations from fresh pairs, equal on
    every pair but sum2 ties (printed); then device ms per iteration of one
    ADMM_TIMED_ITERS-iteration launch with no pair stopping (events), the
    twin's over ADMM_TWIN_ITERS, and the bound on the real rows. Returns
    the numbers for the kernels' JSON line."""
    import torch
    from ldpc_tpu_torch.ops import admm_kernel
    from ldpc_tpu_torch.ops.admm_ref import admm_iterate_ref, stop_ties
    kern, twin = admm_kernel.admm_iterate, admm_iterate_ref
    packed = admm_kernel.pack_tables(tables)
    p_count, bsz = llrs.shape[:2]
    n_var, n_con = tables["e"].shape[1], tables["b"].shape[1]
    q = torch.cat([llrs, llrs.new_zeros((p_count, bsz, n_var - n))],
                  dim=2).transpose(0, 1).reshape(bsz, -1).contiguous()
    start = (q, (q > 0).float(), q.new_zeros((bsz, p_count * n_con)),
             q.new_zeros((bsz, p_count * n_con)),
             torch.zeros((bsz, p_count), dtype=torch.bool, device=q.device),
             torch.zeros((bsz, p_count), dtype=torch.int32, device=q.device))
    args = (packed, alpha, mu, 1e-5, max_iter)
    err = 0.0
    for iters in ADMM_STATE_ITERS:
        t0 = time.perf_counter()
        got = kern(*(t.clone() for t in start), *args, iters)
        want = twin(*start, *args, iters)
        ties, others = stop_ties(start, got, want, *args[:4], kern, twin)
        keep = torch.ones((bsz, p_count), dtype=torch.bool, device=q.device)
        for lane, cand, *_ in ties:
            keep[lane, cand] = False
        same = {}
        for key, a, b in zip(("v", "z", "yl", "done", "it"), got, want):
            a = a.view(bsz, p_count, -1)[keep]
            b = b.view(bsz, p_count, -1)[keep]
            same[key] = torch.equal(a, b)
            if key in ("v", "z", "yl"):
                err = max(err, float((a - b).abs().max()))
        print(f"[14 optimizer] admm_iterate against its twin at the "
              f"population's shape, {p_count} x {bsz} pairs, {iters} "
              f"iterations (max_iter {max_iter}): equal outside ties "
              f"{same}; pairs done {int(got[3].sum())}; sum2 ties {ties}; "
              f"other differences {others}; "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        if others or not all(same.values()):
            raise AssertionError(f"admm_iterate differs from its twin at "
                                 f"the population's shape: {same}, "
                                 f"{others}")
    never = (float("-inf"), 2 ** 31 - 1)
    copies = [tuple(t.clone() for t in start) for _ in range(REPEATS + 1)]
    ms = _time_ms(lambda: kern(*copies.pop(), packed, alpha, mu, *never,
                               ADMM_TIMED_ITERS)) / ADMM_TIMED_ITERS
    plain = _time_ms(lambda: twin(*start, packed, alpha, mu, *never,
                                  ADMM_TWIN_ITERS)) / ADMM_TWIN_ITERS
    ops, nbytes = admm_kernel.iteration_work(packed, bsz,
                                              ADMM_TIMED_ITERS)
    bound = _bound(nbytes, ops, F32_OPS_PER_S)
    real = packed["real"].tolist()
    print(f"[14 optimizer] admm_iterate at the population's shape, "
          f"{p_count} x {bsz} pairs at caps (n_var, n_con) {(n_var, n_con)}, "
          f"real {real}: {ms:.6f} ms per iteration of device time (one "
          f"{ADMM_TIMED_ITERS}-iteration launch, events), twin "
          f"{plain:.6f} ms ({ADMM_TWIN_ITERS} iterations, events), bound "
          f"{bound['bound_ms']:.6f} ms ({bound['bound_by']}: {ops} float32 "
          f"operations per iteration on the real rows; {nbytes:.0f} bytes "
          f"per iteration); kernel/bound {ms / bound['bound_ms']:.1f}",
          flush=True)
    return {"population_ms": ms, "population_plain_ms": plain,
            "population_bound_ms": bound["bound_ms"],
            "population_bound_by": bound["bound_by"],
            "population_max_abs_err": err,
            "population_shape": f"{p_count} x {bsz} pairs, the state "
                                f"file's incumbents at caps ({n_var}, "
                                f"{n_con}), real {real}, alpha {alpha}, mu "
                                f"{mu}, -3 dB, ms per iteration of a "
                                f"{ADMM_TIMED_ITERS}-iteration launch"}


def phase_optimizer():
    import shutil
    import numpy as np
    import torch
    from ldpc_tpu_torch import _native
    from ldpc_tpu_torch.apps import optimize_h
    from ldpc_tpu_torch.channel.awgn import (gen_random_codewords,
                                             noise_scales, transmit)
    from ldpc_tpu_torch.codes.gf2 import gf2_nullspace
    from ldpc_tpu_torch.codes.qc import QCMatrix
    from ldpc_tpu_torch.config import OptimizeConfig
    from ldpc_tpu_torch.decoders.admm import (ADMMStructure, QPADMMDecoder,
                                              decode_qp_admm,
                                              decode_qp_admm_population)
    from ldpc_tpu_torch.ops import admm_kernel

    dev = torch.device("cuda")
    os.makedirs("build", exist_ok=True)
    state = "build/chip_smoke_optimize_state.json"
    shutil.copy(OPT_STATE, state)
    with open(state) as f:
        before = json.load(f)
    # the defaults are the reference's run: 8 x 14 blocks of 20, population
    # 8, 1,000 trials at 1,000 iterations, screens of 256 trials at 600,
    # alpha 1.95, mu 0.5, -3 dB
    cfg = OptimizeConfig(generations=before["generation"] + OPT_ROUNDS * 8,
                         final_trials=OPT_FINAL_TRIALS,
                         save_path="build/chip_smoke_optimalH_torch.txt",
                         state_path=state)
    run = _OptimizerRun()
    base = optimize_h.PopulationEvaluator
    optimize_h.PopulationEvaluator = run.evaluator(base)
    _agc_counts(reset=True, counters=ALL_COUNTERS)
    try:
        t0 = time.perf_counter()
        best_qc, final = optimize_h.optimize(cfg, log=run.log, device=dev)
        secs = time.perf_counter() - t0
    finally:
        optimize_h.PopulationEvaluator = base
    _path_counts("14 optimizer", _agc_counts(counters=ALL_COUNTERS),
                 need=("admm_iterate", "awgn_channel"))

    def kind(call):
        if call[2] == cfg.screen_iters:
            return "screen"
        return "final" if call[1] == cfg.final_trials else "full"

    split = {}
    for call in run.calls:
        n, s_ = split.get(kind(call), (0, 0.0))
        split[kind(call)] = (n + 1, s_ + call[3])
    gen_s = [g[0] for g in run.gens]
    host = {k: sum(g[1][k] for g in run.gens) / len(run.gens)
            for k in run.gens[0][1]}
    share = sum(host.values()) / (sum(gen_s) / len(gen_s))
    path = ("NumPy (LDPC_TPU_NO_NATIVE)" if _native.disabled()
            else f"the native host core ({_native.LIB_PATH.name})")
    print(f"[14 optimizer] resumed at generation {before['generation']} "
          f"for {OPT_ROUNDS} rounds of {cfg.population} proposals: "
          f"{secs} s in all; seconds per generation {gen_s}; evaluations "
          f"(calls, seconds) by kind {split}; host seconds per generation "
          f"{host}, {share} of a generation; tables built by {path}",
          flush=True)

    # (d) the state file: strict JSON that round-trips, the run's proposal
    # count, the FER never above the resumed one
    with open(state) as f:
        text = f.read()
    after = json.loads(text, parse_constant=_refuse_constant)
    trip = json.loads(json.dumps(after)) == after
    print(f"[14 optimizer] (d) state: strict JSON round trip {trip}, "
          f"generation {after['generation']}, FER {after['fer']} (resumed "
          f"{before['fer']}), final FER ({cfg.final_trials} trials) "
          f"{final:.5f}", flush=True)
    if not (trip and after["generation"] == cfg.generations
            and after["fer"] is not None and after["fer"] <= before["fer"]):
        raise AssertionError(f"state file: {after['generation']}, "
                             f"{after['fer']}")

    # (c) the final FER, recomputed by a single decoder of the best matrix
    # on the same codewords (from the seed) and LLRs (noise from seed + 1)
    def channel(h, trials):
        cw = gen_random_codewords(gf2_nullspace(h)[0], trials,
                                  torch.Generator().manual_seed(cfg.seed),
                                  dev)
        idx = torch.arange(trials, dtype=torch.int64, device=dev)
        return cw, noise_scales(cfg.snr)[1] * transmit(cw, cfg.snr,
                                                      cfg.seed + 1, idx)

    def fer_of(h, trials):
        cw, llr = channel(h, trials)
        res = QPADMMDecoder(h, alpha=cfg.admm_alpha, mu=cfg.admm_mu,
                            max_iter=cfg.admm_max_iter,
                            device=dev).decode_batch(llr)
        return 1.0 - int((res.success & (res.bits == cw).all(-1)).sum()
                         ) / trials

    h_best = best_qc.to_dense()
    again = fer_of(h_best, cfg.final_trials)
    checks = [("final", final, again)]
    if after["fer"] != before["fer"]:   # a new best from this run's evals
        checks.append(("best", after["fer"], fer_of(h_best, cfg.trials)))
    print(f"[14 optimizer] (c) (reported, recomputed by a QPADMMDecoder of "
          f"the best matrix): {checks}", flush=True)
    if any(a != b for _, a, b in checks):
        raise AssertionError(f"FER not recomputed: {checks}")

    # (a) the chain incumbents' population decode against single decodes
    incumbents = [QCMatrix(cfg.block_size, np.array(c["present"], bool),
                           np.array(c["shifts"], np.int64)).to_dense()
                  for c in after["chains"]]
    incumbents = [h for h in incumbents if gf2_nullspace(h)[1]]
    caps = optimize_h._caps_for(incumbents)
    structs = [ADMMStructure.from_h(h, **caps) for h in incumbents]
    tables = {k: torch.from_numpy(np.stack([getattr(s, k) for s in structs]))
              for k in optimize_h.TABLES}
    tables_dev = {k: t.to(dev) for k, t in tables.items()}
    cws, llrs = zip(*(channel(h, cfg.screen_trials) for h in incumbents))
    llrs = torch.stack(llrs)                        # (P, 256, n)
    n = h_best.shape[1]
    args = (cfg.admm_alpha, cfg.admm_mu, cfg.admm_max_iter, 1e-5)
    pop = decode_qp_admm_population(tables_dev, n, llrs, *args)
    differ = []
    for p in range(len(incumbents)):
        one = decode_qp_admm({k: t[p] for k, t in tables_dev.items()}, n,
                             llrs[p], *args)
        for key in ("bits", "success", "iterations"):
            if not torch.equal(getattr(one, key), getattr(pop, key)[p]):
                differ.append((p, key))
    good = pop.success & (pop.bits == torch.stack(cws)).all(-1)
    fers = (1.0 - good.float().mean(dim=1)).tolist()
    print(f"[14 optimizer] (a) {len(incumbents)} chain incumbents x "
          f"{cfg.screen_trials} trials, caps {caps}: population decode "
          f"against {len(incumbents)} single decode_qp_admm calls, "
          f"(candidate, output) pairs differing: {differ}; FER per "
          f"incumbent {[round(f, 4) for f in fers]}", flush=True)
    if differ:
        raise AssertionError(f"population decode differs: {differ}")

    # (b) OPT_CPU_LANES lanes of each incumbent on the CPU
    t0 = time.perf_counter()
    cpu = decode_qp_admm_population(tables, n,
                                    llrs[:, :OPT_CPU_LANES].cpu(), *args)
    cpu_s = time.perf_counter() - t0
    same = {key: torch.equal(getattr(pop, key)[:, :OPT_CPU_LANES].cpu(),
                             getattr(cpu, key))
            for key in ("bits", "success", "iterations")}
    print(f"[14 optimizer] (b) {len(incumbents) * OPT_CPU_LANES} lanes on "
          f"the card and on the CPU at max_iter {cfg.admm_max_iter}: equal "
          f"{same}; CPU {cpu_s:.2f} s", flush=True)
    if not all(same.values()):
        raise AssertionError(f"population decode card vs CPU: {same}")

    # one iteration of the population decode at the incumbents' 2,048
    # lanes: time and dispatches per iteration over an OPT_CHUNK-iteration
    # decode (its setup included), no lane finishing that early at -3 dB
    def chunk():
        return decode_qp_admm_population(tables_dev, n, llrs,
                                         cfg.admm_alpha, cfg.admm_mu,
                                         OPT_CHUNK, 1e-5)

    chunk()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = chunk()
    torch.cuda.synchronize()
    ms_it = (time.perf_counter() - t0) * 1e3 / OPT_CHUNK
    launches0 = admm_kernel.ITERATE_LAUNCHES
    ops = _launches(chunk) / OPT_CHUNK
    print(f"[14 optimizer] population decode at {llrs.shape[0]} x "
          f"{llrs.shape[1]} = {llrs.shape[0] * llrs.shape[1]} lanes, "
          f"{OPT_CHUNK} iterations: {ms_it:.4f} ms per iteration by the "
          f"host clock, {ops:.4f} dispatches per iteration (non-view ATen "
          f"operations and kernel launches; admm_iterate launches per "
          f"decode {admm_kernel.ITERATE_LAUNCHES - launches0}); lanes done "
          f"after {OPT_CHUNK} iterations: "
          f"{int((out.iterations < OPT_CHUNK).sum())}", flush=True)
    return _admm_population_vs_twin(tables_dev, llrs, n, cfg.admm_alpha,
                                    cfg.admm_mu, cfg.admm_max_iter)


def _launch(cmd, timeout):
    """Runs ``cmd`` in its own process group; kills the whole group if it
    has not ended after ``timeout`` seconds. Returns (exit code or None
    when killed, stdout, stderr, seconds)."""
    import signal
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
        rc = proc.returncode
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        rc = None
    return rc, out, err, time.perf_counter() - t0


def _torchrun(nproc, *args):
    return [sys.executable, "-m", "torch.distributed.run", "--standalone",
            f"--nproc-per-node={nproc}", *args]


def _world(nproc, backend):
    """Starts ``chip_smoke.py --world`` as a world of ``nproc`` ranks over
    ``backend``; returns each rank's results."""
    rc, out, err, secs = _launch(
        _torchrun(nproc, os.path.abspath(__file__), "--world", WORLD_DIR,
                  backend), WORLD_TIMEOUT_S)
    print(f"[15 worlds] world of {nproc} over {backend}: exit {rc}, "
          f"{secs:.2f} s", flush=True)
    if rc != 0:
        print(err[-6000:], file=sys.stderr)
        raise AssertionError(f"the world of {nproc} over {backend} failed "
                             f"(exit {rc})")
    ranks = []
    for rank in range(nproc):
        with open(f"{WORLD_DIR}/w{nproc}_r{rank}.json") as f:
            ranks.append(json.load(f))
    return ranks


def world_rank(out_dir, backend):
    """One rank of a phase-15 world (started by torchrun): every check's
    results into ``out_dir/w{world}_r{rank}.json``. A world of 1 runs the
    sharded ``scaling_bench`` and the unsharded references, a world of 2
    the sharded runs; each path's kernel launches are counted from 0."""
    import torch
    from ldpc_tpu_torch import bench
    from ldpc_tpu_torch.apps import optimize_h, scaling_bench
    from ldpc_tpu_torch.channel.awgn import gen_random_codewords
    from ldpc_tpu_torch.codes.gf2 import gf2_nullspace
    from ldpc_tpu_torch.codes.io import read_pcm
    from ldpc_tpu_torch.config import DecoderConfig, OptimizeConfig
    from ldpc_tpu_torch.decoders import make_decoder
    from ldpc_tpu_torch.decoders.bp import BPDecoder
    from ldpc_tpu_torch.harness.experiment import (COUNTERS, run_experiment,
                                                   run_streaming_experiment)
    from ldpc_tpu_torch.parallel.distributed import (initialize_distributed,
                                                     process_count,
                                                     process_index, shutdown)
    from ldpc_tpu_torch.parallel.mesh import make_trial_mesh

    initialize_distributed(backend=backend)
    world, rank = process_count(), process_index()
    if world != int(os.environ["WORLD_SIZE"]):
        raise AssertionError(f"a world of {os.environ['WORLD_SIZE']} runs "
                             f"as {world}")
    sh = make_trial_mesh()
    dev = sh.device
    split = sh if world > 1 else None
    out = {"rank": rank, "world": world, "backend": sh.backend,
           "device": str(dev), "card": torch.cuda.get_device_name(dev)}

    def counters(res):
        return [getattr(res, k) for k in COUNTERS]

    def path(name, fn):
        _agc_counts(reset=True, counters=ALL_COUNTERS)
        t0 = time.perf_counter()
        res = fn()
        out[f"{name}_s"] = time.perf_counter() - t0
        out[f"{name}_launches"] = _agc_counts(counters=ALL_COUNTERS)
        return res

    try:
        out["scaling"] = path("scaling", lambda: scaling_bench.main(
            ["--backend", backend, "--matrix", str(bench.MATRIX)]))
        h = read_pcm(str(bench.MATRIX))
        g, _ = gf2_nullspace(h)
        cw = gen_random_codewords(
            g, 65536, torch.Generator().manual_seed(scaling_bench.SEED), dev)
        seed = scaling_bench.SEED + 1
        res = path("bp", lambda: run_experiment(
            BPDecoder(h, max_iter=50, device=dev), h, cw, -3.0, seed, 4096,
            device=dev, sharding=split))
        out["bp"], out["bp_cws"] = counters(res), res.throughput
        res = path("alp", lambda: run_experiment(
            make_decoder("alp", h, device=dev), h, cw[:WORLD_ALP_TRIALS],
            -3.0, seed, 256, device=dev, sharding=split))
        out["alp"], out["alp_cws"] = counters(res), res.throughput
        res = path("admm", lambda: run_streaming_experiment(
            make_decoder("qp-admm", h,
                         DecoderConfig(admm_max_iter=WORLD_ADMM_ITERS),
                         device=dev), h,
            cw[:WORLD_ADMM_TRIALS], -3.0, seed, WORLD_ADMM_LANES,
            device=dev, sharding=split))
        out["admm"], out["admm_cws"] = counters(res), res.throughput
        lines = []

        def log(*args, **kwargs):
            if "file" not in kwargs:        # stdout lines, seconds masked
                lines.append(re.sub(r"\(\d+\.\d+s,", "(<s>,",
                                    " ".join(str(a) for a in args)))

        cfg = OptimizeConfig(
            **WORLD_OPT, save_path=f"{out_dir}/opt_w{world}_r{rank}.txt",
            state_path=f"{out_dir}/opt_w{world}_r{rank}.json")
        _, final = path("opt", lambda: optimize_h.optimize(cfg, log=log,
                                                           device=dev))
        out["opt_lines"], out["opt_final"] = lines, final
        if os.path.exists(cfg.state_path):
            with open(cfg.state_path) as f:
                out["opt_state"] = f.read()
    finally:
        with open(f"{out_dir}/w{world}_r{rank}.json", "w") as f:
            json.dump(out, f)
        shutdown()
    return 0


def phase_worlds():
    """Phase 15: worlds of processes over torch.distributed."""
    import shutil
    import torch
    torch.cuda.empty_cache()          # the worlds' processes share the card
    shutil.rmtree(WORLD_DIR, ignore_errors=True)
    os.makedirs(WORLD_DIR)

    # (a) a world of 1 over NCCL: scaling_bench at its defaults and the
    # unsharded references of (b) and (c)
    (one,) = _world(1, "nccl")
    sc = one["scaling"]
    print(f"[15 worlds] (a) scaling_bench, world of 1 over "
          f"{sc['backend']} on {one['card']}: {json.dumps(sc)}", flush=True)
    print(f"[15 worlds] (a) the same 65,536 trials unsharded in that "
          f"process: {one['bp_cws']:.1f} cw/s, counters {one['bp']}; "
          f"references: ALP {WORLD_ALP_TRIALS} trials {one['alp']} "
          f"({one['alp_cws']:.1f} cw/s), QP-ADMM {WORLD_ADMM_TRIALS} "
          f"trials streamed on {WORLD_ADMM_LANES} lanes at max_iter "
          f"{WORLD_ADMM_ITERS} {one['admm']} "
          f"({one['admm_cws']:.1f} cw/s); seconds scaling "
          f"{one['scaling_s']:.2f}, optimizer {one['opt_s']:.2f}", flush=True)
    if sc["backend"] != "nccl" or sc["layout"] != "kernel":
        raise AssertionError(f"world of 1: {sc}")
    _path_counts("15 worlds", one["scaling_launches"], need=("bp_decode",))
    _path_counts("15 worlds", one["admm_launches"], need=("admm_iterate",))
    _path_counts("15 worlds", one["opt_launches"], need=("admm_iterate",))
    if sc["bp_decode_launches"][0] <= 0:
        raise AssertionError("scaling_bench did not launch bp_decode")
    if [sc["counters_1dev"][k] for k in sc["counters_1dev"]] != one["bp"]:
        raise AssertionError(f"world of 1 {sc['counters_1dev']} against "
                             f"unsharded {one['bp']}")

    # (b), (c) a world of 2 on the one card over gloo
    two = _world(2, "gloo")
    sc2 = two[0]["scaling"]
    print(f"[15 worlds] (b) scaling_bench, world of 2 over gloo on one card "
          f"(a functional check: two ranks share one card, so its "
          f"efficiency is no scaling figure): {json.dumps(sc2)}", flush=True)
    for r in two:
        bp_n = r["bp_launches"]["bp_decode"]
        alp_n = r["alp_launches"]["pdhg_chunk"]
        print(f"[15 worlds] (b) rank {r['rank']} on {r['device']}: BP "
              f"{r['bp']} ({r['bp_cws']:.1f} cw/s, {bp_n} bp_decode "
              f"launches), ALP {r['alp']} ({r['alp_cws']:.1f} cw/s, "
              f"{alp_n} pdhg_chunk launches), QP-ADMM {r['admm']} "
              f"({r['admm_cws']:.1f} cw/s)", flush=True)
        admm_n = r["admm_launches"]["admm_iterate"]
        opt_n = r["opt_launches"]["admm_iterate"]
        print(f"[15 worlds] (b) rank {r['rank']}: admm_iterate launches, "
              f"QP-ADMM streamed {admm_n}, optimizer {opt_n}", flush=True)
        if min(bp_n, alp_n, admm_n, opt_n) <= 0:
            raise AssertionError(f"rank {r['rank']} launched bp_decode "
                                 f"{bp_n}, pdhg_chunk {alp_n}, admm_iterate "
                                 f"{admm_n} and {opt_n} times")
        for key in ("bp", "alp", "admm"):
            if r[key] != one[key]:
                raise AssertionError(f"rank {r['rank']} {key} {r[key]} "
                                     f"against unsharded {one[key]}")
        if r["backend"] != "gloo" or min(r["scaling"][
                "bp_decode_launches"]) <= 0:
            raise AssertionError(f"rank {r['rank']}: {r['scaling']}")
    if sc2["counters_ndev"] != sc["counters_1dev"]:
        raise AssertionError(f"world of 2 {sc2['counters_ndev']}")
    same_state = two[0].get("opt_state") == one.get("opt_state") is not None
    same_log = two[0]["opt_lines"] == one["opt_lines"]
    silent = two[1]["opt_lines"] == [] and "opt_state" not in two[1]
    print(f"[15 worlds] (c) optimizer, population 2 over the world of 2 "
          f"against the world of 1 ({WORLD_OPT}): state equal {same_state}, "
          f"log lines equal {same_log} ({len(one['opt_lines'])} lines), "
          f"rank 1 silent {silent}, final FER {two[0]['opt_final']} "
          f"(world of 1 {one['opt_final']}), seconds {two[0]['opt_s']:.2f} "
          f"({one['opt_s']:.2f})", flush=True)
    for line in one["opt_lines"]:
        print(f"[15 worlds] (c) {line.strip()}", flush=True)
    if not (same_state and same_log and silent):
        raise AssertionError("the sharded optimizer differs from world 1")

    # NCCL refuses two ranks on one card: that world must fail, not run
    rc, _, err, secs = _launch(
        _torchrun(2, "-m", "ldpc_tpu_torch.apps.scaling_bench", "--trials",
                  "8192", "--batch-per-device", "1024", "--matrix",
                  os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "data", "optimalH.txt")), 120)
    print(f"[15 worlds] two ranks on one card over NCCL: exit {rc} after "
          f"{secs:.2f} s; 'Duplicate GPU' in its errors: "
          f"{'Duplicate GPU' in err}", flush=True)
    if rc in (0, None):
        raise AssertionError("a NCCL world of 2 on one card did not fail")


def _host_call(fn, *args, repeats=1, **kwargs):
    """``fn``'s result and the median of ``repeats`` calls' milliseconds
    by the host clock."""
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        times.append((time.perf_counter() - t0) * 1e3)
    return out, sorted(times)[len(times) // 2]


def phase_native():
    """Phase 16; returns the host core's JSON entry."""
    import numpy as np
    from ldpc_tpu_torch import _native
    from ldpc_tpu_torch.apps import optimize_h
    from ldpc_tpu_torch.codes import gf2
    from ldpc_tpu_torch.codes.io import read_pcm
    from ldpc_tpu_torch.codes.qc import QCMatrix
    from ldpc_tpu_torch.config import OptimizeConfig
    from ldpc_tpu_torch.decoders.admm import (TABLES, ADMMStructure,
                                              _from_h_numpy)

    if _native.load() is None:
        raise AssertionError("LDPC_TPU_NO_NATIVE is set: phase 16 needs "
                             "the host core")
    _agc_counts(reset=True, counters=ALL_COUNTERS)
    with open(OPT_STATE) as f:
        chains = [QCMatrix(OptimizeConfig().block_size,
                           np.array(c["present"], bool),
                           np.array(c["shifts"], np.int64))
                  for c in json.load(f)["chains"]]
    rng = np.random.default_rng(NATIVE_SEED)
    groups = [(name, [read_pcm(f"data/{name}.txt")], NATIVE_REPEATS)
              for name in NATIVE_FILES]
    groups += [("mutation", [qc.random_mutation(rng).to_dense()
                             for qc in chains], 1)
               for _ in range(NATIVE_GENERATIONS)]

    def same_tables(a, b):
        return ((a.n, a.n_var, a.n_con) == (b.n, b.n_var, b.n_con)
                and all(getattr(a, k).dtype == getattr(b, k).dtype
                        and np.array_equal(getattr(a, k), getattr(b, k))
                        for k in TABLES))

    ms, differ, singular, inputs = {}, [], 0, 0
    for label, hs, repeats in groups:
        caps = optimize_h._caps_for(hs)
        for h in hs:
            inputs += 1
            calls = {
                "gf2_nullspace": (
                    _host_call(gf2.gf2_nullspace, h, repeats=repeats),
                    _host_call(gf2._nullspace_numpy, h, repeats=repeats)),
                "from_h": (
                    _host_call(ADMMStructure.from_h, h, repeats=repeats),
                    _host_call(_from_h_numpy, h, repeats=repeats)),
                "from_h at caps": (
                    _host_call(ADMMStructure.from_h, h, repeats=repeats,
                               **caps),
                    _host_call(_from_h_numpy, h, repeats=repeats, **caps))}
            for what, ((got, t_got), (want, t_want)) in calls.items():
                if what == "gf2_nullspace":
                    same = got[1] == want[1] and (
                        not got[1] or np.array_equal(got[0], want[0]))
                    singular += not got[1]
                else:
                    same = same_tables(got, want)
                if not same:
                    differ.append((label, inputs, what))
                per = ms.setdefault(label, {}).setdefault(what, ([], []))
                per[0].append(t_got)
                per[1].append(t_want)
    # ms per call: a file's median over NATIVE_REPEATS calls, the mean
    # over the mutations
    ms = {label: {what: (float(np.mean(a)), float(np.mean(b)))
                  for what, (a, b) in per.items()}
          for label, per in ms.items()}
    _path_counts("16 native", _agc_counts(counters=ALL_COUNTERS))
    for label, per in ms.items():
        print(f"[16 native] {label}: ms per call (native, NumPy): "
              + "; ".join(f"{what} {a:.4f}, {b:.4f} ({b / a:.1f}x)"
                          for what, (a, b) in per.items()), flush=True)
    print(f"[16 native] {inputs} inputs ({len(NATIVE_FILES)} files, "
          f"{inputs - len(NATIVE_FILES)} QC mutations, {singular} "
          f"singular): native = NumPy in G and ok and in every table with "
          f"no caps and at _caps_for caps; (input, call) pairs differing: "
          f"{differ}", flush=True)
    if differ or singular == 0:
        raise AssertionError(f"host core differs from NumPy: {differ}; "
                             f"singular inputs {singular}")
    return {"name": "ldpc_host", "route": "c++ (g++, host)",
            "source": "ldpc_tpu_torch/_native/ldpc_host.cpp",
            "counterpart": "ldpc_tpu/_native/ldpc_host.cpp",
            "inputs": inputs, "singular": singular, "differ": len(differ),
            "ms_native_numpy": {label: {what: [round(a, 4), round(b, 4)]
                                        for what, (a, b) in per.items()}
                                for label, per in ms.items()}}


def phase_before_after():
    import shutil

    from ldpc_tpu_torch.harness.reference_data import Z_BOUND, z_score
    from scripts import torch_opt_before_after as tool

    os.makedirs("build", exist_ok=True)
    shutil.copy(OPT_STATE, BA_STATE)
    _agc_counts(reset=True, counters=ALL_COUNTERS)
    t0 = time.perf_counter()
    out = tool.before_after(BA_STATE, BA_OPTIMIZED, BA_TRIALS, device="cuda")
    secs = time.perf_counter() - t0
    counts = _agc_counts(counters=ALL_COUNTERS)
    _path_counts("17 before/after", counts, need=("admm_iterate",))
    with open(BA_JAX) as f:
        jax_out = json.load(f)
    keys_ok = (set(out) == set(jax_out) and all(
        set(out[k]) == set(jax_out[k]) for k in ("objective_config",
                                                 "report_config")))
    zs = {k: z_score(out[k], out["trials"], jax_out[k], jax_out["trials"])
          for k in BA_GATED}
    print(f"[17 before/after] {json.dumps(out)}", flush=True)
    print(f"[17 before/after] the JAX run's record "
          f"({jax_out['trials']} trials): {json.dumps(jax_out)}", flush=True)
    print(f"[17 before/after] keys equal to the JAX record's: {keys_ok}; z "
          f"against the JAX run: "
          + ", ".join(f"{k} {out[k]:.4f} / {jax_out[k]:.4f} (z {z:+.2f})"
                      for k, z in zs.items())
          + f"; {secs:.2f} s for two evaluator calls of 4 matrices x "
          f"{BA_TRIALS} trials",
          flush=True)
    if not keys_ok:
        raise AssertionError(f"before/after keys {sorted(out)} differ from "
                             f"the JAX record's {sorted(jax_out)}")
    far = {k: z for k, z in zs.items() if not abs(z) < Z_BOUND}
    if far:
        raise AssertionError(f"before/after FERs outside Z_BOUND of the JAX "
                             f"run: {far}")


def phase_channel():
    import torch
    from ldpc_tpu_torch import bench
    from ldpc_tpu_torch.channel import awgn
    from ldpc_tpu_torch.codes.gf2 import gf2_nullspace
    from ldpc_tpu_torch.codes.io import read_pcm
    from ldpc_tpu_torch.ops import channel_kernel

    dev = torch.device("cuda")
    g, _ = gf2_nullspace(read_pcm(str(bench.MATRIX)))
    key = awgn.noise_key(CHANNEL_SEED)
    sigmas, scales = awgn.snr_table(CHANNEL_SNRS, dev)
    rows = {}
    for bsz, n in CHANNEL_SHAPES:
        gen = torch.Generator().manual_seed(bsz)
        table = awgn.gen_random_codewords(g, bsz + 5, gen, dev)
        bits = table.index_select(0, torch.randperm(bsz + 5, generator=gen)
                                  [:bsz].to(dev))
        trials = (2**32 + 11 + 3 * torch.arange(2 * bsz, device=dev)).flip(
            0)[::2]
        sid = torch.arange(bsz, device=dev) % len(CHANNEL_SNRS)
        differ = {}
        for form, sigma, scale in (
                ("scalar", *awgn.noise_scales(CHANNEL_SNRS[0])),
                ("lanes", sigmas[sid], scales[sid])):
            before = channel_kernel.LAUNCHES
            got = channel_kernel.awgn_channel(bits, trials, key, sigma,
                                              scale)
            launched = channel_kernel.LAUNCHES - before
            want = awgn.channel_ref(bits, trials, CHANNEL_SEED, sigma, scale)
            differ[form] = {k: int((a != b).sum()) for k, a, b in
                            zip(("y", "llr", "hd"), got, want)}
            if launched != 1 or any(differ[form].values()):
                raise AssertionError(
                    f"the channel kernel at {bsz} x {n} ({form}) differs "
                    f"from its twin: {differ[form]}, {launched} launches")
        sigma, scale = awgn.noise_scales(CHANNEL_SNRS[0])

        def kernel():
            return channel_kernel.awgn_channel(bits, trials, key, sigma,
                                               scale)

        def twin():
            return awgn.channel_ref(bits, trials, CHANNEL_SEED, sigma, scale)

        ms = _graph_ms(kernel, [()] * CHANNEL_CALLS)
        events_ms = _time_ms(kernel)
        plain_ms = _graph_ms(twin, [()] * CHANNEL_TWIN_CALLS)
        # bits and trial indices in, y, the LLRs and the count out
        nbytes = bsz * n * (1 + 4 + 4) + bsz * (8 + 8)
        rows[(bsz, n)] = {
            "max_abs_err": 0, "ms": ms, "plain_ms": plain_ms,
            "library_ms": None, "events_ms": events_ms,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "differ": differ, "shape": f"{bsz}x{n} optimalH codewords, "
            f"seed {CHANNEL_SEED}, SNR {CHANNEL_SNRS[0]:+.1f} dB, device "
            f"time (CUDA graph, warm)"}
        print(f"[18 channel] {bsz} x {n}: y, llr and hd equal the twin's "
              f"bit for bit (scalar and per-lane factors, {differ}); kernel "
              f"{ms:.6f} ms (CUDA graph of {CHANNEL_CALLS} calls; "
              f"{events_ms:.6f} ms by events), twin {plain_ms:.4f} ms; bound "
              f"{rows[(bsz, n)]['bound_ms']:.6f} ms by bytes "
              f"({nbytes / 1e6:.2f} MB), "
              f"{rows[(bsz, n)]['bound_ms'] / ms:.3f} of the kernel's time",
              flush=True)
    return rows


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
    launches, channel_launches = _timed("4 main path", phase_main_path)
    pdhg = _timed("5 pdhg-vs-ref", phase_pdhg_vs_ref)
    pdhg_launches, pdhg_tiers = _timed("6 alp path", phase_alp_path)
    agc_rows = _timed("7 agc-kernels", phase_agc_kernels_vs_ref)
    agc_launches, tiers = _timed("8 agc path", phase_agc_path)
    h02_launches, h02_tiers = _timed("9 h02 alp", phase_h02_alp)
    admm_row = _timed("10 qp-admm path", phase_qpadmm_path)
    _timed("11 full lp", phase_full_lp)
    _timed("12 multi-snr", phase_multi_snr)
    _timed("13 apps", phase_apps)
    admm_row.update(_timed("14 optimizer", phase_optimizer))
    _timed("15 worlds", phase_worlds)
    host_core = _timed("16 native", phase_native)
    _timed("17 before/after", phase_before_after)
    channel = _timed("18 channel", phase_channel)
    head = rows[-3.0]
    keys = ("max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by")
    kernels = [{
        "name": "bp_decode", "route": "cuda",
        "source": "ldpc_tpu_torch/csrc/bp_decode.cu",
        "replaces": "ldpc_tpu/ops/pallas/bp_kernel.py:43",
        "launches": launches, **{k: head[k] for k in keys},
        "lanes_differ": head["lanes_differ"],
        "shape": f"{LANES}x280 f32 llr, optimalH, {MAX_ITER} it, SNR -3 dB",
    }, {
        "name": "pdhg_chunk", "route": "cuda",
        "source": "ldpc_tpu_torch/csrc/pdhg_chunk.cu",
        "replaces": "ldpc_tpu/ops/pallas/pdhg_kernel.py:72",
        "launches": pdhg_launches, **{k: pdhg[k] for k in keys},
        "shape": pdhg["shape"], "launches_per_tier": pdhg_tiers,
        "tiers": pdhg["tiers"], "h02_launches": h02_launches,
        "h02_launches_per_tier": h02_tiers,
    }]
    # the AGC-ALP kernels: the largest error over the shapes checked; the
    # times at the deepest shape, for the matvecs at the tier of their worst
    # fraction of the int8 bound with a cold L2
    for name, src, replaces in (
            ("gf2_eliminate", "gf2_gauss.cu",
             "ldpc_tpu/ops/pallas/gauss_kernel.py:64"),
            ("gemv_fwd", "gemv.cu", "ldpc_tpu/ops/pallas/gemv_kernel.py:79"),
            ("gemv_tr", "gemv.cu", "ldpc_tpu/ops/pallas/gemv_kernel.py:87"),
            ("normal_build", "normal_build.cu",
             "ldpc_tpu/ops/pallas/gemv_kernel.py:142"),
            ("chol_diag_inv", "chol_diag_inv.cu",
             "ldpc_tpu/ops/pallas/chol_kernel.py:45"),
            ("ipm_step_len", "ipm_step.cu",
             "XLA fusion, ldpc_tpu/ops/ipm_solver.py:222-267"),
            ("ipm_update", "ipm_step.cu",
             "XLA fusion, ldpc_tpu/ops/ipm_solver.py:222-267")):
        entry = {"name": name, "route": "cuda",
                 "source": f"ldpc_tpu_torch/csrc/{src}", "replaces": replaces,
                 "launches": agc_launches[name]}
        if name == "gf2_eliminate":
            # the largest error over the three shapes; the times at the
            # path's shape (optimalH), the other shapes' beside them
            row = agc_rows[name][0]
            entry.update({k: row[k] for k in keys}, shape=row["shape"],
                         device_ms=row["device_ms"],
                         ns_per_column=row["ns_per_column"],
                         shapes=agc_rows[name])
            entry["max_abs_err"] = max(r["max_abs_err"]
                                       for r in agc_rows[name])
        elif name == "normal_build":
            # the largest error over the tiers and the ragged slice; the
            # times at the deepest tier, with a cold L2
            row = _worst_and_last(agc_rows[name])
            entry.update({k: row[k] for k in keys}, shape=row["shape"],
                         launches_per_tier=tiers[name],
                         tiers=agc_rows[name])
            entry["max_abs_err"] = max(row["max_abs_err"],
                                       agc_rows["normal_ragged"])
        elif name in tiers:
            per_tier = agc_rows[name]
            row = min(per_tier, key=lambda r: r["frac"])
            entry.update(
                max_abs_err=max([r["max_abs_err"] for r in per_tier]
                                + [agc_rows["gemv_ragged"][name]]),
                ms=row["cold_ms"], plain_ms=row["cold_plain_ms"],
                library_ms=row["cold_library_ms"],
                bound_ms=row["bound_ms"], bound_by=row["bound_by"],
                worst_tier=row["t"], worst_fraction=row["frac"],
                host_us=agc_rows["host_us"][name][0],
                library_host_us=agc_rows["host_us"][name][1],
                shape=row["shape"] + ", cold L2, device time (CUDA graph)")
            # the path's matvec time: launches per tier x cold time per call
            on_path = sum(tiers[name].get(r["t"], 0) * r["cold_ms"]
                          for r in per_tier)
            print(f"[8 agc path] {name}: {sum(tiers[name].values())} "
                  f"launches, ~{on_path:.3f} ms on the path at phase 7's "
                  f"cold times per tier", flush=True)
        elif name.startswith("ipm_"):
            # bit for bit at every shape; the times at the path's deepest
            # tier, device time (CUDA graph), the other shapes' beside them
            row = next(r for r in agc_rows[name]
                       if (r["lanes"], r["t"], r["n"]) == (AGC_LANES,
                                                           AGC_CAP, 280))
            entry.update({k: row[k] for k in keys},
                         shape=row["shape"] + ", cold L2, device time (CUDA "
                         "graph)", warm_ms=row["warm_ms"],
                         floor_ms=row["floor_ms"], plan=row["plan"],
                         events_ms=row["events_ms"],
                         plain_events_ms=row["plain_events_ms"],
                         plain_launches=row["plain_launches"],
                         tiers=agc_rows[name])
        else:
            row = _worst_and_last(agc_rows[name])
            entry.update({k: row[k] for k in keys}, shape=row["shape"])
            if "device_ms" in row:
                entry["device_ms"] = row["device_ms"]
        kernels.append(entry)
    kernels.append({"name": "admm_iterate", "route": "cuda",
                    "source": "ldpc_tpu_torch/csrc/admm_iterate.cu",
                    "replaces":
                        "XLA fusion, ldpc_tpu/decoders/admm.py:184-262",
                    **admm_row})
    head = channel[(LANES, 280)]
    kernels.append({"name": "awgn_channel", "route": "cuda",
                    "source": "ldpc_tpu_torch/csrc/awgn_channel.cu",
                    "replaces": "XLA fusion, "
                                "ldpc_tpu/harness/experiment.py:107-118",
                    "launches": channel_launches,
                    **{k: head[k] for k in keys},
                    "events_ms": head["events_ms"], "shape": head["shape"],
                    "shapes": [{"lanes": b, "n": n, **row}
                               for (b, n), row in channel.items()]})
    print(f"[total] {time.perf_counter() - t_start:.2f} s", flush=True)
    print(json.dumps({"host_core": host_core}))
    print(json.dumps({"kernels": kernels}))
    print(card_stamp(torch.device("cuda", 0)))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--world"]:      # a rank of phase 15's worlds
        sys.exit(world_rank(*sys.argv[2:4]))
    sys.exit(main())
