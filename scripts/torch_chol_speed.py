"""The IPM's Newton-system Cholesky on one CUDA device: the fused factor and
solve (``csrc/chol_fused.cu``) against their twins and against the blocked
chain they replace, with device times and the factor's bound.

At each of ``SHAPES`` (lanes, n), on SPD matrices from a seed whose
diagonal spans e^{+-4} as the IPM's late systems do, with one lane that is
not SPD: the fused factor against the twin (``ops/chol_ref.py``
``chol_factor_ref``) within ``TOL`` of L's and V's scale, the solve's
residual against ``cholesky_ex`` + ``cholesky_solve`` (at most 10x theirs
plus 1e-3 |r|, ``tests/test_chol.py``'s rule), NaN in the bad lane only, a
second call bit-identical; then each path timed as a CUDA graph of calls
(device ms a call, median of ``ROUNDS`` graphs): the fused factor, the
fused solve, factor + two solves as a Newton step runs them, the chain's
factor (``ops/chol.py`` ``chain_cholesky``: ``bmm`` panels around
``chol_diag_inv``) with its two solves, and one ``chol_diag_inv`` call on
the lanes' 64 x 64 blocks; beside them the factor's bound (operations over
67 TFLOP/s or bytes over 3.35 TB/s, ``ldpc_bench/counts/chol_factor.py``'s
count) and the twin's time. Past the fused kernels' limit (n = 448 here,
H02's n = 640) ``blocked_cholesky`` takes the chain: checked the same way.
Exits non-zero when a check fails. The last line is one JSON object with every figure and
the card (name and power limit).

Time another layout (a constant of the source, such as ``kMaxGroups``) by
unpacking a tree under ``build/``, editing the constant there, and running
this file from inside that tree.

    python -m scripts.torch_chol_speed [--label NAME]
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys

import torch

from ldpc_tpu_torch.bench import card_stamp
from ldpc_tpu_torch.ops import chol_kernel
from ldpc_tpu_torch.ops.chol import (blocked_cho_solve, blocked_cholesky,
                                     chain_cholesky, fused)
from ldpc_tpu_torch.ops.chol_kernel import chol_diag_inv
from ldpc_tpu_torch.ops.chol_ref import (chol_factor_ref, chol_solve_ref,
                                         cholesky_nan)

SHAPES = ((128, 280), (256, 280), (128, 200), (16, 320), (7, 37),
          (16, 448), (128, 640))
TOL = 2e-4
REPLAYS = 20
ROUNDS = 3
CALLS = 4
F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
NB = 64


def _spd(bsz, n, seed, dev, boost=4.0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    a = torch.randn((bsz, n, n), generator=gen, device=dev)
    m = a @ a.transpose(1, 2) / n + torch.eye(n, device=dev)
    d = torch.exp((torch.rand((bsz, n), generator=gen, device=dev) * 2 - 1)
                  * boost)
    return (m * d[:, :, None] * d[:, None, :]).contiguous()


def bound_ms(bsz, n) -> tuple[float, str]:
    """The factor's least time: n^3 / 3 operations for the factor and
    w^3 / 3 for each diagonal block's inverse (w its columns below n);
    M read, L's and the blocks' lower triangles written, at the unpadded
    n."""
    widths = [min(NB, n - qs) for qs in range(0, n, NB)]
    ops = bsz * (n ** 3 / 3 + sum(w ** 3 / 3 for w in widths))
    nbytes = 4 * bsz * (n * n + n * (n + 1) / 2
                        + sum(w * (w + 1) / 2 for w in widths))
    t_ops, t_mem = ops / F32_FLOPS, nbytes / HBM_BYTES_PER_S
    return (1e3 * max(t_ops, t_mem),
            "operations" if t_ops >= t_mem else "bytes")


def _graph_ms(fn) -> float:
    """Device ms a call of ``fn()``: CALLS calls captured in a CUDA graph
    after a warm-up call, replayed REPLAYS times; the median of ROUNDS."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(ROUNDS):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(CALLS):
                fn()
        graph.replay()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(REPLAYS):
            graph.replay()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / (REPLAYS * CALLS))
    return statistics.median(times)


def _events_ms(fn, calls=10) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / calls


def _same(a, b) -> bool:
    return torch.equal(a.nan_to_num(7.0), b.nan_to_num(7.0))


def measure(bsz, n, dev) -> dict:
    m = _spd(bsz, n, 1000 + n, dev)
    bad = bsz // 2
    m[bad] = -torch.eye(n, device=dev)
    good = torch.ones(bsz, dtype=torch.bool, device=dev)
    good[bad] = False
    r = torch.randn((bsz, n), generator=torch.Generator(device=dev)
                    .manual_seed(n), device=dev)
    row = {"lanes": bsz, "n": n, "fused": fused(n, NB)}
    before = (chol_kernel.FACTOR_LAUNCHES, chol_kernel.SOLVE_LAUNCHES)
    fac = blocked_cholesky(m)
    x = blocked_cho_solve(fac, r)
    again = blocked_cholesky(m)
    x2 = blocked_cho_solve(again, r)
    lr, vr = chol_factor_ref(m)
    torch.cuda.synchronize()
    row["launches"] = [chol_kernel.FACTOR_LAUNCHES - before[0],
                       chol_kernel.SOLVE_LAUNCHES - before[1]]
    scale_l = float(lr[good].abs().max())
    scale_v = float(vr[:, good].abs().max())
    row["l_err"] = float((fac.l - lr)[good].abs().max()) / scale_l
    row["v_err"] = float((fac.inv_diag - vr)[:, good].abs().max()) / scale_v
    row["upper_zero"] = not bool(fac.l.triu(1).any()) and not bool(
        fac.inv_diag.triu(1).nan_to_num(1.0)[:, good].any())
    row["nan_lane_only"] = (bool(torch.isnan(fac.l[bad]).any())
                            and bool(torch.isnan(x[bad]).any())
                            and bool(fac.l[good].isfinite().all())
                            and bool(x[good].isfinite().all()))
    row["repeat_same"] = (_same(fac.l, again.l)
                          and _same(fac.inv_diag, again.inv_diag)
                          and _same(x, x2))
    x_ref = torch.cholesky_solve(r[..., None], cholesky_nan(m))[..., 0]

    def resid(v):
        return float((torch.bmm(m[good], v[good][..., None])[..., 0]
                      - r[good]).abs().max())

    row["residual"], row["residual_ref"] = resid(x), resid(x_ref)
    row["ok"] = (row["l_err"] <= TOL and row["v_err"] <= TOL
                 and row["upper_zero"] and row["nan_lane_only"]
                 and row["repeat_same"]
                 and row["residual"] <= 10 * row["residual_ref"]
                 + 1e-3 * float(r.abs().max())
                 and row["launches"] == ([2, 2] if row["fused"] else [0, 0]))

    def step():
        f = blocked_cholesky(m)
        blocked_cho_solve(f, r)
        return blocked_cho_solve(f, r)

    def chain_step():
        f = chain_cholesky(m)
        chol_solve_ref(f.l, f.inv_diag, r, n)
        return chol_solve_ref(f.l, f.inv_diag, r, n)

    w = min(n, NB)
    blocks = m[:, :w, :w].contiguous()
    blocks[bad] = torch.eye(w, device=dev)
    row["step_ms"] = _graph_ms(step)
    row["chain_step_ms"] = _graph_ms(chain_step)
    if row["fused"]:
        row["factor_ms"] = _graph_ms(lambda: blocked_cholesky(m))
        row["solve_ms"] = _graph_ms(lambda: blocked_cho_solve(fac, r))
        row["factor_events_ms"] = _events_ms(lambda: blocked_cholesky(m))
    row["chain_factor_ms"] = _graph_ms(lambda: chain_cholesky(m))
    row["diag_inv_ms"] = _graph_ms(lambda: chol_diag_inv(blocks))
    row["twin_ms"] = _events_ms(lambda: chol_factor_ref(m), calls=3)
    row["bound_ms"], row["bound_by"] = bound_ms(bsz, n)
    if row["fused"]:
        row["bound_share"] = row["bound_ms"] / row["factor_ms"]
    print(json.dumps(row), flush=True)
    return row


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--label", default="")
    p.add_argument("--shapes", default="",
                   help="lanes x n pairs, e.g. 128x280,16x448")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    shapes = SHAPES if not args.shapes else tuple(
        tuple(int(v) for v in s.split("x")) for s in args.shapes.split(","))
    rows = [measure(b, n, dev) for b, n in shapes]
    print(json.dumps({"label": args.label, "card": card_stamp(dev),
                      "rows": rows}), flush=True)
    return 0 if all(r["ok"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
