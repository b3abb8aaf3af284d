"""AGC-ALP's throughput by batch width and by IPM mode, on one CUDA device.

Streams AGC-ALP (optimalH, -3 dB, the sweep app's seeds: codewords from
239239239, noise from the next seed) over the same trials at each batch
width, with the IPM solve as CUDA graphs (``ipm_graphs`` None, the default)
and as the eager loop (``ipm_graphs = False``), and prints per run: the
batch, the mode, cw/s, FER and its z against the golden 0.8704, mean
rounds, dropped cuts, the graphs captured inside the run and seconds. The
graph runs come twice per width, around the eager run: the first captures
the solve's graphs for each row tier it meets (inside its timed window),
the second replays them. Runs of one width must give the same counters.
With ``--modes eager`` it also times a tree that has no graph path (run
it with that tree's package on PYTHONPATH, for a parent commit).
Exits non-zero when a FER lies outside ``Z_BOUND`` or the counters differ.
The last line is one JSON object with every run and the card.

    python -m scripts.torch_agc_batch [--trials 512] [--batches 128 256]
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from ldpc_tpu_torch import bench
from ldpc_tpu_torch.channel.awgn import gen_random_codewords
from ldpc_tpu_torch.codes.gf2 import gf2_nullspace
from ldpc_tpu_torch.codes.io import read_pcm
from ldpc_tpu_torch.config import SweepConfig
from ldpc_tpu_torch.decoders.agc_alp import AGCALPDecoder
from ldpc_tpu_torch.harness.experiment import COUNTERS, run_experiment
from ldpc_tpu_torch.harness.reference_data import (REF_FER_OPT, SNR_GRID,
                                                   Z_BOUND, z_score)

SNR = -3.0


def _captures() -> int:
    """Graphs captured so far in this process (imported here, so that
    ``--modes eager`` also runs on a tree without the graph path)."""
    from ldpc_tpu_torch.ops import ipm_graph
    return ipm_graph.CAPTURES


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--trials", type=int, default=512)
    p.add_argument("--batches", type=int, nargs="+", default=[128, 256])
    p.add_argument("--modes", nargs="+", default=["graph", "eager", "graph"],
                   choices=["graph", "eager"])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = torch.device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    seed = SweepConfig().seed
    fer_ref = REF_FER_OPT["AGC-ALP"][SNR_GRID.index(SNR)]
    h = read_pcm(str(bench.MATRIX))
    g, _ = gf2_nullspace(h)
    cw = gen_random_codewords(g, args.trials,
                              torch.Generator().manual_seed(seed), dev)
    runs, bad = [], []
    for batch in args.batches:
        first = None
        for mode in args.modes:
            dec = AGCALPDecoder(h, device=dev)
            dec.ipm_graphs = None if mode == "graph" else False
            graph = mode == "graph"
            captures = _captures() if graph else 0
            t0 = time.perf_counter()
            res = run_experiment(dec, h, cw, SNR, seed + 1, batch,
                                 device=dev, warmup=False)
            secs = time.perf_counter() - t0
            z = z_score(res.fer, res.total, fer_ref)
            row = {"batch": batch, "mode": mode, "cw_s": res.throughput,
                   "fer": res.fer, "z": z, "trials": res.total,
                   "mean_rounds": res.sum_iterations / res.total,
                   "dropped": res.sum_dropped,
                   "captures": _captures() - captures if graph else 0,
                   "seconds": secs}
            print(" ".join(f"{k} {v:.4f}" if isinstance(v, float)
                           else f"{k} {v}" for k, v in row.items()),
                  flush=True)
            runs.append(row)
            counters = [getattr(res, k) for k in COUNTERS]
            first = first or counters
            if counters != first:
                bad.append(f"batch {batch} {mode}: counters {counters} != "
                           f"{first}")
            if not abs(z) < Z_BOUND:
                bad.append(f"batch {batch} {mode}: FER {res.fer} z {z:+.2f}")
    print(json.dumps({"agc_batch": runs, "snr": SNR,
                      "card": bench.card_stamp(dev)}), flush=True)
    for msg in bad:
        print(f"FAILED: {msg}", file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
