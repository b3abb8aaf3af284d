"""Scaling efficiency: BP decode throughput on one device against the whole
world (counterpart of ``ldpc_tpu/apps/scaling_bench.py``).

One process per device, started by ``torchrun``:

    python -m torch.distributed.run --nproc-per-node N \\
        -m ldpc_tpu_torch.apps.scaling_bench [--backend gloo]

Rank 0 alone measures ``throughput_1dev``; with more than one process the
whole world then measures ``throughput_ndev`` on ``--batch-per-device``
lanes per rank, and ``scaling_efficiency`` is ``throughput_ndev / (N *
throughput_1dev)``. Started without ``torchrun`` it measures one device.
Several ranks on one card (``--backend gloo``) check the sharded path; their
efficiency is no scaling figure. Rank 0 prints one JSON line.
"""
from __future__ import annotations

import argparse
import json

import torch

from ..channel.awgn import gen_random_codewords
from ..codes.gf2 import gf2_nullspace
from ..codes.io import read_pcm
from ..decoders.bp import BPDecoder
from ..harness.experiment import COUNTERS, run_experiment
from ..ops import bp_kernel
from ..parallel.distributed import (initialize_distributed, process_count,
                                    process_index)
from ..parallel.mesh import make_trial_mesh

__all__ = ["SEED", "main"]

SEED = 0                  # codewords; the noise uses SEED + 1


def _counters(res) -> dict:
    return {k: getattr(res, k) for k in COUNTERS}


def main(argv=None) -> dict:
    """Measure; rank 0 prints its JSON line. Every rank returns its own
    dict; only rank 0's holds ``throughput_1dev`` and the efficiency."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--matrix", default="data/optimalH.txt")
    p.add_argument("--trials", type=int, default=65536)
    p.add_argument("--snr", type=float, default=-3.0)
    p.add_argument("--batch-per-device", type=int, default=4096)
    p.add_argument("--bp-iters", type=int, default=50)
    # JAX's BP layout, accepted and unused as the sweep's --bp-layout; the
    # port reports the layout it ran under "layout"
    p.add_argument("--layout", default=None,
                   help="JAX's BP layout; accepted and ignored")
    p.add_argument("--device", default="cuda",
                   help="torch device type to run on (default: cuda)")
    p.add_argument("--backend", default=None,
                   help="torch.distributed backend (default: nccl on the "
                        "card, gloo on the CPU)")
    args = p.parse_args(argv)

    initialize_distributed(backend=args.backend, device=args.device)
    world = process_count()
    full = make_trial_mesh(device=args.device)
    device = full.device
    h = read_pcm(args.matrix)
    g, ok = gf2_nullspace(h)
    if not ok:
        raise ValueError(f"{args.matrix} is singular")
    cw = gen_random_codewords(g, args.trials,
                              torch.Generator().manual_seed(SEED), device)
    dec = BPDecoder(h, max_iter=args.bp_iters, device=device)

    def measure(sharding):
        return run_experiment(dec, h, cw, args.snr, SEED + 1,
                              batch_size=args.batch_per_device,
                              sharding=sharding)

    launches = bp_kernel.LAUNCHES
    one = make_trial_mesh(group=[0], device=device)
    res1 = measure(one) if one is not None else None
    full.barrier()              # the other ranks wait for rank 0's run
    res_n = measure(full) if world > 1 else None
    per_rank = torch.zeros(world, dtype=torch.int64, device=device)
    per_rank[full.rank] = bp_kernel.LAUNCHES - launches
    full.all_sum(per_rank)

    out = {"devices": world, "processes": world,
           "layout": "kernel" if device.type == "cuda" else "torch-ref",
           "backend": full.backend,
           "bp_decode_launches": per_rank.tolist()}
    if res1 is not None:
        out["throughput_1dev"] = round(res1.throughput, 1)
        out["counters_1dev"] = _counters(res1)
    if res_n is not None:
        out["throughput_ndev"] = round(res_n.throughput, 1)
        out["counters_ndev"] = _counters(res_n)
        if res1 is not None:
            out["scaling_efficiency"] = round(
                res_n.throughput / (res1.throughput * world), 4)
    if process_index() == 0:
        print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
