"""Benchmark sweep app, the ``make run`` equivalent (``main.cpp:42-92``;
counterpart of ``ldpc_tpu/apps/benchmark.py``).

Sweeps the configured decoders over the SNR grid, streaming rows into a
reference-format ``report.csv`` and an extended report (pseudo rate,
throughput, mean iterations, dropped cuts). Decoder names in the CSV match
the reference (``BP``, ``ALP``, ...).

    python -m ldpc_tpu_torch.apps.benchmark --decoders bp alp --snrs=-3.0 \\
        --trials 2048 [--device cuda]

On several devices, one process each (``--shard`` splits the trials over
them; rank 0 alone writes the reports and prints the rows):

    python -m torch.distributed.run --nproc-per-node 4 \\
        -m ldpc_tpu_torch.apps.benchmark --decoders bp --snrs=-3.0

Codewords come from ``torch.Generator().manual_seed(seed)`` and the channel
noise from ``seed + 1`` (JAX splits one PRNG key in two; torch has no
counterpart of ``jax.random.split``); every rank draws the same table.
"""
from __future__ import annotations

import argparse
import csv
import os
import sys

import torch

from ..channel.awgn import gen_random_codewords
from ..codes.gf2 import gf2_nullspace
from ..codes.io import read_pcm
from ..config import SweepConfig, add_dataclass_args, apply_args
from ..decoders import default_batch, make_decoder
from ..harness.experiment import run_experiment
from ..harness.report import ReportWriter
from ..parallel.distributed import (initialize_distributed, process_count,
                                    process_index)
from ..parallel.mesh import make_trial_mesh

__all__ = ["CSV_NAMES", "main", "run_sweep"]

CSV_NAMES = {"bp": "BP", "qp-admm": "QP-ADMM", "full-lp": "FullLP",
             "alp": "ALP", "agc-alp": "AGC-ALP"}


def run_sweep(cfg: SweepConfig, device: torch.device | str = "cuda",
              log=print) -> list[tuple[str, float, object]]:
    """Run every (decoder, SNR) point of ``cfg`` on ``device``; returns
    ``[(csv name, snr, ExperimentResult), ...]`` in run order. In a world of
    several processes with ``cfg.shard``, each point's trials are split
    over the ranks (every rank returns the summed counters). Rank 0 alone
    logs and writes the reports; every rank reads ``cfg.report`` to resume,
    so the ranks share the working directory."""
    sharding = None
    if cfg.shard and process_count() > 1:
        sharding = make_trial_mesh(device=device)
        device = sharding.device
    device = torch.device(device)
    writer = process_index() == 0
    if not writer:
        log = lambda *args, **kwargs: None        # noqa: E731
    h = read_pcm(cfg.matrix)
    if cfg.generator:
        g = read_pcm(cfg.generator)
    else:
        g, ok = gf2_nullspace(h)
        if not ok:
            raise ValueError(f"{cfg.matrix} is singular; cannot derive G")
    log(f"n={h.shape[1]} k={h.shape[0]}", file=sys.stderr)
    codewords = gen_random_codewords(
        g, cfg.trials, torch.Generator().manual_seed(cfg.seed), device)
    noise_seed = cfg.seed + 1
    if sharding is not None:
        log(f"shard: trials split over {sharding.num_devices} ranks "
            f"({sharding.backend})", file=sys.stderr)

    done: set[tuple[str, float]] = set()
    if cfg.resume:
        if os.path.exists(cfg.report):
            with open(cfg.report) as f:
                for rec in csv.DictReader(f):
                    done.add((rec["Method"], round(float(rec["SNR"]), 6)))
        log(f"resume: {len(done)} rows already present", file=sys.stderr)

    rows = []
    writers = []
    if writer:
        writers.append(ReportWriter(cfg.report, resume=cfg.resume))
        if cfg.extended_report:
            writers.append(ReportWriter(cfg.extended_report, extended=True,
                                        resume=cfg.resume))
    try:
        for kind in cfg.decoders:
            name = CSV_NAMES.get(kind, kind)
            todo = [s for s in cfg.snrs
                    if (name, round(float(s), 6)) not in done]
            if not todo:
                continue
            dec = make_decoder(kind, h, cfg.decoder_cfg, device=device)
            bs = cfg.batch_size or default_batch(kind)
            log(f"Algo: {name}")
            for snr in todo:
                res = run_experiment(dec, h, codewords, float(snr),
                                     noise_seed, bs, device=device,
                                     sharding=sharding)
                log(f"\tSNR: {snr}, FER: {res.fer:.5f}, "
                    f"(time={res.avg_time:.6f}s, "
                    f"{res.throughput:.0f} cw/s, pseudo={res.pseudo})")
                for w in writers:
                    w.write_row(name, float(snr), res)
                rows.append((name, float(snr), res))
    finally:
        for w in writers:
            w.close()
    return rows


def main(argv=None):
    cfg = SweepConfig()
    p = argparse.ArgumentParser(description=__doc__)
    add_dataclass_args(p, cfg)
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda)")
    args = p.parse_args(argv)
    apply_args(cfg, args)
    initialize_distributed(device=args.device)
    return run_sweep(cfg, device=args.device)


if __name__ == "__main__":
    main()
