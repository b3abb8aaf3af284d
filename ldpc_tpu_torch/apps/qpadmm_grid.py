"""QP-ADMM (alpha, mu) grid search, the ``make run_qpadmm_params``
equivalent (``qpadmm_params.cpp``; counterpart of
``ldpc_tpu/apps/qpadmm_grid.py``).

The 61 x 61 grid (``qpadmm_params.cpp:51-58``) is decoded ``batch_cells``
cells at a time as one :meth:`QPADMMDecoder.decode_batch_params` call over
``cells x trials`` lanes, each lane with its cell's (alpha, mu); the JAX
package ``vmap``s the same decode over cells. Cells that fail the
precondition ``min(e) * mu > alpha`` (``qp_admm.h:108-114``) get FER 1.0 on
the host and use no device time. Every cell decodes the same transmitted
words and noise (the reference's per-trial determinism,
``experiment.h:97``): codewords from ``seed``, noise from ``seed + 1``, as
in the port's sweep app.

    python -m ldpc_tpu_torch.apps.qpadmm_grid --trials 1000 [--device cuda]
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..channel.awgn import gen_random_codewords, noise_scales, transmit
from ..codes.gf2 import gf2_nullspace
from ..codes.io import read_pcm
from ..config import GridSearchConfig, add_dataclass_args, apply_args
from ..decoders.admm import QPADMMDecoder
from ..decoders.base import resolve_device

__all__ = ["grid_channel", "main", "run_grid"]


def grid_channel(cfg: GridSearchConfig, h, device: torch.device):
    """The channel every cell shares: (codewords (T, n) uint8, LLRs (T, n)
    float32) on ``device``."""
    g, ok = gf2_nullspace(h)
    if not ok:
        raise ValueError("singular matrix")
    cw = gen_random_codewords(g, cfg.trials,
                              torch.Generator().manual_seed(cfg.seed), device)
    idx = torch.arange(cfg.trials, dtype=torch.int64, device=device)
    y = transmit(cw, cfg.snr, cfg.seed + 1, idx)
    return cw, noise_scales(cfg.snr)[1] * y


def run_grid(cfg: GridSearchConfig, device: torch.device | str = "cuda",
             log=print):
    """FER of every (alpha, mu) cell; returns ({cell: fer}, (best fer,
    alpha, mu))."""
    device = resolve_device(device)
    h = read_pcm(cfg.matrix)
    log(f"n={h.shape[1]} k={h.shape[0]}", file=sys.stderr)
    cw, llrs = grid_channel(cfg, h, device)
    dec = QPADMMDecoder(h, max_iter=cfg.admm_max_iter,
                        eps_stop=cfg.admm_eps_stop, device=device)
    e_min = dec.structure.e_min

    alphas = np.linspace(cfg.alpha_min, cfg.alpha_max, cfg.alpha_count)
    mus = np.linspace(cfg.mu_min, cfg.mu_max, cfg.mu_count)
    grid = [(a, m) for a in alphas for m in mus]
    feasible = [(a, m) for (a, m) in grid if e_min * m > a]
    log(f"{len(grid)} cells, {len(feasible)} feasible", file=sys.stderr)

    fers = {cell: 1.0 for cell in grid}
    trials = cfg.trials

    def lanes(vals):
        """Each cell's value on its ``trials`` lanes."""
        return torch.tensor(vals, dtype=torch.float32).repeat_interleave(
            trials).to(device)

    t0 = time.perf_counter()
    best = (2.0, -1.0, -1.0)
    for i in range(0, len(feasible), cfg.batch_cells):
        chunk = feasible[i:i + cfg.batch_cells]
        cells = len(chunk)
        res = dec.decode_batch_params(llrs.repeat(cells, 1),
                                      lanes([a for a, _ in chunk]),
                                      lanes([m for _, m in chunk]))
        correct = res.success & (res.bits == cw.repeat(cells, 1)).all(-1)
        # FER = 1 - correct / total (experiment.h:59), in float32 as JAX
        out = (1.0 - correct.view(cells, trials).to(torch.float32)
               .mean(dim=1)).tolist()
        for cell, fer in zip(chunk, out):
            fers[cell] = fer
            if fer < best[0]:
                best = (fer, cell[0], cell[1])
                log(f"new best fer found: {fer:.5f}| alpha={cell[0]:.5f}, "
                    f"mu={cell[1]:.5f}")
    dt = time.perf_counter() - t0

    log("Best parameters:")
    log(f"alpha={best[1]:.5f}")
    log(f"mu={best[2]:.5f}")
    log(f"fer={best[0]:.5f}")
    log(f"({len(feasible)} feasible cells x {trials} trials in {dt:.1f}s "
        f"= {len(feasible) * trials / max(dt, 1e-9):.0f} decodes/s)",
        file=sys.stderr)
    if cfg.grid_out:
        with open(cfg.grid_out, "w") as f:
            f.write("Alpha,Mu,FER\n")
            for (a, m), fer in sorted(fers.items()):
                f.write(f"{a:.6f},{m:.6f},{fer:.6f}\n")
        log(f"grid written to {cfg.grid_out}", file=sys.stderr)
    return fers, best


def main(argv=None):
    cfg = GridSearchConfig()
    p = argparse.ArgumentParser(description=__doc__)
    add_dataclass_args(p, cfg)
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda)")
    args = p.parse_args(argv)
    apply_args(cfg, args)
    return run_grid(cfg, device=args.device)


if __name__ == "__main__":
    main()
