"""Before/after FER of the matrix optimizer's run, on one CUDA device: the
PyTorch port's counterpart of ``scripts/opt_before_after.py``.

The reference's headline optimization artifact is a QP-ADMM FER drop from
its starting matrix to its optimized one (``optimize_H.cpp:88-135``). The
optimizer (``ldpc_tpu_torch/apps/optimize_h.py``) checkpoints its best
matrix and a JSON state file whose ``"initial"`` holds the run's starting
matrix (the state format is the JAX package's, so either package's state
serves). This script scores four matrices with one
:class:`~ldpc_tpu_torch.apps.optimize_h.PopulationEvaluator` call each, on
shared codewords and noise: the initial matrix (re-derived from
``OptimizeConfig``'s seed with a warning when the state lacks it, or under
``--seed-init``), the optimized one, the reference's ``data/optimalH.txt``
and ``data/H05.txt``. It does so at the objective's config (QP-ADMM alpha
1.95, mu 0.5, 1,000 iterations) and at the report's (1.2, 0.55, 10,000),
with ``trials`` trials (10,000) at -3 dB and the optimizer's seed, and
writes the JAX script's keys to ``reports/optimize_before_after_torch.json``
(the JAX run's ``reports/optimize_before_after.json`` stays as it is).

Run: python -m scripts.torch_opt_before_after [trials] [--seed-init]
         [--state data/optimize_state.json]
         [--optimized data/optimalH_tpu.txt] [--device cpu]

By default it reads the port's own run, ``data/optimize_state_torch.json``
and ``data/optimalH_torch.txt``; ``--state`` and ``--optimized`` take
another run's files, such as the JAX package's.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from ldpc_tpu_torch.apps.optimize_h import PopulationEvaluator  # noqa: E402
from ldpc_tpu_torch.codes.io import read_pcm  # noqa: E402
from ldpc_tpu_torch.codes.qc import QCMatrix  # noqa: E402
from ldpc_tpu_torch.config import OptimizeConfig  # noqa: E402

DATA = ROOT / "data"
OUT = ROOT / "reports" / "optimize_before_after_torch.json"
REPORT = dict(admm_alpha=1.2, admm_mu=0.55, admm_max_iter=10000)
# each file's flag, and the JAX package's run's file for it
JAX_RUN = {"--state": "data/optimize_state.json",
           "--optimized": "data/optimalH_tpu.txt"}


def _existing(path, flag: str) -> str:
    if not os.path.isfile(path):
        raise FileNotFoundError(f"{path} not found: pass {flag} with the "
                                f"optimizer run's file (the JAX package's "
                                f"run: {flag} {JAX_RUN[flag]})")
    return str(path)


def before_after(state_path=DATA / "optimize_state_torch.json",
                 optimized_path=DATA / "optimalH_torch.txt",
                 trials: int = 10_000, seed_init: bool = False,
                 device="cuda", max_iter: int | None = None) -> dict:
    """The JAX script's record for the run whose state and best matrix are
    at ``state_path`` and ``optimized_path``: each config's FER of the
    initial, optimized, reference optimalH and H05 matrices on ``trials``
    trials. ``max_iter`` (None: each config's own) caps QP-ADMM's
    iterations of both configs; the record states the iterations run.
    Raises ``FileNotFoundError`` naming the flag of a missing file."""
    state_path = _existing(state_path, "--state")
    optimized_path = _existing(optimized_path, "--optimized")
    cfg = OptimizeConfig()
    with open(state_path) as f:
        st = json.load(f)
    if "initial" in st and not seed_init:
        init = QCMatrix(cfg.block_size,
                        np.array(st["initial"]["present"], bool),
                        np.array(st["initial"]["shifts"],
                                 np.int64)).to_dense()
    else:
        print("WARNING: state without the initial matrix (or --seed-init); "
              "re-deriving it from OptimizeConfig's defaults (wrong if the "
              "run used --init-matrix or another seed)", file=sys.stderr)
        rng = np.random.default_rng(cfg.seed)
        init = QCMatrix.random(rng, cfg.block_size, cfg.block_rows,
                               cfg.block_cols).to_dense()
    mats = [init, read_pcm(optimized_path),
            read_pcm(str(DATA / "optimalH.txt")),
            read_pcm(str(DATA / "H05.txt"))]
    n = cfg.block_cols * cfg.block_size
    cfg_rep = OptimizeConfig(**REPORT)

    def score(c):
        # one evaluate call: the four matrices on shared codewords and noise
        iters = min(c.admm_max_iter, max_iter or c.admm_max_iter)
        ev = PopulationEvaluator(c, n, device=device)
        return ev.evaluate(mats, cfg.seed, trials, max_iter=iters), iters

    fers, iters = score(cfg)
    rep, rep_iters = score(cfg_rep)
    return dict(trials=trials, snr=cfg.snr,
                proposals_evaluated=st["generation"],
                objective_config=dict(alpha=cfg.admm_alpha, mu=cfg.admm_mu,
                                      admm_iters=iters),
                fer_initial=float(fers[0]), fer_optimized=float(fers[1]),
                fer_reference_optimalH=float(fers[2]),
                fer_H05=float(fers[3]),
                improvement=float(fers[0] - fers[1]),
                report_config=dict(alpha=cfg_rep.admm_alpha,
                                   mu=cfg_rep.admm_mu, admm_iters=rep_iters),
                report_fer_initial=float(rep[0]),
                report_fer_optimized=float(rep[1]),
                report_fer_reference_optimalH=float(rep[2]),
                report_fer_H05=float(rep[3]))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("trials", nargs="?", type=int, default=10_000)
    p.add_argument("--seed-init", action="store_true",
                   help="re-derive the initial matrix from the seed")
    p.add_argument("--state", default=str(DATA / "optimize_state_torch.json"))
    p.add_argument("--optimized", default=str(DATA / "optimalH_torch.txt"))
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    out = before_after(args.state, args.optimized, args.trials,
                       args.seed_init, args.device)
    OUT.parent.mkdir(exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
