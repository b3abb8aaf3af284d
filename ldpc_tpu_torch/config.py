"""Configuration (counterpart of ``ldpc_tpu/config.py``).

The reference's knobs are compile-time ``#define``s and top-of-file constants
(``main.cpp:1-2,23-40``). Here every knob is a dataclass field with a
command-line flag; the fields and defaults are the JAX package's, so a
command line means the same in both. ``OptimizeConfig``'s two output paths
are the port's own, so that a run with the defaults never overwrites the
JAX package's optimizer results.
"""
from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass, field

__all__ = ["DEFAULT_SNRS", "DecoderConfig", "GridSearchConfig",
           "OptimizeConfig", "SweepConfig", "add_dataclass_args",
           "apply_args"]

DEFAULT_SNRS = (-5.0, -4.5, -4.0, -3.5, -3.0, -2.5, -2.0, -1.5, -1.0, -0.5, 0.0)


@dataclass
class DecoderConfig:
    """Union of per-decoder hyperparameters (reference: main.cpp:28-40)."""

    bp_max_iter: int = 100
    bp_variant: str = "sumprod"          # or "minsum"
    # JAX's BP layout (edge | dense | mxu | pallas); accepted and unused
    # here: the port's BP runs the kernel for early-exit sumprod on CUDA
    # and bp_ref for everything else
    bp_layout: str = "mxu"
    admm_alpha: float = 1.2              # OPTIMAL config (main.cpp:30)
    admm_mu: float = 0.55
    admm_max_iter: int = 10000
    admm_eps_stop: float = 1e-5
    agc_max_rows: int = 1000             # main.cpp:38
    lp_max_rounds: int = 64              # ALP cut rounds cap
    # PDHG chunk length between error/stall checks of the adaptive solvers
    lp_iters: int = 64
    # FullLP's total PDHG iteration budget
    full_lp_iters: int = 2000
    # integrality-certificate tolerance: a first-order solve leaves up to
    # ~1.5e-2 noise on true vertex optima, while fractional LP optima have
    # coordinates >= 1/3 from integrality
    lp_int_tol: float = 3e-2


@dataclass
class SweepConfig:
    matrix: str = "data/optimalH.txt"
    generator: str | None = None         # None -> GF(2) nullspace of matrix
    decoders: tuple[str, ...] = ("bp", "qp-admm", "alp", "agc-alp")
    snrs: tuple[float, ...] = DEFAULT_SNRS
    trials: int = 10000                  # TESTS_NUM (main.cpp:25)
    batch_size: int = 0      # 0 = per-decoder default (decoders.DEFAULT_BATCH)
    seed: int = 239_239_239              # main.cpp:63
    report: str = "report.csv"
    extended_report: str | None = "report_extended.csv"
    resume: bool = False                 # skip (Method, SNR) rows already in
    # the report and append the rest (crash recovery at row granularity)
    shard: bool = True                   # shard trials over the devices
    decoder_cfg: DecoderConfig = field(default_factory=DecoderConfig)


@dataclass
class GridSearchConfig:
    """The (alpha, mu) grid search (``qpadmm_params.cpp:12-14,51-58``)."""

    matrix: str = "data/optimalH.txt"
    trials: int = 1000
    snr: float = -3.0
    alpha_min: float = 0.0
    alpha_max: float = 3.0
    alpha_count: int = 61
    mu_min: float = 0.0
    mu_max: float = 3.0
    mu_count: int = 61
    admm_max_iter: int = 1000
    admm_eps_stop: float = 1e-5
    seed: int = 239
    batch_cells: int = 16               # (alpha, mu) cells per decode call
    grid_out: str = ""                  # optional CSV: one FER row per cell


@dataclass
class OptimizeConfig:
    """The matrix optimizer (``optimize_H.cpp:12-14,124-136``), with a
    population of descent chains."""

    block_size: int = 20
    block_rows: int = 8
    block_cols: int = 14
    trials: int = 1000
    final_trials: int = 10000
    snr: float = -3.0
    admm_alpha: float = 1.95             # optimize_H.cpp:14 (not OPTIMAL)
    admm_mu: float = 0.5
    admm_max_iter: int = 1000
    generations: int = 10000             # proposals (optimize_H.cpp:133)
    population: int = 8                  # parallel descent chains (one
    # proposal per chain per generation; the reference is population=1)
    screen_trials: int = 256             # shared-noise screen size
    screen_iters: int = 600              # ADMM iteration cap for screens
    # only; accepts that can touch the saved matrix are always confirmed at
    # the full (admm_max_iter, trials) budget
    screen_margin: float = 0.03          # ~2 paired sigma at 256 trials; in
    # polish mode a proposal within this of the incumbent's screen FER
    # earns a full evaluation
    polish_margin: float = 0.04          # chains whose screen FER is within
    # this of the global best's switch from screen-greedy descent to
    # full-budget confirmed accepts (the reference's accept rule)
    kick_after: int = 60                 # consecutive rejections before a
    # chain widens its proposals to multi-block mutations
    kick_blocks: int = 3                 # blocks mutated per kicked proposal
    reseed_after: int = 200              # consecutive rejections before a
    # chain restarts (alternating global-best-perturbed / fresh random)
    seed: int = 239
    init_matrix: str | None = None       # warm start path; None -> random
    save_path: str = "data/optimalH_torch.txt"
    state_path: str = "data/optimize_state_torch.json"


def add_dataclass_args(parser: argparse.ArgumentParser, cfg) -> None:
    """One ``--field-name`` flag per field (nested dataclasses flattened);
    booleans parse "1/true/yes", tuples take space- or comma-separated
    values."""
    for f in dataclasses.fields(cfg):
        if dataclasses.is_dataclass(f.type) or dataclasses.is_dataclass(
                getattr(cfg, f.name)):
            add_dataclass_args(parser, getattr(cfg, f.name))
            continue
        default = getattr(cfg, f.name)
        name = "--" + f.name.replace("_", "-")
        if isinstance(default, bool):
            parser.add_argument(name, type=lambda s: s.lower() in
                                ("1", "true", "yes"), default=default)
        elif isinstance(default, tuple):
            ef = float if (default and isinstance(default[0], float)) else str
            elem = lambda s, ef=ef: tuple(ef(p) for p in s.split(",") if p)
            parser.add_argument(name, nargs="*", type=elem, default=default)
        elif default is None:
            parser.add_argument(name, type=str, default=None)
        else:
            parser.add_argument(name, type=type(default), default=default)


def apply_args(cfg, args: argparse.Namespace):
    """Copy parsed flags onto ``cfg`` (and its nested dataclasses)."""
    for f in dataclasses.fields(cfg):
        val = getattr(cfg, f.name)
        if dataclasses.is_dataclass(val):
            apply_args(val, args)
            continue
        if hasattr(args, f.name):
            new = getattr(args, f.name)
            if isinstance(val, tuple) and new is not None:
                # flatten per-arg comma groups from the tuple elem parser
                new = tuple(x for part in new
                            for x in (part if isinstance(part, tuple)
                                      else (part,)))
            setattr(cfg, f.name, new)
    return cfg
