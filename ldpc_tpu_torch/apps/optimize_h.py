"""Population-parallel quasi-cyclic check-matrix optimization, the
``make optimize`` equivalent (``optimize_H.cpp``; counterpart of
``ldpc_tpu/apps/optimize_h.py``).

The reference runs a serial local descent: one random block mutation per
step, each scored by a 200-thread QP-ADMM FER estimate
(``optimize_H.cpp:88-104``). Here each generation proposes a population of
mutations and scores all of them in one decode:
:func:`~ldpc_tpu_torch.decoders.admm.decode_qp_admm_population` over the
candidates' structure tables, padded to shared capacities, on top of the
trial batch. The generation greedily accepts strict improvements, saves the
best matrix on every accept (``optimize_H.cpp:96-101``) and writes a JSON
state file that a later run resumes from (the JAX package's format: either
package resumes the other's state).

A candidate is scored as ``FER()`` scores it (``optimize_H.cpp:16-25``): a
singular H scores 1.0; otherwise codewords come from the candidate's own
generator matrix with the same base seed, and QP-ADMM runs with alpha 1.95,
mu 0.5, 1000 iterations at -3 dB. Codewords come from ``seed`` and the
noise from ``seed + 1``, as in the port's other apps.

Two levers beyond the population decode:

* **Capacities from the candidates**: tables are padded to the largest
  exact cascade size over the current candidate set (bucketed), not the
  8 x 14 grid's worst case.
* **Two-stage screening with common random numbers**: every proposal is
  first scored on ``screen_trials`` (default 256) shared channel draws;
  only a generation's best screen survivor within ``screen_margin`` of the
  incumbent's screen FER gets the full ``trials``-sized evaluation that
  decides acceptance (still strictly better on the reference's 1000-trial
  budget, ``optimize_H.cpp:94-101``).

In a world of several processes (``python -m torch.distributed.run
--nproc-per-node N -m ldpc_tpu_torch.apps.optimize_h ...``) whose size
divides the population, each rank builds and decodes its share of every
generation's candidates and the correct counts are summed over the ranks;
every rank runs the same chains from the same seed, and rank 0 alone logs
and writes the matrix and the state.

Run:  python -m ldpc_tpu_torch.apps.optimize_h --generations 10000
      --population 8 [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from ..channel.awgn import gen_random_codewords, noise_scales, transmit
from ..codes.gf2 import gf2_nullspace
from ..codes.io import read_pcm, save_matrix
from ..codes.qc import QCMatrix
from ..config import OptimizeConfig, add_dataclass_args, apply_args
from ..decoders.admm import (TABLES, ADMMStructure, _structure_caps,
                             decode_qp_admm_population)
from ..decoders.base import resolve_device
from ..parallel.distributed import (initialize_distributed, process_count,
                                    process_index)
from ..parallel.mesh import make_trial_mesh
from ..utils.profiling import Timer

__all__ = ["PopulationEvaluator", "main", "optimize"]


def _bucket(x: int, q: int) -> int:
    return -(-x // q) * q


def _caps_for(candidates) -> dict:
    """Capacities = the largest exact cascade size over the candidate set,
    bucketed (as the JAX package buckets them to reuse its compilations),
    so that every candidate's tables stack."""
    caps = [_structure_caps(h) for h in candidates]
    return dict(
        n_var_cap=_bucket(max(c[0] for c in caps), 256),
        n_con_cap=_bucket(max(c[1] for c in caps), 1024),
        k_max_cap=_bucket(max(c[2] for c in caps), 8))


class PopulationEvaluator:
    """FER of P candidate matrices at once, on ``device``.

    With ``sharding`` (a :class:`..parallel.mesh.TrialSharding`), an
    evaluation of P candidates with P divisible by the ranks is split: rank
    ``r`` builds the tables (``gf2_nullspace``, ``from_h``, codewords) of
    its contiguous P/W candidates only and decodes them, and the (P,)
    correct counts are summed over the ranks. Other evaluations run whole
    on every rank, as the JAX package shards only the axes that divide
    over its devices. ``host_s`` accumulates this rank's host seconds in
    those three steps.
    """

    def __init__(self, cfg: OptimizeConfig, n: int,
                 device: torch.device | str = "cuda", sharding=None):
        self.cfg = cfg
        self.n = n
        self.sharding = sharding
        self.device = resolve_device(device if sharding is None
                                     else sharding.device)
        self.host_s = {"gf2_nullspace": Timer(), "from_h": Timer(),
                       "codewords": Timer()}

    @staticmethod
    def _argbest(correct: torch.Tensor):
        """(best index, best count) over the per-candidate correct counts,
        on the device."""
        return torch.argmax(correct), torch.max(correct)

    def _share(self, p_count: int) -> tuple[int, int]:
        """This rank's ``[start, stop)`` of the candidates, and whether the
        evaluation is split."""
        sh = self.sharding
        if sh is None or p_count % sh.num_devices:
            return (0, p_count), False
        return sh.span(p_count), True

    def evaluate(self, candidates: list[np.ndarray], seed: int,
                 trials: int, trial_batch: int = 512,
                 max_iter: int | None = None) -> np.ndarray:
        """FER per candidate dense H. Returns (P,) float."""
        cfg = self.cfg
        mi = int(max_iter or cfg.admm_max_iter)
        p_count = len(candidates)
        fers = np.ones(p_count)
        live = []
        tables_list, cw_list = [], []
        # the caps come from the whole population, so a candidate's padded
        # tables do not depend on how the population is split
        caps = _caps_for(candidates)
        timers = self.host_s
        (lo, hi), split = self._share(p_count)
        for pi in range(lo, hi):
            h = candidates[pi]
            with timers["gf2_nullspace"]:
                g, ok = gf2_nullspace(h)
            if not ok:
                continue                          # singular -> FER 1.0
            live.append(pi)
            with timers["from_h"]:
                s = ADMMStructure.from_h(h, **caps)
            tables_list.append({k: getattr(s, k) for k in TABLES})
            # every candidate draws its codewords with the same seed
            # (the reference re-seeds per FER() call, optimize_H.cpp:21-23)
            with timers["codewords"]:
                cw_list.append(gen_random_codewords(
                    g, trials, torch.Generator().manual_seed(int(seed)),
                    self.device))
        # (2, P): each candidate's correct count and whether it is live,
        # filled in this rank's slots, summed over the ranks when split
        found = torch.zeros((2, p_count), dtype=torch.int64,
                            device=self.device)
        if live:
            found[0, live] = self._correct(tables_list, cw_list, hi - lo,
                                           seed, trials, trial_batch,
                                           mi)[:len(live)]
            found[1, live] = 1
        if split:
            self.sharding.all_sum(found)
        if not bool(found[1].any()):
            return fers
        # the generation's argmin-FER accept, on the device: the first live
        # candidate with the most correct trials (the JAX package maps a
        # pad slot's win back to the last live candidate, the same one)
        best, _ = self._argbest(torch.where(found[1] > 0, found[0], -1))
        self.last_best = int(best)
        counts, alive = found.cpu().numpy()
        fers[alive > 0] = 1.0 - counts[alive > 0] / trials
        return fers

    def _correct(self, tables_list, cw_list, slots: int, seed: int,
                 trials: int, trial_batch: int, max_iter: int
                 ) -> torch.Tensor:
        """(slots,) correct trials of the live candidates' tables, padded
        to ``slots`` candidates, as the JAX package pads to its one
        compiled shape: pad slots replicate the last live structure and
        their counts are discarded by the caller."""
        cfg = self.cfg
        while len(tables_list) < max(slots, 1):
            tables_list.append(tables_list[-1])
            cw_list.append(cw_list[-1])

        stacked = {k: torch.from_numpy(np.stack(
            [t[k] for t in tables_list])).to(self.device) for k in TABLES}
        cw_all = torch.stack(cw_list)                   # (P, T, n)
        inv_var = noise_scales(cfg.snr)[1]

        # Noise is SHARED across candidates (common random numbers): every
        # proposal sees the same channel realizations, so FER differences
        # between candidates are decoder-induced, not noise-draw variance;
        # the reference gets the same implicitly by regenerating noise with
        # the same base seed (optimize_H.cpp:21-23)
        correct = None
        for start in range(0, trials, trial_batch):
            stop = min(start + trial_batch, trials)
            idx = torch.arange(start, stop, dtype=torch.int64,
                               device=self.device)
            cw = cw_all[:, start:stop]
            llrs = inv_var * transmit(cw, cfg.snr, int(seed) + 1, idx)
            res = decode_qp_admm_population(stacked, self.n, llrs,
                                            cfg.admm_alpha, cfg.admm_mu,
                                            max_iter, 1e-5)
            good = res.success & (res.bits == cw).all(dim=-1)
            out = good.sum(dim=1)
            correct = out if correct is None else correct + out
        return correct


class _Chain:
    """One greedy-descent chain (incumbent + rejection streak)."""

    def __init__(self, qc: QCMatrix, fer: float, screen: float,
                 rejects: int = 0):
        self.qc = qc
        self.fer = fer            # incumbent FER at the full trial budget
        self.screen = screen      # incumbent FER at the screen budget
        self.rejects = rejects    # consecutive rejected proposals


def optimize(cfg: OptimizeConfig, log=print,
             device: torch.device | str = "cuda"):
    """Population = ``cfg.population`` independent descent chains (one
    mutation proposal per chain per generation, all scored in one
    population decode). A single serial chain, the reference's process
    (``optimize_H.cpp:88-104``), plateaus in the 1-block-mutation
    neighbourhood. Escapes, per chain:

    * after ``kick_after`` consecutive rejections, proposals widen to
      ``kick_blocks`` simultaneous block mutations (basin hopping);
    * after ``reseed_after`` rejections, the chain restarts, alternating
      between a perturbed copy of the global best and a fresh random
      matrix, while the global best is never lost.

    Two-speed evaluation: chains whose screen FER is far from the global
    best's (> ``polish_margin``) descend greedily on the cheap screen alone
    (their full-budget FER is lazily stale); chains in contention run the
    reference's accept rule: a promoted proposal is confirmed at the full
    ``trials`` budget and accepted only if strictly better. The global best
    is only ever updated from full-budget evaluations.

    The saved matrix (``save_path``) and the resumable state always hold
    the global best across chains. Runs on the card unless ``device`` says
    otherwise.

    In a world of W > 1 processes with the population divisible by W, the
    evaluations are sharded over the ranks (:class:`PopulationEvaluator`);
    every rank runs the same chains, and rank 0 alone logs and writes the
    matrix and the state.
    """
    device = resolve_device(device)
    rng = np.random.default_rng(cfg.seed)
    seed = cfg.seed
    screen = min(cfg.screen_trials, cfg.trials)
    writer = process_index() == 0
    if not writer:
        log = lambda *args, **kwargs: None        # noqa: E731
    sharding = None
    if process_count() > 1 and cfg.population % process_count() == 0:
        sharding = make_trial_mesh(axis_name="pop", device=device)
        log(f"population sharded over {sharding.num_devices} devices",
            file=sys.stderr)
    ev = PopulationEvaluator(cfg, cfg.block_cols * cfg.block_size, device,
                             sharding)

    def eval_full(qcs: list[QCMatrix]) -> np.ndarray:
        return ev.evaluate([q.to_dense() for q in qcs], seed, cfg.trials)

    def eval_screen(qcs: list[QCMatrix]) -> np.ndarray:
        return ev.evaluate([q.to_dense() for q in qcs], seed, screen,
                           max_iter=cfg.screen_iters)

    def fresh_qc() -> QCMatrix:
        return QCMatrix.random(rng, cfg.block_size, cfg.block_rows,
                               cfg.block_cols)

    def perturbed(qc: QCMatrix, k: int = 4) -> QCMatrix:
        for _ in range(k):
            qc = qc.random_mutation(rng)
        return qc

    # ---- state ------------------------------------------------------
    chains: list[_Chain] = []
    init_mat = None          # persisted so before/after analysis can recover
    start_gen = 0
    reseed_flip = 0
    persisted_best: _Chain | None = None

    def _fer_load(v) -> float:
        # checkpoint() serializes non-finite FERs as null (strict JSON has
        # no Infinity token); map back to +inf here
        return float("inf") if v is None else float(v)

    if cfg.state_path and os.path.exists(cfg.state_path):
        with open(cfg.state_path) as f:
            st = json.load(f)
        start_gen = st["generation"]
        init_mat = st.get("initial")
        reseed_flip = st.get("reseed_flip", 0)
        if "chains" in st:
            for ch in st["chains"]:
                chains.append(_Chain(
                    QCMatrix(cfg.block_size, np.array(ch["present"], bool),
                             np.array(ch["shifts"], np.int64)),
                    _fer_load(ch["fer"]), ch["screen"], ch["rejects"]))
            # The persisted global best (top-level present/shifts/fer) is
            # authoritative: chains that reseeded or took screen-greedy
            # accepts carry fer=inf, so min-over-chains alone could
            # re-establish a worse "best" and the next checkpoint() would
            # overwrite the saved matrix with a worse one.
            if "present" in st and np.isfinite(_fer_load(st.get("fer"))):
                persisted_best = _Chain(
                    QCMatrix(cfg.block_size, np.array(st["present"], bool),
                             np.array(st["shifts"], np.int64)),
                    _fer_load(st["fer"]), float("inf"))
        else:   # legacy single-incumbent state: seed chain 0 from it
            qc0 = QCMatrix(cfg.block_size, np.array(st["present"], bool),
                           np.array(st["shifts"], np.int64))
            chains.append(_Chain(qc0, _fer_load(st["fer"]),
                                 float(eval_screen([qc0])[0])))
        if chains:
            # re-baseline screens under the current (screen_iters,
            # screen_trials) config: stored values may predate it
            for c, s in zip(chains, eval_screen([c.qc for c in chains])):
                c.screen = float(s)
        log(f"resumed from {cfg.state_path} @ generation {start_gen}, "
            f"best FER={min(c.fer for c in chains):.5f} "
            f"({len(chains)} chains)", file=sys.stderr)
    elif cfg.init_matrix:
        qc0 = QCMatrix.from_dense(read_pcm(cfg.init_matrix), cfg.block_size)
        chains.append(_Chain(qc0, float(eval_full([qc0])[0]),
                             float(eval_screen([qc0])[0])))
    while len(chains) < cfg.population:      # top up with random inits
        qcs = [fresh_qc() for _ in range(cfg.population - len(chains))]
        scrs = eval_screen(qcs)
        for q, s in zip(qcs, scrs):
            chains.append(_Chain(q, float("inf"), float(s)))
    chains = chains[:cfg.population]
    best = min(chains, key=lambda c: c.fer)
    if persisted_best is not None and persisted_best.fer < best.fer:
        # seed the global best from the persisted top-level record; only a
        # full-budget evaluation that beats this value may replace it
        persisted_best.screen = float(eval_screen([persisted_best.qc])[0])
        best = persisted_best
    if not np.isfinite(best.fer):        # fresh start: establish the best
        cand = min(chains, key=lambda c: c.screen)
        cand.fer = float(eval_full([cand.qc])[0])
        best = cand
    best_qc, best_fer, best_screen = best.qc, best.fer, best.screen
    if init_mat is None:
        init_mat = {"present": best_qc.present.tolist(),
                    "shifts": best_qc.shifts.tolist()}
    log("initial chain screen FERs: "
        + " ".join(f"{c.screen:.3f}" for c in chains))

    def _fer_dump(v: float):
        # strict JSON: serialize non-finite FERs as null (round-trips with
        # _fer_load above; json.dump would emit the non-standard token
        # 'Infinity' that jq and other consumers reject)
        return v if np.isfinite(v) else None

    def checkpoint(gen_done: int):
        if not writer:
            return
        save_matrix(best_qc.to_dense(), cfg.save_path)
        if cfg.state_path:
            with open(cfg.state_path, "w") as f:
                json.dump({
                    "present": best_qc.present.tolist(),
                    "shifts": best_qc.shifts.tolist(),
                    "fer": _fer_dump(best_fer),
                    "generation": gen_done,
                    "reseed_flip": reseed_flip,
                    "initial": init_mat,
                    "chains": [{"present": c.qc.present.tolist(),
                                "shifts": c.qc.shifts.tolist(),
                                "fer": _fer_dump(c.fer), "screen": c.screen,
                                "rejects": c.rejects} for c in chains]}, f)

    # ceil: the proposal budget is cfg.generations total proposals (the
    # reference's 10,000 serial proposals, optimize_H.cpp:133); a floor
    # division would silently shrink it by up to population-1
    rounds = max(1, -(-(cfg.generations - start_gen) // cfg.population))
    n_full = 0

    def full_of(qcs: list[QCMatrix]) -> list[float]:
        """Full-budget FERs, padded by repeats to the next power of two
        (the JAX package's handful of compiled shapes; the common case is
        a single promoted proposal, which padding to the whole population
        would make 8x the work)."""
        nonlocal n_full
        n_full += len(qcs)
        p = 1
        while p < len(qcs):
            p *= 2
        idx = (list(range(len(qcs))) * p)[:p]
        vals = eval_full([qcs[i] for i in idx])
        return [float(vals[idx.index(i)]) for i in range(len(qcs))]

    for gen in range(rounds):
        t0 = time.perf_counter()
        proposals = []
        for c in chains:
            k = cfg.kick_blocks if c.rejects >= cfg.kick_after else 1
            proposals.append(perturbed(c.qc, k) if k > 1
                             else c.qc.random_mutation(rng))
        fers_s = eval_screen(proposals)

        polish = [i for i, c in enumerate(chains)
                  if c.screen <= best_screen + cfg.polish_margin]
        # lazily materialize stale incumbent full-FERs of polish chains
        stale = [i for i in polish if not np.isfinite(chains[i].fer)]
        if stale:
            for i, v in zip(stale, full_of([chains[i].qc for i in stale])):
                chains[i].fer = v
                if v < best_fer:
                    best_qc, best_fer = chains[i].qc, v
                    best_screen = chains[i].screen
                    log(f"new global best FER={best_fer:.5f} "
                        f"(chain {i} incumbent)")
        promote = [i for i in polish
                   if fers_s[i] <= chains[i].screen + cfg.screen_margin]
        fers_f = dict(zip(promote, full_of([proposals[i] for i in promote]))
                      ) if promote else {}
        accepts = 0
        for i, c in enumerate(chains):
            if i in fers_f:                     # polish: confirmed accept
                ok = fers_f[i] < c.fer
            elif i in polish:
                ok = False
            else:                               # explore: screen-greedy
                ok = fers_s[i] < c.screen
            if ok:
                c.qc = proposals[i]
                c.fer = fers_f.get(i, float("inf"))
                c.screen, c.rejects = float(fers_s[i]), 0
                accepts += 1
                if c.fer < best_fer:
                    best_qc, best_fer = c.qc, c.fer
                    best_screen = c.screen
                    log(f"new global best FER={best_fer:.5f}")
            else:
                c.rejects += 1
                if c.rejects >= cfg.reseed_after:
                    nq = (perturbed(best_qc) if reseed_flip % 2 == 0
                          else fresh_qc())
                    reseed_flip += 1
                    c.qc = nq
                    c.fer = float("inf")
                    c.screen = float(eval_screen([nq])[0])
                    c.rejects = 0
                    log(f"chain {i} reseeded "
                        f"({'best+kick' if reseed_flip % 2 else 'random'}),"
                        f" screen={c.screen:.5f}")
        gen_done = start_gen + (gen + 1) * cfg.population
        log(f"\tgeneration {gen_done - cfg.population}: "
            f"screens best={float(np.min(fers_s)):.5f}, "
            f"{len(polish)} polishing, {len(promote)} promoted, "
            f"{accepts} accepted, best FER={best_fer:.5f} "
            f"({time.perf_counter() - t0:.2f}s, {n_full} full evals)")
        if accepts or gen % 25 == 24:
            checkpoint(gen_done)
    # persist the proposal count even when the tail accepts nothing, so a
    # resumed run continues the budget instead of redoing it
    checkpoint(start_gen + rounds * cfg.population)
    final = float(ev.evaluate([best_qc.to_dense()], seed,
                              cfg.final_trials)[0])
    log(f"final FER ({cfg.final_trials} trials): {final:.5f}")
    return best_qc, final


def main(argv=None):
    cfg = OptimizeConfig()
    p = argparse.ArgumentParser(description=__doc__)
    add_dataclass_args(p, cfg)
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda)")
    args = p.parse_args(argv)
    apply_args(cfg, args)
    initialize_distributed(device=args.device)
    return optimize(cfg, device=args.device)


if __name__ == "__main__":
    main()
