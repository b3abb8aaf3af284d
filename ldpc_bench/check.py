"""Whether what the timed path produced is correct: the sampled blocks of
the window against the plain reference (``reference/``).

For each sampled block the reference works out again, on its own, the
generator matrix and the codewords (from the coefficient draw the run made
from its seed), then, batch by batch at the timed batch size and in trial
order, the channel's LLRs of every trial, the decode, and the block's eight
counters. Each reference lane is compared with the program's trial of the
same index, whichever slot or batch the program's runner decoded it in (a
streamed runner refills slots in the order they finish; ``record.py``
keeps the program's rows by trial). The numbers compared, each against its
limit in the cell's file:

* ``llr_gap``: the largest |LLR| gap between what the decoder was given and
  the reference's channel (the channel layer);
* the decoder reference's per-lane disagreements, each as a share of the
  lanes checked (the decoder layer; ``reference/<decoder>.py``);
* ``counters_gap``: the largest gap of one of the eight counters, summed
  over the sampled blocks, between the program's run_experiment results and
  the reference's, per trial checked (the decoder's iterations and drops in
  sum, and the classification of the reference's decode);
* ``classify_gap``: the same gap between the program's counters and the
  reference's classification of the program's own per-lane outputs: exact
  (the classification layer alone).

A cell's file names the numbers it compares, each with its limit.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .reference import channel, classify, gf2


class Block:
    """One block of the window: its index, noise seed, the program's eight
    counters, and, when sampled, ``trials``: what the decoder was given and
    gave back, {"llrs", "bits", "success", "iterations", "dropped"}, each
    with one row per trial in trial order (``dropped`` may be None)."""

    def __init__(self, index: int, seed: int, counters, trials=None):
        self.index = index
        self.seed = seed
        self.counters = [int(v) for v in counters]
        self.trials = trials


def draw_coefficients(seed: int, trials: int, k: int, device):
    """The run's codeword coefficients: 0/1 float32 (trials, k) drawn on
    ``device`` by a generator seeded from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed % 2**63)
    return torch.randint(0, 2, (trials, k), generator=gen, device=device,
                         dtype=torch.float32)


def judge(ref, tables, h: np.ndarray, cw_seed: int, snr: float,
          blocks: list, batch: int, device) -> dict:
    """The numbers compared over ``blocks``, each with the rows of all its
    trials. The reference decodes them in batches of ``batch`` in trial
    order. ``ref`` is the decoder's reference module and ``tables`` its
    ``prepare``."""
    g = gf2.nullspace(h)
    trials = blocks[0].trials["llrs"].shape[0]
    cw = gf2.codewords(draw_coefficients(cw_seed, trials, g.shape[0],
                                         device), g)
    h_dev = torch.as_tensor(h, device=device)
    llr_gap, lanes = 0.0, 0
    differ = {}
    ctr = torch.zeros(len(classify.COUNTERS), dtype=torch.int64,
                      device=device)
    prog = torch.zeros_like(ctr)
    own = torch.zeros_like(ctr)
    for block in blocks:
        prog += torch.tensor(block.counters, device=device)
        for start in range(0, trials, batch):
            stop = min(start + batch, trials)
            idx = torch.arange(start, stop, device=device)
            sent = cw[start:stop]
            y = channel.received(sent, snr, block.seed, idx)
            llr_r = channel.llrs(y, snr)
            out_r = ref.decode(tables, llr_r)
            out_p = {k: (v[start:stop].to(device) if v is not None else None)
                     for k, v in block.trials.items()}
            llr_p = out_p.pop("llrs")
            llr_gap = max(llr_gap, (llr_p - llr_r).abs().max().item())
            for name, d in ref.lanes_differ(out_p, out_r).items():
                differ[name] = differ.get(name, 0) + int(d.sum())
            lanes += llr_r.shape[0]
            ctr += classify.counters(h_dev, out_r, sent, y)
            own += classify.counters(h_dev, out_p, sent, y)
    out = {"llr_gap": float(llr_gap)}
    out.update({name: v / max(lanes, 1) for name, v in differ.items()})
    out["counters_gap"] = (prog - ctr).abs().max().item() / max(lanes, 1)
    out["classify_gap"] = (prog - own).abs().max().item() / max(lanes, 1)
    return out


def control_blocks(ref, tables, h: np.ndarray, cw_seed: int, snr: float,
                   seeds: list, n_batches: int, batch: int,
                   device) -> list:
    """Blocks as the control would give them: the reference one precision
    step lower (channel and decoder) put in the program's place."""
    g = gf2.nullspace(h)
    cw = gf2.codewords(draw_coefficients(cw_seed, n_batches * batch,
                                         g.shape[0], device), g)
    h_dev = torch.as_tensor(h, device=device)
    out = []
    for k, seed in enumerate(seeds):
        ctr = torch.zeros(len(classify.COUNTERS), dtype=torch.int64,
                          device=device)
        parts = []
        for i in range(n_batches):
            idx = torch.arange(i * batch, (i + 1) * batch, device=device)
            sent = cw[i * batch:(i + 1) * batch]
            y = channel.received(sent, snr, seed, idx, control=True)
            llr = channel.llrs(y, snr)
            res = ref.decode(tables, llr, control=True)
            parts.append({"llrs": llr, **res})
            ctr += classify.counters(h_dev, res, sent, y)
        trials = {key: None if v is None else
                  torch.cat([p[key] for p in parts])
                  for key, v in parts[0].items()}
        out.append(Block(k, seed, ctr.tolist(), trials))
    return out


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) over the numbers that
    ``limits`` names: correct when each was computed and stays within its
    limit."""
    shown = {}
    ok = bool(numbers) and bool(limits)
    for name, limit in limits.items():
        value = numbers.get(name)
        shown[name] = {"value": value, "limit": limit}
        if value is None or not math.isfinite(value) or value > limit:
            ok = False
    return ok, shown
