"""Monte-Carlo FER experiment harness on one device (counterpart of
``ldpc_tpu/harness/experiment.py``).

A batch step is split in two so that each half can be checked on its own:

* :func:`channel_step`: codewords and trial indices -> received symbols y,
  with noise keyed by ``(seed, trial index)``, so results do not depend on
  batch size or device;
* :func:`count_step`: y -> LLRs -> decode -> the eight counters of one batch.

Classification as the reference's ``exp`` (``experiment.h:109-118``):
``correct`` = certificate && valid codeword && equals the transmitted word;
``pseudo`` = certificate && valid codeword && differs; anything else is a
frame error. The Hamming counters count channel hard-decision errors
(y <= 0 for bit 0, y > 0 for bit 1), split by correct / wrong.

:func:`run_experiment` uploads the codewords once, loops over batches on the
device, keeps int64 counters on the device, and reads them back once at the
end. Warm-up (the kernel build and the first launch of each batch shape)
runs before the timed window.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ..channel.awgn import llr_variance, transmit
from ..codes.gf2 import is_codeword
from ..decoders.base import Decoder, resolve_device

__all__ = ["COUNTERS", "ExperimentResult", "channel_step", "count_step",
           "make_experiment_step", "run_experiment"]

# order of the counters in the (8,) int64 vectors the steps return
COUNTERS = ("total", "correct", "pseudo", "sum_hamming", "sum_hamming_ok",
            "sum_hamming_wrong", "sum_iterations", "sum_dropped")


@dataclass
class ExperimentResult:
    """Aggregated counters; derived metrics mirror ``experiment.h:49-68``."""

    total: int = 0
    correct: int = 0
    pseudo: int = 0
    sum_hamming: int = 0
    sum_hamming_ok: int = 0
    sum_hamming_wrong: int = 0
    time_sec: float = 0.0          # wall-clock decode time (whole batches)
    sum_iterations: int = 0
    sum_dropped: int = 0

    @property
    def fer(self) -> float:
        return (self.total - self.correct) / max(1, self.total)

    @property
    def avg_time(self) -> float:
        """Seconds per codeword (wall-clock over the whole device)."""
        return self.time_sec / max(1, self.total)

    @property
    def throughput(self) -> float:
        if self.time_sec <= 0:
            return float("inf")
        return self.total / self.time_sec

    @property
    def mean_hamming(self) -> float:
        return self.sum_hamming / max(1, self.total)

    @property
    def mean_hamming_ok(self) -> float:
        return self.sum_hamming_ok / max(1, self.correct)

    @property
    def mean_hamming_wrong(self) -> float:
        return self.sum_hamming_wrong / max(1, self.total - self.correct)


def channel_step(codewords: torch.Tensor, trial_idx: torch.Tensor,
                 snr: float, seed: int) -> torch.Tensor:
    """Received symbols y (B, n) float32 for codewords (B, n) uint8."""
    return transmit(codewords, snr, seed, trial_idx)


def count_step(decoder: Decoder, h: torch.Tensor, codewords: torch.Tensor,
               y: torch.Tensor, snr: float) -> torch.Tensor:
    """Decode y and classify each frame; returns the batch's counters as an
    (8,) int64 tensor in :data:`COUNTERS` order, on y's device."""
    inv_var = 2.0 / llr_variance(snr)
    res = decoder.decode_batch(inv_var * y)
    valid = res.success & is_codeword(h, res.bits)
    match = (res.bits == codewords).all(dim=-1)
    correct = valid & match
    pseudo = valid & ~match
    hd = torch.where(codewords == 0, y <= 0, y > 0).sum(dim=-1)
    zero = torch.zeros_like(hd)
    i64 = torch.int64
    return torch.stack([
        torch.full((), codewords.shape[0], dtype=i64, device=y.device),
        correct.sum(dtype=i64),
        pseudo.sum(dtype=i64),
        hd.sum(dtype=i64),
        torch.where(correct, hd, zero).sum(dtype=i64),
        torch.where(correct, zero, hd).sum(dtype=i64),
        res.iterations.sum(dtype=i64),
        (res.dropped.sum(dtype=i64) if res.dropped is not None
         else torch.zeros((), dtype=i64, device=y.device)),
    ])


def make_experiment_step(decoder: Decoder, h, snr: float, seed: int,
                         device: torch.device | str):
    """step(codewords (B, n) uint8, trial_idx (B,) int64) -> (8,) int64
    counters, everything on ``device``."""
    h_dev = torch.as_tensor(np.asarray(h, np.uint8), device=device)

    def step(codewords, trial_idx):
        y = channel_step(codewords, trial_idx, snr, seed)
        return count_step(decoder, h_dev, codewords, y, snr)

    return step


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_experiment(decoder: Decoder, h, codewords, snr: float, seed: int,
                   batch_size: int = 1024, device: torch.device | str = "cuda",
                   warmup: bool = True) -> ExperimentResult:
    """FER estimation over all ``codewords`` (T, n) at one SNR on one device.

    Trials run in batches of ``batch_size`` with a last, smaller batch for
    the remainder; trial ``t``'s noise is keyed by ``(seed, t)``.
    ``time_sec`` covers the batch loop only, from a synchronised start to a
    synchronised end.
    """
    device = resolve_device(device)
    cw = torch.as_tensor(codewords, dtype=torch.uint8).to(device)
    t_total = cw.shape[0]
    step = make_experiment_step(decoder, h, snr, seed, device)
    bounds = [(s, min(s + batch_size, t_total))
              for s in range(0, t_total, batch_size)]

    def trials(start, stop):
        return torch.arange(start, stop, dtype=torch.int64, device=device)

    if warmup:  # build the kernel and launch every batch shape once
        for bsz in sorted({stop - start for start, stop in bounds}):
            step(cw[:bsz], trials(0, bsz))
    acc = torch.zeros(len(COUNTERS), dtype=torch.int64, device=device)
    _sync(device)
    t_start = time.perf_counter()
    for start, stop in bounds:
        acc += step(cw[start:stop], trials(start, stop))
    _sync(device)
    elapsed = time.perf_counter() - t_start
    result = ExperimentResult(**dict(zip(COUNTERS, acc.tolist())))
    result.time_sec = elapsed
    return result
