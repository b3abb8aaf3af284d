"""Monte-Carlo FER experiment harness on one device or over the ranks of a
``torch.distributed`` world (counterpart of
``ldpc_tpu/harness/experiment.py``).

A batch step (:func:`make_experiment_step`) is one channel call
(:func:`..channel.awgn.channel`: codewords and trial indices -> LLRs and the
channel's hard-decision count, with noise keyed by ``(seed, trial index)``,
so results do not depend on batch size, batch order or device; on the card
one launch of the channel kernel, on the CPU plain ops), then the decode and
the eight counters of the batch. :func:`channel_step` (-> received symbols
y) and :func:`count_step` (y -> LLRs -> the same decode and counters) split
that step in two for tests that check each half.

Classification as the reference's ``exp`` (``experiment.h:109-118``):
``correct`` = certificate && valid codeword && equals the transmitted word;
``pseudo`` = certificate && valid codeword && differs; anything else is a
frame error. The Hamming counters count channel hard-decision errors
(y <= 0 for bit 0, y > 0 for bit 1), split by correct / wrong.

Three runners, each keeping int64 counters on the device and reading them
back once at the end; warm-up (kernel builds, first launches) runs before
the timed window:

* :func:`run_experiment`, batched: fixed batches, a last smaller one for
  the remainder. With ``streaming="auto"`` it hands decoders that have the
  streaming protocol to
* :func:`run_streaming_experiment`: the decoder advances in chunks; after
  each chunk the finished lanes are classified into the counters and their
  slots refilled with the next trials, so a batch does not wait on its
  slowest lane (the reference's work queue, ``experiment.h:86-93``);
* :func:`run_multi_snr_experiment`: lanes at several SNRs share each batch
  (a per-lane noise scale), counters reduced per SNR.

Each runner takes ``sharding`` (a :class:`..parallel.mesh.TrialSharding`):
the ranks split whole units of work, each runs its share on its own device
and the counters are summed over the ranks after the loop. The batched
runners cut the batch list as they do alone and rank ``r`` decodes batches
``r, r + W, ...``, so every decode a rank does is one the unsharded run
does, and the counters equal the unsharded run's for every decoder (ALP's
and AGC-ALP's lanes are coupled by their solvers' batch-wide stop tests,
so the lanes of one batch are not split). ``batch_size`` is each rank's
batch. The clock starts after a barrier and stops after the counters' sum,
and every rank reports the slowest rank's window.
"""
from __future__ import annotations

import time
from collections import Counter
from dataclasses import dataclass, fields

import numpy as np
import torch

from ..channel.awgn import (channel, hard_errors, noise_scales, snr_table,
                            transmit)
from ..codes.gf2 import is_codeword
from ..decoders.base import DecodeResult, Decoder, resolve_device
from ..utils.profiling import span, spanned

__all__ = ["COUNTERS", "COUNTS", "ExperimentResult", "channel_step",
           "count_step", "make_experiment_step", "make_multi_snr_step",
           "run_experiment", "run_multi_snr_experiment",
           "run_streaming_experiment"]

# order of the counters in the (8,) int64 vectors the steps return
COUNTERS = ("total", "correct", "pseudo", "sum_hamming", "sum_hamming_ok",
            "sum_hamming_wrong", "sum_iterations", "sum_dropped")

# the runners' work and host reads, summed over every run of the process:
# ``batches`` handed to ``decode_batch`` (warm-up included), and
# ``reads.result`` (the counters' read at a run's end), ``reads.poll`` (the
# streamed runner's active-lane count) and ``reads.refill`` (the streamed
# refill's ``nonzero``)
COUNTS: Counter = Counter()


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

    def merge(self, other: "ExperimentResult") -> None:
        """Add ``other``'s counters and time to this one."""
        for f in fields(self):
            setattr(self, f.name, getattr(self, f.name) + getattr(other,
                                                                   f.name))


def channel_step(codewords: torch.Tensor, trial_idx: torch.Tensor,
                 snr: float, seed: int) -> torch.Tensor:
    """Received symbols y (B, n) float32 for codewords (B, n) uint8."""
    return transmit(codewords, snr, seed, trial_idx)


def _lane_counters(h: torch.Tensor, res: DecodeResult,
                   codewords: torch.Tensor, hd: torch.Tensor) -> torch.Tensor:
    """Each lane's contribution to the counters: (8, B) int64 in
    :data:`COUNTERS` order."""
    valid = res.success & is_codeword(h, res.bits)
    match = (res.bits == codewords).all(dim=-1)
    correct = valid & match
    zero = torch.zeros_like(hd)
    dropped = res.dropped if res.dropped is not None else zero
    return torch.stack([x.to(torch.int64) for x in (
        torch.ones_like(hd), correct, valid & ~match, hd,
        torch.where(correct, hd, zero), torch.where(correct, zero, hd),
        res.iterations, dropped)])


def _decode_count(decoder: Decoder, h: torch.Tensor,
                  codewords: torch.Tensor, llrs: torch.Tensor,
                  hd: torch.Tensor) -> torch.Tensor:
    """Decode ``llrs`` and classify each frame: (8, B) int64 lane
    counters."""
    COUNTS["batches"] += 1
    res = decoder.decode_batch(llrs)
    with span("harness.count"):
        return _lane_counters(h, res, codewords, hd)


def count_step(decoder: Decoder, h: torch.Tensor, codewords: torch.Tensor,
               y: torch.Tensor, snr: float) -> torch.Tensor:
    """Decode y and classify each frame; returns the batch's counters as an
    (8,) int64 tensor in :data:`COUNTERS` order, on y's device."""
    with span("harness.channel"):
        llrs = noise_scales(snr)[1] * y
        hd = hard_errors(codewords, y)
    return _decode_count(decoder, h, codewords, llrs, hd).sum(dim=1)


def make_experiment_step(decoder: Decoder, h, snr: float, seed: int,
                         device: torch.device | str):
    """step(codewords (B, n) uint8, trial_idx (B,) int64) -> (8,) int64
    counters, everything on ``device``."""
    h_dev = torch.as_tensor(np.asarray(h, np.uint8), device=device)
    sigma, scale = noise_scales(snr)

    def step(codewords, trial_idx):
        with span("harness.channel"):
            _, llrs, hd = channel(codewords, trial_idx, seed, sigma, scale)
        return _decode_count(decoder, h_dev, codewords, llrs, hd).sum(dim=1)

    return step


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _result(counters: torch.Tensor, time_sec: float) -> ExperimentResult:
    with span("harness.sync"):
        values = counters.tolist()
    COUNTS["reads.result"] += 1
    return ExperimentResult(**dict(zip(COUNTERS, values)), time_sec=time_sec)


@spanned("harness.sync")
def _start_clock(device: torch.device, sharding) -> float:
    """Synchronised start: this device idle and, under a sharding, every
    rank at the barrier."""
    _sync(device)
    if sharding is not None:
        sharding.barrier()
    return time.perf_counter()


@spanned("harness.sync")
def _stop_clock(counters: torch.Tensor, device: torch.device, sharding,
                t_start: float) -> float:
    """Sums ``counters`` over the ranks in place and returns the seconds
    since ``t_start``: the slowest rank's under a sharding."""
    if sharding is not None:
        sharding.all_sum(counters)
    _sync(device)
    elapsed = time.perf_counter() - t_start
    return elapsed if sharding is None else sharding.all_max(elapsed)


def run_experiment(decoder: Decoder, h, codewords, snr: float, seed: int,
                   batch_size: int = 1024, device: torch.device | str = "cuda",
                   warmup: bool = True, streaming: str | bool = "auto",
                   sharding=None) -> ExperimentResult:
    """FER estimation over all ``codewords`` (T, n) at one SNR on one
    device, or on each rank of ``sharding`` (which then gives the device).

    Trials run in batches of ``batch_size`` with a last, smaller batch for
    the remainder; trial ``t``'s noise is keyed by ``(seed, t)``.
    ``time_sec`` covers the batch loop only, from a synchronised start to a
    synchronised end.

    ``streaming``: True runs :func:`run_streaming_experiment`; ``"auto"``
    does so when there is no sharding, the decoder has the streaming
    protocol (``stream_init``), does not set ``prefer_streaming = False``
    and there are at least two batches of trials, as the JAX package
    decides (``experiment.py:328``).
    """
    if streaming == "auto":
        streaming = (sharding is None and hasattr(decoder, "stream_init")
                     and getattr(decoder, "prefer_streaming", True)
                     and len(codewords) >= 2 * batch_size)
    if streaming:
        return run_streaming_experiment(decoder, h, codewords, snr, seed,
                                        batch_size=batch_size, device=device,
                                        warmup=warmup, sharding=sharding)
    return _run_batches(decoder, h, codewords, snr, seed, batch_size, device,
                        warmup, sharding)


@spanned("harness.block")
def _run_batches(decoder, h, codewords, snr, seed, batch_size, device,
                 warmup, sharding) -> ExperimentResult:
    """:func:`run_experiment`'s loop over batches."""
    device = resolve_device(device if sharding is None else sharding.device)
    cw = torch.as_tensor(codewords, dtype=torch.uint8).to(device)
    t_total = cw.shape[0]
    step = make_experiment_step(decoder, h, snr, seed, device)
    bounds = [(s, min(s + batch_size, t_total))
              for s in range(0, t_total, batch_size)]
    if sharding is not None:
        bounds = sharding.strided(bounds)

    def trials(start, stop):
        return torch.arange(start, stop, dtype=torch.int64, device=device)

    if warmup:  # build the kernel and launch every batch shape once
        for bsz in sorted({stop - start for start, stop in bounds}):
            step(cw[:bsz], trials(0, bsz))
    acc = torch.zeros(len(COUNTERS), dtype=torch.int64, device=device)
    t_start = _start_clock(device, sharding)
    for start, stop in bounds:
        acc += step(cw[start:stop], trials(start, stop))
    return _result(acc, _stop_clock(acc, device, sharding, t_start))


@spanned("harness.block")
def run_streaming_experiment(decoder, h, codewords, snr: float, seed: int,
                             batch_size: int = 256, fetch_every: int = 4,
                             device: torch.device | str = "cuda",
                             warmup: bool = True,
                             sharding=None) -> ExperimentResult:
    """FER estimation with converged-lane draining.

    The decoder's streaming protocol (``stream_init`` / ``stream_chunk`` /
    ``stream_done`` / ``stream_finish``) advances ``batch_size`` lanes a
    chunk at a time. After each chunk the finished lanes are classified
    into the device counters and their slots take the next trials in the
    JAX package's order (trial ``consumed + cumsum(fin) - 1``), the
    channel made on the device from the codeword table with the same
    ``(seed, trial)`` noise as the batched runner, so each trial decodes as
    it does there. The refill builds ``stream_init`` of the finished lanes'
    rows only (a decoder's state is per lane) and copies it into their
    slots of every state entry, in place, so decoders that update buffers
    in place see every finished lane's slice overwritten. Lanes past the
    last trial start frozen and stay frozen.

    The host reads one scalar, the active-lane count, every
    ``fetch_every`` chunks, and doubles ``fetch_every`` (up to 128) while
    the polls come back within 0.25 s; chunks after the last lane finished
    do nothing.

    Under ``sharding`` each of the W ranks streams its own contiguous range
    of trials on ``batch_size // W`` lanes (``batch_size`` must divide by
    W, as in the JAX package). The counters are exact for decoders whose
    lanes are independent (BP, QP-ADMM, Full LP); ALP's and AGC-ALP's
    chunks stop on the largest error over the lanes, which the split
    regroups, so their lanes may decode otherwise than in one stream.
    """
    device = resolve_device(device if sharding is None else sharding.device)
    cw = torch.as_tensor(codewords, dtype=torch.uint8).to(device)
    first, t_stop = 0, cw.shape[0]
    bsz = int(batch_size)
    if sharding is not None:
        if bsz % sharding.num_devices:
            raise ValueError(f"batch_size {bsz} does not divide over "
                             f"{sharding.num_devices} ranks")
        bsz //= sharding.num_devices
        first, t_stop = sharding.span(t_stop)
    t_total = t_stop - first
    h_dev = torch.as_tensor(np.asarray(h, np.uint8), device=device)
    sigma, scale = noise_scales(snr)

    @spanned("harness.channel")
    def make_lane(idx):
        """(B,) stream positions -> (llrs, codewords, channel Hamming) of
        trials ``first + idx``."""
        safe = idx.clamp(0, max(t_total - 1, 0)) + first
        cwb = cw.index_select(0, safe)
        _, llrs, hd = channel(cwb, safe, seed, sigma, scale)
        return llrs, cwb, hd

    def start():
        idx = torch.arange(bsz, dtype=torch.int64, device=device)
        llrs, cwb, hd = make_lane(idx)
        st = decoder.stream_init(llrs)
        active = idx < t_total
        st["done"] = st["done"] | ~active
        consumed = torch.full((), min(bsz, t_total), dtype=torch.int64,
                              device=device)
        counters = torch.zeros(len(COUNTERS), dtype=torch.int64,
                               device=device)
        return st, idx, cwb, hd, active, consumed, counters

    def step(carry):
        st, idx, cwb, hd, active, consumed, counters = carry
        st = decoder.stream_chunk(st)
        with span("harness.count"):
            fin = decoder.stream_done(st) & active
            lanes = _lane_counters(h_dev, decoder.stream_finish(st), cwb, hd)
            counters = counters + (lanes * fin).sum(dim=1)
        # refill the finished slots with the next trials of the stream
        with span("harness.refill"):
            rank = fin.to(torch.int64).cumsum(0)
            new_idx = consumed + rank - 1
            idx = torch.where(fin, new_idx, idx)
            active = torch.where(fin, new_idx < t_total, active)
            consumed = consumed + rank[-1]
            llrs, cwb_new, hd_new = make_lane(idx)
            lanes = fin.nonzero().squeeze(1)      # one host read per chunk
            COUNTS["reads.refill"] += 1
            if lanes.numel():
                fresh = decoder.stream_init(llrs.index_select(0, lanes))
                for key, val in fresh.items():
                    st[key].index_copy_(0, lanes, val)
            cwb = torch.where(fin[:, None], cwb_new, cwb)
            hd = torch.where(fin, hd_new, hd)
            st["done"] = st["done"] | ~active  # inactive lanes stay frozen
        return (st, idx, cwb, hd, active, consumed, counters), active.sum()

    if warmup:
        step(start())
    t_start = _start_clock(device, sharding)
    carry = start()
    t_poll = time.perf_counter()
    while t_total:
        for _ in range(fetch_every):
            carry, n_active = step(carry)
        with span("harness.sync"):
            n_active = int(n_active)
        COUNTS["reads.poll"] += 1
        if n_active == 0:
            break
        now = time.perf_counter()
        if now - t_poll < 0.25 and fetch_every < 128:
            fetch_every *= 2
        t_poll = now
    counters = carry[-1]
    return _result(counters, _stop_clock(counters, device, sharding, t_start))


def make_multi_snr_step(decoder: Decoder, h, snrs, seed: int,
                        device: torch.device | str):
    """One batch with a per-lane SNR: step(codewords (B, n) uint8,
    trial_idx (B,) int64, snr_id (B,) int64) -> (8, S) int64 counters per
    SNR. Lanes at different SNRs share one decode (decoders see only
    LLRs); each lane's noise scale and LLR factor come from one per-SNR
    table (:func:`..channel.awgn.snr_table`), so a lane decodes exactly as
    in a single-SNR run."""
    h_dev = torch.as_tensor(np.asarray(h, np.uint8), device=device)
    sigmas, inv_vars = snr_table(snrs, device)
    s_count = len(sigmas)

    def step(codewords, trial_idx, snr_id):
        with span("harness.channel"):
            _, llrs, hd = channel(codewords, trial_idx, seed,
                                  sigmas[snr_id], inv_vars[snr_id])
        lanes = _decode_count(decoder, h_dev, codewords, llrs, hd)
        with span("harness.count"):
            out = torch.zeros((len(COUNTERS), s_count), dtype=torch.int64,
                              device=lanes.device)
            return out.index_add_(1, snr_id, lanes)

    return step


@spanned("harness.block")
def run_multi_snr_experiment(decoder: Decoder, h, codewords, snrs,
                             seed: int, batch_size: int = 2048,
                             device: torch.device | str = "cuda",
                             warmup: bool = True,
                             sharding=None) -> list[ExperimentResult]:
    """The whole SNR sweep as one trial stream: every (SNR, trial) pair is a
    lane, interleaved so each batch mixes the SNRs (trial t at SNR s is lane
    ``t * S + s``), decoded in batches of ``batch_size`` (under
    ``sharding``, rank ``r`` decodes batches ``r, r + W, ...``). Returns one
    result per SNR, in ``snrs`` order, each timed with an equal share of the
    elapsed time (as the JAX package apportions it)."""
    device = resolve_device(device if sharding is None else sharding.device)
    cw = torch.as_tensor(codewords, dtype=torch.uint8).to(device)
    t_total = cw.shape[0]
    s_count = len(snrs)
    step = make_multi_snr_step(decoder, h, snrs, seed, device)
    snr_ids = torch.arange(s_count, device=device).repeat(t_total)
    trial_idx = torch.arange(t_total, device=device).repeat_interleave(
        s_count)
    total = s_count * t_total
    bounds = [(s, min(s + batch_size, total))
              for s in range(0, total, batch_size)]
    if sharding is not None:
        bounds = sharding.strided(bounds)

    def run_batch(start, stop):
        idx = trial_idx[start:stop]
        return step(cw.index_select(0, idx), idx, snr_ids[start:stop])

    if warmup:  # build the kernel and launch every batch shape once
        for bsz in sorted({stop - start for start, stop in bounds}):
            run_batch(0, bsz)
    acc = torch.zeros((len(COUNTERS), s_count), dtype=torch.int64,
                      device=device)
    t_start = _start_clock(device, sharding)
    for start, stop in bounds:
        acc += run_batch(start, stop)
    elapsed = _stop_clock(acc, device, sharding, t_start)
    return [_result(acc[:, si], elapsed / s_count) for si in range(s_count)]
