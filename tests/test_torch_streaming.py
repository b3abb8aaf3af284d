"""Streaming and multi-SNR runners of the PyTorch port
(``tests/test_harness.py:88-133`` and ``tests/test_multi_snr.py`` on the
port).

QP-ADMM streamed equals batched in all eight counters (no quantity of it
couples lanes), also when the trial count does not divide the batch; ALP
forced to stream equals batched; AGC-ALP streamed is held to batched trial
by trial, a differing trial to the conditions of the trap that explains it; the fused multi-SNR BP run
equals the per-SNR runs; ``merge`` and the ``streaming="auto"`` rule.
"""
import numpy as np
import pytest
import torch

from ldpc_tpu_torch.channel.awgn import (channel, noise_scales, snr_table,
                                         transmit)
from ldpc_tpu_torch.codes.gf2 import gf2_nullspace
from ldpc_tpu_torch.decoders import make_decoder
from ldpc_tpu_torch.decoders.admm import QPADMMDecoder
from ldpc_tpu_torch.decoders.agc_alp import AGCALPDecoder
from ldpc_tpu_torch.decoders.alp import ALPDecoder
from ldpc_tpu_torch.decoders.bp import BPDecoder
from ldpc_tpu_torch.harness import experiment
from ldpc_tpu_torch.harness.experiment import (COUNTERS, ExperimentResult,
                                               channel_step, run_experiment,
                                               run_multi_snr_experiment)

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _codewords(h, num, seed):
    g, _ = gf2_nullspace(h)
    rng = np.random.default_rng(seed)
    return ((rng.integers(0, 2, (num, g.shape[0])) @ g) % 2).astype(np.uint8)


def _counters(res: ExperimentResult):
    return tuple(getattr(res, k) for k in COUNTERS)


def test_qpadmm_streamed_equals_batched(small_h):
    cw = _codewords(small_h, 90, seed=4)
    dec = QPADMMDecoder(small_h, max_iter=600, device=CPU)
    dec.stream_chunk_iters = 64
    run = lambda cws, streaming: run_experiment(
        dec, small_h, cws, 0.0, 4, batch_size=32, device=CPU,
        streaming=streaming)
    batched, streamed = run(cw, False), run(cw, True)
    assert streamed.total == 90 and streamed.sum_iterations > 90
    assert _counters(streamed) == _counters(batched)
    # a trial count that does not divide the batch: the tail lanes start
    # frozen and leak nothing
    batched, streamed = run(cw[:70], False), run(cw[:70], True)
    assert streamed.total == 70
    assert _counters(streamed) == _counters(batched)
    # fewer trials than lanes
    batched, streamed = run(cw[:20], False), run(cw[:20], True)
    assert _counters(streamed) == _counters(batched)


def test_alp_streamed_equals_batched(small_h):
    """One chunk is one cut round; refilled lanes restart mid-batch with
    their own round budgets."""
    cw = _codewords(small_h, 60, seed=5)
    dec = ALPDecoder(small_h, max_rounds=12, device=CPU)
    run = lambda streaming: run_experiment(
        dec, small_h, cw, 2.0, 5, batch_size=16, device=CPU,
        streaming=streaming)
    batched, streamed = run(False), run(True)
    assert streamed.total == 60
    assert _counters(streamed) == _counters(batched)


class _TrialLog(AGCALPDecoder):
    """AGC-ALP that records each trial's outcome in the chunk where its lane
    finishes: the trial is recognised by its lane's objective row ``c``,
    which ``stream_init`` makes from that trial's LLRs alone."""

    def __init__(self, h, llr_table):
        super().__init__(h, device=CPU)
        self.c_table = self._init_state(llr_table)["c"]
        self.log = {}

    def stream_chunk(self, st):
        before = st["done"].clone()
        st = super().stream_chunk(st)
        res = self._finish(st)
        for i in torch.nonzero(st["done"] & ~before).flatten().tolist():
            t = int(torch.nonzero((self.c_table == st["c"][i]).all(-1))[0])
            self.log[t] = (res.bits[i].clone(), bool(res.success[i]),
                           *(int(st[k][i]) for k in ("rounds", "cum_h",
                                                     "cum_g", "dropped")))
        return st


def test_agc_alp_streamed_against_batched(small_h):
    """16 trials of ``data/H.txt`` at 0 dB in batches of 8 (so
    ``streaming="auto"`` streams). Every trial's bits and success equal the
    batched run's, and so do its rounds and cut counts, except where a
    trial meets the trap of the IPM's coupled stop test: the solve stops on
    the batch's largest error, and the batch around a lane differs between
    the runs, so the lane's LP solution, and from there its cuts and
    rounds, may differ while it certifies the same codeword.

    On this fixture one trial does so: trial 11, in its 7th round, holds the
    same 81 cuts in both runs, but its solve stops at another 5-step chunk
    (error 1.42e-5 batched against 3.10e-6 streamed; trials 8-15 share its
    batch batched, 6, 7 and refilled or frozen lanes streamed). Round 8's
    Gaussian source then appends 46 cuts against 45, and the lane ends
    after 13 rounds (89 H cuts, 99 Gaussian) against 11 (91, 107). The test
    holds the trap's conditions rather than those numbers, which any
    harmless change of summation order may move: a differing trial
    certifies in both runs with the same bits, and the differences are
    what ``sum_iterations`` differs by."""
    cw = _codewords(small_h, 16, seed=6)
    y = channel_step(torch.from_numpy(cw), torch.arange(16), 0.0, 6)
    llrs = noise_scales(0.0)[1] * y
    dec = _TrialLog(small_h, llrs)
    batched = run_experiment(dec, small_h, cw, 0.0, 6, batch_size=8,
                             device=CPU, streaming=False)
    streamed = run_experiment(dec, small_h, cw, 0.0, 6, batch_size=8,
                              device=CPU, warmup=False)
    assert sorted(dec.log) == list(range(16))
    assert _counters(streamed)[:6] == _counters(batched)[:6]
    assert streamed.sum_dropped == batched.sum_dropped == 0
    differ, round_gap = [], 0
    for half in (0, 1):
        lanes = slice(8 * half, 8 * half + 8)
        st = dec._run_loop(llrs[lanes])
        res = dec._finish(st)
        for i in range(8):
            t = 8 * half + i
            bits, ok, *counts = dec.log[t]
            assert torch.equal(bits, res.bits[i]) and ok == bool(
                res.success[i]), t
            want = [int(st[k][i]) for k in ("rounds", "cum_h", "cum_g",
                                            "dropped")]
            if counts != want:
                differ.append(t)
                assert ok and bool(res.success[i]), t    # both certify
                assert counts[3] == want[3] == 0, t
                round_gap += want[0] - counts[0]
    assert len(differ) <= 2, differ
    assert batched.sum_iterations - streamed.sum_iterations == round_gap


def test_multi_snr_fused_equals_per_snr(small_h):
    cw = _codewords(small_h, 48, seed=5)
    dec = BPDecoder(small_h, max_iter=12, device=CPU)
    snrs = [0.0, 2.0, 4.0]
    fused = run_multi_snr_experiment(dec, small_h, cw, snrs, 5,
                                     batch_size=36, device=CPU)
    assert len(fused) == 3
    for snr, fres in zip(snrs, fused):
        single = run_experiment(dec, small_h, cw, snr, 5, batch_size=48,
                                device=CPU)
        assert fres.total == single.total == 48
        assert _counters(fres) == _counters(single), snr
        assert fres.time_sec > 0
    assert fused[0].time_sec == fused[2].time_sec


@pytest.mark.parametrize("snr", [-3.0, 0.5, 6.0])
def test_lane_noise_scale_equals_scalar_path(snr, small_h):
    """A lane's symbols and LLRs from the per-SNR table equal the scalar
    path's bit for bit."""
    cw = torch.from_numpy(_codewords(small_h, 8, seed=1))
    idx = torch.arange(100, 108)
    sigmas, inv_vars = snr_table([1.0, snr], CPU)
    sid = torch.ones(8, dtype=torch.int64)
    y, llrs, _ = channel(cw, idx, 3, sigmas[sid], inv_vars[sid])
    want = transmit(cw, snr, 3, idx)
    assert torch.equal(y, want)
    assert torch.equal(llrs, noise_scales(snr)[1] * want)
    assert sigmas.dtype == inv_vars.dtype == torch.float32


def test_merge_adds_every_field():
    a = ExperimentResult(total=10, correct=7, pseudo=1, sum_hamming=30,
                         sum_hamming_ok=12, sum_hamming_wrong=18,
                         time_sec=0.5, sum_iterations=40, sum_dropped=2)
    b = ExperimentResult(total=5, correct=5, pseudo=0, sum_hamming=9,
                         sum_hamming_ok=9, sum_hamming_wrong=0,
                         time_sec=0.25, sum_iterations=11, sum_dropped=0)
    a.merge(b)
    assert _counters(a) == (15, 12, 1, 39, 21, 18, 51, 2)
    assert a.time_sec == 0.75 and a.fer == 3 / 15


class _Batched(Exception):
    pass


@pytest.mark.parametrize("kind,trials,batch,streams", [
    ("qp-admm", 64, 32, True), ("qp-admm", 63, 32, False),
    ("agc-alp", 16, 8, True), ("alp", 64, 32, False), ("bp", 64, 32, False),
    ("full-lp", 64, 32, False)])
def test_streaming_auto_rule(kind, trials, batch, streams, small_h,
                             monkeypatch):
    """Stream when the decoder has ``stream_init``, ``prefer_streaming`` is
    not False and there are at least two batches of trials
    (``ldpc_tpu/harness/experiment.py:328-334``)."""
    calls = []
    monkeypatch.setattr(experiment, "run_streaming_experiment",
                        lambda *a, **k: calls.append(k) or "streamed")

    def batched(*args, **kwargs):       # the batched runner starts here
        raise _Batched

    monkeypatch.setattr(experiment, "make_experiment_step", batched)
    dec = make_decoder(kind, small_h, device=CPU)
    cw = np.zeros((trials, small_h.shape[1]), np.uint8)
    try:
        out = run_experiment(dec, small_h, cw, 0.0, 1, batch_size=batch,
                             device=CPU)
    except _Batched:
        out = "batched"
    assert out == ("streamed" if streams else "batched")
    if streams:
        assert calls[0]["batch_size"] == batch
