"""The port's spans and counters (``ldpc_tpu_torch/utils/profiling.py``,
``COUNTS`` of ``decoders/alp.py``, ``ops/lp_solver.py`` and
``harness/experiment.py``), on the CPU.

Spans are ``record_function`` ranges while a ``torch.profiler`` records and
a shared no-op otherwise; every name is in ``SPANS`` and they nest as the
layers do (``harness.block > harness.channel``, ``alp.decode > alp.round >
lp.solve > lp.poll``). The counters are host integers that neither the
profiler nor the spans move, and the cut loop's reads follow the budget
that ``decoders/alp.py``'s docstring states.
"""
import os
from collections import Counter

import numpy as np
import pytest
import torch

from ldpc_tpu_torch.channel.awgn import gen_random_codewords, llr_variance
from ldpc_tpu_torch.codes.gf2 import gf2_nullspace
from ldpc_tpu_torch.codes.io import read_pcm
from ldpc_tpu_torch.decoders import alp
from ldpc_tpu_torch.decoders.agc_alp import AGCALPDecoder
from ldpc_tpu_torch.decoders.bp import BPDecoder
from ldpc_tpu_torch.harness import experiment
from ldpc_tpu_torch.harness.experiment import (run_experiment,
                                               run_streaming_experiment)
from ldpc_tpu_torch.ops import lp_solver
from ldpc_tpu_torch.utils.profiling import SPANS, span, spanned

CPU = torch.device("cpu")
H = read_pcm(os.path.join(os.path.dirname(__file__), "..", "data", "H.txt"))
OWNERS = {"alp": alp, "lp": lp_solver, "harness": experiment}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _llrs(lanes, snr, seed):
    g, _ = gf2_nullspace(H)
    rng = np.random.default_rng(seed)
    cw = (rng.integers(0, 2, (lanes, g.shape[0])) @ g) % 2
    var = llr_variance(snr)
    y = 1.0 - 2.0 * cw + np.sqrt(var) * rng.standard_normal(cw.shape)
    return torch.from_numpy((2.0 * y / var).astype(np.float32))


def _alp(kind):
    if kind == "agc-alp":
        return AGCALPDecoder(H, device=CPU)
    dec = alp.ALPDecoder(H, device=CPU)
    dec.lp_backend = "kernel"           # the fused loop, its twin here
    return dec


def _codewords(trials, seed=5):
    g, _ = gf2_nullspace(H)
    return gen_random_codewords(g, trials, torch.Generator().manual_seed(seed),
                                CPU)


def _snapshot():
    return {key: Counter(m.COUNTS) for key, m in OWNERS.items()}


def _grown(before):
    return {key: Counter(m.COUNTS) - before[key] for key, m in OWNERS.items()}


def _profiled(fn):
    with torch.profiler.profile() as prof:
        out = fn()
    spans = [e for e in prof.events() if e.is_user_annotation]
    return out, spans


def _chain(e):
    """The names of ``e``'s enclosing spans, innermost first."""
    out = []
    while e is not None:
        if e.is_user_annotation:
            out.append(e.name)
        e = e.cpu_parent
    return tuple(out)


def test_span_off_opens_no_record_function(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function opened with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    assert span("alp.round") is span("harness.block")
    assert span("not.a.span") is span("lp.poll")    # unchecked while off
    res = run_experiment(_alp("alp"), H, _codewords(8), 1.0, 3,
                         batch_size=4, device=CPU, warmup=False)
    assert res.total == 8


def test_span_refuses_a_name_outside_spans_while_profiling():
    with torch.profiler.profile():
        with pytest.raises(ValueError, match="SPANS"):
            span("alp.solve")
        with span("lp.solve"):
            pass
    assert "alp.solve" not in SPANS


def test_spanned_refuses_a_name_outside_spans_when_it_decorates():
    with pytest.raises(ValueError, match="SPANS"):
        spanned("alp.solve")
    twice = spanned("lp.solve")(lambda v: 2 * v)
    assert twice(3) == 6
    with torch.profiler.profile() as prof:
        assert twice(4) == 8
    assert [e.name for e in prof.events() if e.is_user_annotation] == \
        ["lp.solve"]


@pytest.mark.parametrize("kind", ["alp", "agc-alp"])
def test_decoder_spans_nest_as_the_layers(kind):
    dec = _alp(kind)
    res, spans = _profiled(lambda: dec.decode_batch(_llrs(4, 1.0, 3)))
    names = Counter(e.name for e in spans)
    assert set(names) <= SPANS
    assert names["alp.decode"] == 1
    rounds = int(res.iterations.max())
    assert names["alp.round"] == names["alp.tier_read"] == rounds
    assert names["alp.done_read"] == rounds + 1
    chains = {_chain(e) for e in spans}
    assert ("lp.poll", "lp.solve", "alp.round", "alp.decode") in chains
    assert ("alp.cut_search", "alp.round", "alp.decode") in chains
    assert ("alp.append", "alp.round", "alp.decode") in chains
    assert ("alp.tier_read", "alp.round", "alp.decode") in chains
    assert ("alp.done_read", "alp.decode") in chains
    if kind == "agc-alp":
        assert ("agc.gauss", "alp.round", "alp.decode") in chains
    assert all(c[-1] == "alp.decode" for c in chains)


def test_batched_runner_spans_its_block():
    dec = BPDecoder(H, max_iter=20, device=CPU)
    res, spans = _profiled(lambda: run_experiment(
        dec, H, _codewords(12), 1.0, 3, batch_size=8, device=CPU,
        warmup=False))
    assert res.total == 12
    names = Counter(e.name for e in spans)
    assert set(names) <= SPANS and names["harness.block"] == 1
    assert names["bp.decode"] == names["harness.count"] == 2
    assert names["harness.sync"] == 3       # the two clocks, the read
    chains = {_chain(e) for e in spans}
    assert ("bp.decode", "harness.block") in chains
    assert ("harness.channel", "harness.block") in chains
    assert all(c[-1] == "harness.block" for c in chains)


def test_streamed_runner_spans_its_block():
    dec = AGCALPDecoder(H, device=CPU)
    res, spans = _profiled(lambda: run_streaming_experiment(
        dec, H, _codewords(6), 1.0, 3, batch_size=4, device=CPU,
        warmup=False))
    assert res.total == 6
    names = Counter(e.name for e in spans)
    assert set(names) <= SPANS and names["harness.block"] == 1
    chains = {_chain(e) for e in spans}
    for want in (("harness.refill", "harness.block"),
                 ("harness.channel", "harness.refill", "harness.block"),
                 ("harness.count", "harness.block"),
                 ("alp.round", "harness.block"),
                 ("alp.done_read", "harness.block")):
        assert want in chains, want
    assert all(c[-1] == "harness.block" for c in chains)


@pytest.mark.parametrize("kind", ["alp", "agc-alp"])
def test_results_and_counters_equal_with_the_profiler_on_and_off(kind):
    cw = _codewords(8)

    def run():
        before = _snapshot()
        res = run_experiment(_alp(kind), H, cw, 1.0, 11, batch_size=4,
                             device=CPU, warmup=False, streaming=False)
        return res, _grown(before)

    (off, grown_off), (on, grown_on) = run(), _profiled(run)[0]
    assert [getattr(off, k) for k in experiment.COUNTERS] == \
        [getattr(on, k) for k in experiment.COUNTERS]
    assert grown_off == grown_on
    assert grown_on["harness"]["batches"] == 2
    assert grown_on["harness"]["reads.result"] == 1


def test_one_alp_batch_reads_as_the_docstring_budgets(monkeypatch):
    """Per round: the append's ``nonzero``, the tier read and the loop's
    ``all(done)``, and one more ``all(done)`` at the end; per fused PDHG
    solve of k chunks, k reads (k - 1 when it used its whole budget)."""
    solves = []
    inner = alp.pdhg_box_lp_fused

    def counted(*args, **kwargs):
        chunks = lp_solver.COUNTS["chunks"]
        out = inner(*args, **kwargs)
        budget = -(-args[5] // kwargs["check_every"])
        solves.append((lp_solver.COUNTS["chunks"] - chunks, budget))
        return out

    monkeypatch.setattr(alp, "pdhg_box_lp_fused", counted)
    dec = _alp("alp")
    before = _snapshot()
    res = dec.decode_batch(_llrs(8, -1.0, 3))
    got = _grown(before)
    rounds = int(res.iterations.max())
    assert rounds > 1 and solves
    a, lp = got["alp"], got["lp"]
    assert a["reads.append"] == a["reads.tier"] == rounds
    assert a["reads.done"] == rounds + 1
    assert a["lanes"] == 8 * rounds
    assert lp["chunks"] == sum(k for k, _ in solves)
    assert lp["reads.poll"] + lp["reads.guard"] == sum(
        k - (k == budget > 1) for k, budget in solves)
    assert 0 < a["solve_lanes"] <= a["lanes"]
    assert a["solve_lanes"] <= lp["lanes"] <= 8 * lp["chunks"]
    assert not a["reads.need"] and not a["reads.append_g"]


def test_agc_alp_counts_its_elimination_reads():
    before = _snapshot()
    res = _alp("agc-alp").decode_batch(_llrs(4, 1.0, 3))
    a = _grown(before)["alp"]
    assert a["reads.need"] == a["reads.tier"] == int(res.iterations.max())
    assert 0 < a["reads.append_g"] <= a["reads.need"]
    assert not _grown(before)["lp"]["chunks"]   # the IPM solves these

