"""QP-ADMM's spans and counters (``admm.*`` of
``ldpc_tpu_torch/utils/profiling.py``, ``COUNTS`` of
``decoders/admm.py``), on the CPU.

A batched decode is the span ``admm.decode``; the stream's start, chunks
and finish are ``admm.init``, ``admm.chunk`` and ``admm.finish``, which the
streamed runner opens inside its refill, its block and its classification.
``COUNTS`` counts decodes, chunks and the lanes started from calls and
shapes alone. Neither moves a decoded bit, an iteration count or one of
the runner's counters or host reads. One ``gpu`` case holds the chunks to
the kernel's launches on the card.
"""
import os
from collections import Counter

import numpy as np
import pytest
import torch

from ldpc_tpu_torch.channel.awgn import gen_random_codewords, llr_variance
from ldpc_tpu_torch.codes.gf2 import gf2_nullspace
from ldpc_tpu_torch.codes.io import read_pcm
from ldpc_tpu_torch.decoders import admm
from ldpc_tpu_torch.decoders.admm import QPADMMDecoder, decode_qp_admm
from ldpc_tpu_torch.harness import experiment
from ldpc_tpu_torch.harness.experiment import (run_experiment,
                                               run_streaming_experiment)
from ldpc_tpu_torch.utils.profiling import SPANS

CPU = torch.device("cpu")
H = read_pcm(os.path.join(os.path.dirname(__file__), "..", "data", "H.txt"))
ADMM_SPANS = ("admm.decode", "admm.init", "admm.chunk", "admm.finish")
METHODS = ("decode_batch", "decode_batch_params", "stream_init",
           "stream_chunk", "stream_finish")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _decoder(max_iter=200, chunk=32):
    dec = QPADMMDecoder(H, max_iter=max_iter, device=CPU)
    dec.stream_chunk_iters = chunk
    return dec


def _llrs(lanes, snr=1.0, seed=3):
    g, _ = gf2_nullspace(H)
    rng = np.random.default_rng(seed)
    cw = (rng.integers(0, 2, (lanes, g.shape[0])) @ g) % 2
    var = llr_variance(snr)
    y = 1.0 - 2.0 * cw + np.sqrt(var) * rng.standard_normal(cw.shape)
    return torch.from_numpy((2.0 * y / var).astype(np.float32))


def _codewords(trials, seed=5):
    g, _ = gf2_nullspace(H)
    return gen_random_codewords(g, trials, torch.Generator().manual_seed(seed),
                                CPU)


def _profiled(fn):
    with torch.profiler.profile() as prof:
        out = fn()
    return out, [e for e in prof.events() if e.is_user_annotation]


def _chain(e):
    """The names of ``e``'s enclosing spans, innermost first."""
    out = []
    while e is not None:
        if e.is_user_annotation:
            out.append(e.name)
        e = e.cpu_parent
    return tuple(out)


def _unspanned(dec):
    """``dec`` with each spanned method replaced by its body as it was
    before the spans (``functools.wraps`` keeps it as ``__wrapped__``)."""
    for name in METHODS:
        body = getattr(QPADMMDecoder, name).__wrapped__
        setattr(dec, name, body.__get__(dec))
    return dec


def _stream(dec, trials=10, batch=4, seed=11):
    return run_streaming_experiment(dec, H, _codewords(trials), 1.0, seed,
                                    batch_size=batch, device=CPU,
                                    warmup=False)


def _fields(res):
    return [getattr(res, k) for k in experiment.COUNTERS]


def test_the_four_spans_are_the_programs():
    assert set(ADMM_SPANS) <= SPANS
    for name in METHODS:
        assert hasattr(getattr(QPADMMDecoder, name), "__wrapped__"), name
    assert not hasattr(QPADMMDecoder.stream_done, "__wrapped__")


@pytest.mark.parametrize("method", ["decode_batch", "decode_batch_params"])
def test_a_decode_is_one_admm_decode_span(method):
    dec = _decoder()
    llrs = _llrs(4)
    args = (llrs,) if method == "decode_batch" else (llrs, 1.2, 0.55)
    _, spans = _profiled(lambda: getattr(dec, method)(*args))
    assert Counter(e.name for e in spans) == Counter({"admm.decode": 1})


def test_each_stream_method_opens_its_span():
    dec = _decoder()
    llrs = _llrs(4)

    def stream():
        st = dec.stream_init(llrs)
        st = dec.stream_chunk(st)
        st = dec.stream_chunk(st)
        return dec.stream_finish(st)
    _, spans = _profiled(stream)
    assert Counter(e.name for e in spans) == Counter(
        {"admm.init": 1, "admm.chunk": 2, "admm.finish": 1})
    assert {_chain(e) for e in spans} == {(n,) for n in ADMM_SPANS[1:]}


def test_the_streamed_runner_nests_the_spans_in_its_own():
    dec = _decoder()
    res, spans = _profiled(lambda: _stream(dec))
    assert res.total == 10
    names = Counter(e.name for e in spans)
    assert set(names) <= SPANS
    assert names["admm.decode"] == 0 and names["admm.chunk"] >= 2
    # one stream_finish and one refill a chunk; the first init in the block
    assert names["admm.finish"] == names["harness.refill"] == \
        names["admm.chunk"]
    chains = {_chain(e) for e in spans}
    for want in (("admm.init", "harness.block"),
                 ("admm.init", "harness.refill", "harness.block"),
                 ("admm.chunk", "harness.block"),
                 ("admm.finish", "harness.count", "harness.block")):
        assert want in chains, want
    assert all(c[-1] == "harness.block" for c in chains)


def test_batched_runner_spans_each_decode():
    dec = _decoder()
    res, spans = _profiled(lambda: run_experiment(
        dec, H, _codewords(12), 1.0, 3, batch_size=8, device=CPU,
        warmup=False, streaming=False))
    assert res.total == 12
    names = Counter(e.name for e in spans)
    assert names["admm.decode"] == 2 and names["admm.chunk"] == 0
    assert ("admm.decode", "harness.block") in {_chain(e) for e in spans}


def test_counts_grow_with_decodes_and_lanes():
    dec = _decoder()
    before = Counter(admm.COUNTS)
    dec.decode_batch(_llrs(4))
    dec.decode_batch_params(_llrs(3), 1.2, 0.55)
    grown = Counter(admm.COUNTS) - before
    assert grown == Counter({"decodes": 2, "lanes_started": 7})


def test_counts_follow_the_stream_call_by_call():
    """``chunks`` is the calls of ``stream_chunk``; ``lanes_started`` the
    rows handed to ``stream_init``: the first batch and every refill."""
    dec = _decoder()
    seen = Counter()
    init, chunk = dec.stream_init, dec.stream_chunk

    def counted_init(llrs):
        seen["lanes_started"] += llrs.shape[0]
        return init(llrs)

    def counted_chunk(st):
        seen["chunks"] += 1
        return chunk(st)
    dec.stream_init, dec.stream_chunk = counted_init, counted_chunk
    before = Counter(admm.COUNTS)
    res = _stream(dec, trials=10, batch=4)
    grown = Counter(admm.COUNTS) - before
    assert res.total == 10
    assert grown == seen and grown["decodes"] == 0
    # every trial started once, and the start filled the batch
    assert grown["lanes_started"] >= 10 and grown["chunks"] >= 3


def test_counts_are_the_same_with_the_profiler_on_and_off():
    def run():
        before = Counter(admm.COUNTS), Counter(experiment.COUNTS)
        res = _stream(_decoder())
        return (_fields(res), Counter(admm.COUNTS) - before[0],
                Counter(experiment.COUNTS) - before[1])
    off, (on, _) = run(), _profiled(run)
    assert off == on


def test_batched_results_are_unchanged_by_the_spans():
    """Without a profiler, bit for bit what the methods gave before the
    spans, and what the plain decode gives."""
    llrs = _llrs(6, snr=0.0)
    got = _decoder().decode_batch(llrs)
    before = _unspanned(_decoder()).decode_batch(llrs)
    dec = _decoder()
    plain = decode_qp_admm(dec.tables, dec.n, llrs, dec.alpha, dec.mu,
                           dec.max_iter, dec.eps_stop)
    for want in (before, plain):
        assert torch.equal(got.bits, want.bits)
        assert torch.equal(got.success, want.success)
        assert torch.equal(got.iterations, want.iterations)
    assert int(got.iterations.min()) < dec.max_iter   # some lane stopped


def test_streamed_results_are_unchanged_by_the_spans():
    got = _stream(_decoder(), trials=12, seed=7)
    before = _stream(_unspanned(_decoder()), trials=12, seed=7)
    batched = run_experiment(_decoder(), H, _codewords(12), 1.0, 7,
                             batch_size=4, device=CPU, warmup=False,
                             streaming=False)
    assert _fields(got) == _fields(before) == _fields(batched)


@pytest.mark.gpu
def test_chunks_are_the_kernels_launches_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ldpc_tpu_torch.ops import admm_kernel
    dev = torch.device("cuda")
    dec = QPADMMDecoder(H, max_iter=200, device=dev)
    dec.stream_chunk_iters = 32
    before, launches = Counter(admm.COUNTS), admm_kernel.ITERATE_LAUNCHES
    res = run_streaming_experiment(dec, H, _codewords(40).to(dev), 1.0, 3,
                                   batch_size=16, device=dev, warmup=False)
    grown = Counter(admm.COUNTS) - before
    assert res.total == 40 and grown["chunks"] >= 3
    assert grown["chunks"] == admm_kernel.ITERATE_LAUNCHES - launches
