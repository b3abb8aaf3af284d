"""The IPM solver's counters and spans (``ops/ipm_solver.py``): ``COUNTS``
(``solves``, ``chunks``, ``reads.poll``) and the spans ``lp.capture`` and
``lp.copy_in`` of the graph path, and the Newton step's three kernels
(``ops/ipm_kernel.py``), once each a Newton step.

On the CPU, eager: one ``ipm_box_lp`` call moves ``solves`` by 1, ``chunks``
by the Newton-step chunks its loop ran and ``reads.poll`` by the loop's
host reads of its flag, one at each chunk boundary it reached; the spans of
the graph path stay closed; ``ipm_capture`` captures nothing there; a
stream's captures of AGC-ALP's row tiers take the shapes of the solves they
serve; AGC-ALP's decode moves them within the bounds its solves set, and
ALP's PDHG decode not at all. On the card (marked
``gpu``; ``python -m pytest tests/test_torch_ipm_counts.py -m gpu
--noconftest``): a graph solve moves them exactly as the eager solve does,
``lp.capture`` opens only on a solve shape's first call, and ``lp.copy_in``
on every graph solve; and a streamed AGC-ALP run captures every row tier's
solve shape on its first chunk and nothing after it.
"""
import os
from collections import Counter

import numpy as np
import pytest
import torch

from ldpc_tpu_torch.codes.io import read_pcm
from ldpc_tpu_torch.decoders.agc_alp import AGCALPDecoder
from ldpc_tpu_torch.decoders.alp import ALPDecoder
from ldpc_tpu_torch.ops import ipm_graph, ipm_solver
from ldpc_tpu_torch.ops.ipm_solver import COUNTS, ipm_box_lp
from ldpc_tpu_torch.utils.profiling import SPANS

H = read_pcm(os.path.join(os.path.dirname(__file__), "..", "data", "H.txt"))
KEYS = ("solves", "chunks", "reads.poll")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _lp(seed, bsz, n, t, active_rows, dev="cpu"):
    """Signed +-1/0 cut rows with a feasible rhs, as a row slice of a
    deeper buffer."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    score = torch.rand((bsz, active_rows, n), generator=gen, device=dev)
    k = torch.randint(3, 9, (bsz, active_rows, 1), generator=gen,
                      device=dev)
    kth = score.sort(dim=-1).values.gather(-1, k - 1)
    sign = torch.where(torch.rand(score.shape, generator=gen, device=dev)
                       < 0.5, -1.0, 1.0)
    rows = torch.where(score <= kth, sign, 0.0)
    buf = torch.zeros((bsz, t + 16, n), device=dev)
    buf[:, :active_rows] = rows
    b = torch.zeros((bsz, t), device=dev)
    b[:, :active_rows] = (rows > 0).sum(dim=-1) - 1.0
    c = 4.0 * torch.randn((bsz, n), generator=gen, device=dev)
    return c, buf[:, :t], b


def _grown(before):
    return {k: COUNTS[k] - before[k] for k in KEYS}


def _loop_calls(monkeypatch):
    """Counts of the eager loop's chunk boundaries and Newton steps."""
    calls = Counter()
    for name in ("_boundary", "_newton"):
        inner = getattr(ipm_solver, name)

        def counted(*args, _inner=inner, _name=name):
            calls[_name] += 1
            return _inner(*args)
        monkeypatch.setattr(ipm_solver, name, counted)
    return calls


def _spans(fn):
    """``fn()`` and its spans on the host (a card's trace mirrors each one
    on the device too)."""
    with torch.profiler.profile() as prof:
        out = fn()
    return out, Counter(e.name for e in prof.events()
                        if e.is_user_annotation
                        and e.device_type == torch.autograd.DeviceType.CPU)


def test_the_spans_are_the_programs():
    assert {"lp.capture", "lp.copy_in"} <= SPANS


@pytest.mark.parametrize("backends", [("xla", "xla"), ("kernel", "blocked")])
@pytest.mark.parametrize("iters,every,warm", [(40, 5, False), (40, 5, True),
                                              (10, 5, False), (7, 2, True)])
def test_one_eager_solve_counts_its_chunks_and_reads(monkeypatch, backends,
                                                     iters, every, warm):
    c, a, b = _lp(3, 4, 40, 48, 30)
    kw = dict(iters=iters, check_every=every, matvec_backend=backends[0],
              factor_backend=backends[1], graphs=False)
    if warm:
        x, y, _ = ipm_box_lp(c, a, b, iters=10)
        kw.update(x0=(x + 0.05).clamp(0.0, 1.0), y0=y)
    calls = _loop_calls(monkeypatch)
    before = Counter(COUNTS)
    _, spans = _spans(lambda: ipm_box_lp(c, a, b, **kw))
    got = _grown(before)
    budget = -(-iters // every)
    assert calls["_newton"] % every == 0
    chunks = calls["_newton"] // every
    assert got == {"solves": 1, "chunks": chunks,
                   "reads.poll": calls["_boundary"]}
    # a read at every boundary; the last reads false unless the loop
    # ran its whole budget
    assert calls["_boundary"] == chunks + (chunks < budget)
    assert 1 <= chunks <= budget
    assert spans["lp.solve"] == 1
    assert spans["lp.poll"] == got["reads.poll"]
    assert not spans["lp.capture"] and not spans["lp.copy_in"]


@pytest.mark.parametrize("backends", [("xla", "xla"), ("kernel", "blocked")])
@pytest.mark.parametrize("iters,every", [(40, 5), (10, 5), (7, 2)])
def test_each_step_kernel_runs_once_a_newton_step(monkeypatch, backends,
                                                  iters, every):
    """The Newton step calls each of the three step wrappers
    (``ops/ipm_kernel.py``: one kernel each on the card) once, so each runs
    ``chunks`` x ``check_every`` times a solve."""
    c, a, b = _lp(6, 4, 40, 48, 30)
    calls = Counter()
    for name in ("ipm_prep", "ipm_predict", "ipm_correct"):
        inner = getattr(ipm_solver, name)

        def counted(*args, _inner=inner, _name=name):
            calls[_name] += 1
            return _inner(*args)
        monkeypatch.setattr(ipm_solver, name, counted)
    before = Counter(COUNTS)
    ipm_box_lp(c, a, b, iters=iters, check_every=every,
               matvec_backend=backends[0], factor_backend=backends[1])
    steps = _grown(before)["chunks"] * every
    assert steps >= every
    assert calls == dict.fromkeys(("ipm_prep", "ipm_predict",
                                   "ipm_correct"), steps)


def test_a_solve_that_need_not_step_reads_once():
    c, a, b = _lp(4, 3, 20, 24, 10)
    x, y, _ = ipm_box_lp(c, a, b, iters=40)
    before = Counter(COUNTS)
    ipm_box_lp(c, a, b, iters=40, x0=x, y0=y,
               active=torch.zeros(3, dtype=torch.bool))
    assert _grown(before) == {"solves": 1, "chunks": 0, "reads.poll": 1}


def test_capture_on_the_eager_path_is_a_no_op():
    """``ipm_capture`` checks its arguments as the solve does, captures
    nothing off the card and moves no counter."""
    c, a, b = _lp(5, 3, 20, 24, 10)
    before, captures = Counter(COUNTS), ipm_graph.CAPTURES
    assert ipm_solver.ipm_capture(c, a, b, iters=40) is False
    assert ipm_solver.ipm_capture(c, a, b, graphs=False) is False
    assert Counter(COUNTS) == before and ipm_graph.CAPTURES == captures
    with pytest.raises(ValueError, match="ipm_capture: graphs=True needs"):
        ipm_solver.ipm_capture(c, a, b, graphs=True)
    with pytest.raises(ValueError, match="check_every"):
        ipm_solver.ipm_capture(c, a, b, check_every=0)


def _shape(args, kw):
    """What keys a solve's graphs: the rows' shape, the settings, and which
    tensors (warm start, mask) are given."""
    return (tuple(args[1].shape),
            sorted((k, v) for k, v in kw.items() if v is not None
                   and not isinstance(v, torch.Tensor)),
            sorted(k for k, v in kw.items() if isinstance(v, torch.Tensor)))


def test_a_streams_captures_key_the_solves_they_serve(monkeypatch):
    """AGC-ALP's captures of every row tier (``_capture_tiers``) and its
    solves take their arguments from one method (``_ipm_args``), so each
    solve's shape is one that the stream's first chunk captured."""
    from ldpc_tpu_torch.decoders import agc_alp, alp
    captured, solved = set(), []
    real_capture, real_solve = agc_alp.ipm_capture, alp.ipm_box_lp

    def capture(*args, **kw):
        captured.add(repr(_shape(args, kw)))
        return real_capture(*args, **kw)

    def solve(*args, **kw):
        solved.append(repr(_shape(args, kw)))
        return real_solve(*args, **kw)

    monkeypatch.setattr(agc_alp, "ipm_capture", capture)
    monkeypatch.setattr(alp, "ipm_box_lp", solve)
    rng = np.random.default_rng(4)
    llrs = torch.from_numpy(
        (1.0 + 1.5 * rng.standard_normal((4, H.shape[1]))).astype(
            np.float32))
    dec = AGCALPDecoder(H, device="cpu")
    st = dec.stream_init(llrs)
    for _ in range(4):
        st = dec.stream_chunk(st)
    assert len(captured) == len(dec._tiers) + 1
    assert solved and set(solved) <= captured


def test_agc_alp_decode_moves_the_counters_and_alp_does_not():
    from ldpc_tpu_torch.decoders import alp
    rng = np.random.default_rng(3)
    # the zero word through a channel a few bits flip
    llrs = torch.from_numpy(
        (2.5 + 1.5 * rng.standard_normal((4, H.shape[1]))).astype(
            np.float32))
    dec = ALPDecoder(H, device="cpu")
    dec.lp_backend = "kernel"
    before = Counter(COUNTS)
    dec.decode_batch(llrs)
    assert _grown(before) == dict.fromkeys(KEYS, 0)
    before, tiers = Counter(COUNTS), alp.COUNTS["reads.tier"]
    res, spans = _spans(lambda: AGCALPDecoder(H, device="cpu").decode_batch(
        llrs))
    got = _grown(before)
    assert got["solves"] == spans["lp.solve"] >= 1
    assert got["solves"] <= alp.COUNTS["reads.tier"] - tiers == int(
        res.iterations.max())
    assert got["chunks"] <= got["reads.poll"] <= got["chunks"] + \
        got["solves"]


@pytest.mark.gpu
@pytest.mark.parametrize("warm", [False, True])
def test_graph_solve_counts_as_the_eager_one_on_card(warm):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    # a shape of its own, so that its first graph solve here captures
    c, a, b = _lp(11 + warm, 7, 88, 96, 60, dev)
    kw = dict(iters=40, tol=1e-5)
    if warm:
        x, y, _ = ipm_box_lp(c, a, b, graphs=False, iters=10)
        kw.update(x0=(x + 0.05).clamp(0.0, 1.0), y0=y,
                  active=torch.arange(7, device=dev) % 3 != 0)
    runs = []
    for graphs in (False, True, True):
        before = Counter(COUNTS)
        _, spans = _spans(lambda: ipm_box_lp(c, a, b, graphs=graphs, **kw))
        torch.cuda.synchronize()
        runs.append((_grown(before), spans))
    (eager, e_spans), (first, f_spans), (second, s_spans) = runs
    assert eager["solves"] == 1 and eager["chunks"] >= 1
    assert first == eager and second == eager
    assert f_spans["lp.capture"] == 1 and not s_spans["lp.capture"]
    assert not e_spans["lp.capture"] and not e_spans["lp.copy_in"]
    assert f_spans["lp.copy_in"] == s_spans["lp.copy_in"] == 1
    assert e_spans["lp.poll"] == f_spans["lp.poll"] == s_spans["lp.poll"] \
        == eager["reads.poll"]


@pytest.mark.gpu
@pytest.mark.parametrize("warm", [False, True])
def test_the_step_counters_advance_once_a_newton_step_on_card(warm):
    """``ipm_kernel``'s three launch counters each advance once a Newton
    step (``chunks`` x ``check_every``), eager and replayed alike."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from ldpc_tpu_torch.ops import ipm_kernel
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    # a shape of its own, so that its first graph solve here captures
    c, a, b = _lp(13 + warm, 9, 88, 104, 60, dev)
    kw = dict(iters=40, tol=1e-5)
    if warm:
        x, y, _ = ipm_box_lp(c, a, b, graphs=False, iters=10)
        kw.update(x0=(x + 0.05).clamp(0.0, 1.0), y0=y)
    names = ("PREP_LAUNCHES", "PREDICT_LAUNCHES", "CORRECT_LAUNCHES")
    for graphs in (False, True, True):
        before = Counter(COUNTS)
        launches = [getattr(ipm_kernel, k) for k in names]
        ipm_box_lp(c, a, b, graphs=graphs, **kw)
        torch.cuda.synchronize()
        steps = _grown(before)["chunks"] * 5
        assert steps >= 5
        assert [getattr(ipm_kernel, k) - n for k, n in
                zip(names, launches)] == [steps] * 3


@pytest.mark.gpu
def test_a_stream_captures_every_tier_on_its_first_chunk():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from ldpc_tpu_torch.channel.awgn import gen_random_codewords
    from ldpc_tpu_torch.codes.gf2 import gf2_nullspace
    from ldpc_tpu_torch.harness.experiment import run_streaming_experiment
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    h = read_pcm(os.path.join(os.path.dirname(__file__), "..", "data",
                              "optimalH.txt"))
    g, _ = gf2_nullspace(h)
    cw = gen_random_codewords(g, 72, torch.Generator(device=dev).manual_seed(
        5), dev)
    dec = AGCALPDecoder(h, device=dev)
    inner, seen = dec.stream_chunk, []

    def chunk(st):
        out = inner(st)
        seen.append(ipm_graph.CAPTURES)
        return out

    dec.stream_chunk = chunk
    before = ipm_graph.CAPTURES
    # a width of its own, so that its shapes are captured here
    res = run_streaming_experiment(dec, h, cw, -3.0, 5, batch_size=24,
                                   device=dev, warmup=False)
    assert res.total == 72
    assert seen[0] - before == 4 * (len(dec._tiers) + 1)
    assert seen[-1] == seen[0]
