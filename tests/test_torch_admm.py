"""QP-ADMM decoder of the PyTorch port against the JAX package.

The structure tables must equal JAX's bit for bit (with and without capacity
caps); the decode must equal the scalar NumPy oracle of
``tests/test_admm.py`` and JAX's ``decode_batch`` on the same numpy LLRs in
bits, success and iteration counts; per-lane (alpha, mu) must equal the
scalar calls; the precondition ``min(e) * mu > alpha`` must zero the batch
(H02 fails it at the defaults by design); and the streaming protocol must
equal JAX's chunk by chunk. The card is checked against the CPU in a ``gpu``
case (``python -m pytest tests/test_torch_admm.py -m gpu --noconftest``).
"""
import os

import numpy as np
import pytest
import torch

from ldpc_tpu_torch.channel.awgn import llr_variance
from ldpc_tpu_torch.codes.gf2 import gf2_nullspace
from ldpc_tpu_torch.codes.io import read_pcm
from ldpc_tpu_torch.decoders import admm
from ldpc_tpu_torch.decoders.admm import (ADMMStructure, QPADMMDecoder,
                                          _structure_caps)

try:  # the card's host has no JAX; only the gpu cases run there
    import jax.numpy as jnp
    from ldpc_tpu.decoders import admm as jadmm
    from test_admm import scalar_admm_reference
except ImportError:
    jnp = None

DATA = os.path.join(os.path.dirname(__file__), "..", "data")
CPU = torch.device("cpu")
TABLES = ("con_var", "con_coef", "b", "var_con", "var_coef", "e")
TINY = np.array([[1, 1, 0, 1, 1, 0, 0],
                 [1, 0, 1, 1, 0, 1, 0],
                 [0, 1, 1, 1, 0, 0, 1]], dtype=np.uint8)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small tensors: one intra-op thread, so parallel test workers do not
    oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _h(name):
    return TINY if name == "tiny" else read_pcm(
        os.path.join(DATA, f"{name}.txt"))


def _llrs(h, lanes, snr, seed):
    """Codewords and channel LLRs (float32) made with numpy from a seed."""
    g, _ = gf2_nullspace(h)
    rng = np.random.default_rng(seed)
    cw = (rng.integers(0, 2, (lanes, g.shape[0])) @ g) % 2
    var = llr_variance(snr)
    y = 1.0 - 2.0 * cw + np.sqrt(var) * rng.standard_normal(cw.shape)
    return (2.0 * y / var).astype(np.float32), cw.astype(np.uint8)


def _feasible(e_min, alpha, mu):
    """The precondition min(e) * mu > alpha in float32, as JAX tests it."""
    return bool(np.float32(e_min) * np.float32(mu) > np.float32(alpha))


def _same(got, want, what=""):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                  err_msg=what)


@pytest.mark.parametrize("caps", [False, True])
@pytest.mark.parametrize("name", ["tiny", "H", "optimalH", "H02"])
def test_tables_equal_jax(name, caps):
    h = _h(name)
    kw = {}
    if caps:
        nv, nc, km = _structure_caps(h)
        kw = dict(n_var_cap=nv + 5, n_con_cap=nc + 7, k_max_cap=km + 3)
    want = jadmm.ADMMStructure.from_h(h, **kw)
    got = ADMMStructure.from_h(h, **kw)
    assert (got.n, got.n_var, got.n_con) == (want.n, want.n_var, want.n_con)
    for key in TABLES:
        g, w = getattr(got, key), getattr(want, key)
        assert g.dtype == w.dtype and g.shape == w.shape, key
        np.testing.assert_array_equal(g, w, err_msg=key)
    assert got.e_min == want.e_min


@pytest.mark.parametrize("name,sizes,e_min", [
    ("H", (448, 1536, 20), 8.0), ("optimalH", (700, 2320, 24), 4.0),
    ("H05", (660, 2160, 24), 4.0), ("H02", (1260, 4520, 72), 2.0)])
def test_structure_sizes(name, sizes, e_min):
    h = _h(name)
    s = ADMMStructure.from_h(h)
    assert (s.n_var, s.n_con, s.var_con.shape[1]) == sizes
    assert _structure_caps(h) == sizes and s.e_min == e_min
    assert _feasible(s.e_min, 1.2, 0.55) == (name != "H02")


def test_matches_scalar_oracle():
    """Bits, success and iterations equal the scalar transcription of
    ``qp_admm.h`` (the Jacobi v-update is exact: it reads only yl, z, b)."""
    h = TINY
    llrs, _ = _llrs(h, 16, 0.0, seed=5)
    alpha, mu = 1.2, 0.55
    s = ADMMStructure.from_h(h)
    if s.e_min * mu <= alpha:
        mu = alpha / s.e_min + 0.5
    res = QPADMMDecoder(h, alpha=alpha, mu=mu, max_iter=300, eps_stop=1e-5,
                        device=CPU).decode_batch(torch.from_numpy(llrs))
    for t in range(16):
        bits, ok, iters = scalar_admm_reference(
            h, llrs[t].astype(np.float64), alpha, mu, 300, 1e-5)
        assert ok == bool(res.success[t])
        np.testing.assert_array_equal(res.bits[t].numpy(), bits,
                                      err_msg=f"trial {t}")
        assert int(res.iterations[t]) == iters, t


@pytest.mark.parametrize("snr", [0.0, 1.0, 2.0])
def test_decode_matches_jax(snr, small_h):
    """``data/H.txt``, 64 lanes, max_iter 600: bits, success and every
    lane's iteration count equal JAX's (the slots are summed in JAX's
    order, so sum2 lands on the same side of eps_stop)."""
    llrs, _ = _llrs(small_h, 64, snr, seed=int(10 + snr))
    want = jadmm.QPADMMDecoder(small_h, max_iter=600).decode_batch(
        jnp.asarray(llrs))
    got = QPADMMDecoder(small_h, max_iter=600, device=CPU).decode_batch(
        torch.from_numpy(llrs))
    _same(got.bits, want.bits, "bits")
    _same(got.success, want.success, "success")
    _same(got.iterations, want.iterations, "iterations")
    assert got.bits.dtype == torch.uint8 and got.iterations.dtype == \
        torch.int32


@pytest.mark.parametrize("check_every", [1, 7, 600])
def test_results_do_not_depend_on_the_block_size(check_every, small_h,
                                                 monkeypatch):
    """The host reads all(done) once per block of iterations; extra
    iterations of a done batch change nothing, batched or streamed."""
    llrs = torch.from_numpy(_llrs(small_h, 32, 1.0, seed=3)[0])
    dec = QPADMMDecoder(small_h, max_iter=600, device=CPU)
    dec.stream_chunk_iters = 100
    want = dec.decode_batch(llrs)
    want_st = dec.stream_chunk(dec.stream_init(llrs))
    monkeypatch.setattr(admm, "CHECK_EVERY", check_every)
    got = dec.decode_batch(llrs)
    for a, b in zip(got, want):
        if a is not None:
            assert torch.equal(a, b)
    got_st = dec.stream_chunk(dec.stream_init(llrs))
    for key in ("v", "z", "yl", "done", "it"):
        assert torch.equal(got_st[key], want_st[key]), key


def test_lane_params_equal_scalar_calls(small_h):
    """Per-lane (alpha, mu), one pair infeasible, equals decode_batch at
    each pair; scalar pairs equal decode_batch exactly; JAX's traced-params
    decode agrees on one pair."""
    llrs, _ = _llrs(small_h, 24, 1.0, seed=8)
    lam = torch.from_numpy(llrs)
    pairs = [(1.2, 0.55), (0.5, 2.5), (5.0, 0.5)]     # the last: 8*0.5 <= 5
    alpha = torch.tensor([pairs[i % 3][0] for i in range(24)])
    mu = torch.tensor([pairs[i % 3][1] for i in range(24)])
    dec = QPADMMDecoder(small_h, max_iter=400, device=CPU)
    got = dec.decode_batch_params(lam, alpha, mu)
    for k, (a, m) in enumerate(pairs):
        one = QPADMMDecoder(small_h, alpha=a, mu=m, max_iter=400,
                            device=CPU).decode_batch(lam[k::3])
        assert torch.equal(got.bits[k::3], one.bits)
        assert torch.equal(got.success[k::3], one.success)
        assert torch.equal(got.iterations[k::3], one.iterations)
    assert not bool(got.success[2::3].any())
    assert not bool(got.bits[2::3].any())
    scalar = dec.decode_batch_params(lam, 0.5, 2.5)
    assert torch.equal(scalar.bits, QPADMMDecoder(
        small_h, alpha=0.5, mu=2.5, max_iter=400,
        device=CPU).decode_batch(lam).bits)
    want = jadmm.QPADMMDecoder(small_h, max_iter=400).decode_batch_params(
        jnp.asarray(llrs), jnp.float32(0.5), jnp.float32(2.5))
    _same(scalar.bits, want.bits)
    _same(scalar.iterations, want.iterations)


@pytest.mark.parametrize("name,alpha,mu", [("tiny", 100.0, 0.01),
                                           ("H02", 1.2, 0.55)])
def test_infeasible_batch_is_zero_and_fails(name, alpha, mu):
    """min(e) * mu <= alpha: the whole batch returns the all-zero word with
    success False (``qp_admm.h:108-114``), and the loop still runs, so the
    iteration counts equal JAX's. H02 has degree-2 rows (e_min = 2), so the
    defaults fail there by design."""
    h = _h(name)
    llrs, _ = _llrs(h, 4, 0.0, seed=2)
    dec = QPADMMDecoder(h, alpha=alpha, mu=mu, max_iter=40, device=CPU)
    assert not _feasible(dec.structure.e_min, alpha, mu)
    got = dec.decode_batch(torch.from_numpy(llrs))
    assert not bool(got.success.any()) and not bool(got.bits.any())
    want = jadmm.QPADMMDecoder(h, alpha=alpha, mu=mu,
                               max_iter=40).decode_batch(jnp.asarray(llrs))
    _same(got.bits, want.bits)
    _same(got.success, want.success)
    _same(got.iterations, want.iterations)
    st = dec.stream_chunk(dec.stream_init(torch.from_numpy(llrs)))
    fin = dec.stream_finish(st)
    assert not bool(fin.success.any()) and not bool(fin.bits.any())


def test_decodes_noiseless(small_h):
    g, _ = gf2_nullspace(small_h)
    rng = np.random.default_rng(2)
    cw = ((rng.integers(0, 2, (8, g.shape[0])) @ g) % 2).astype(np.uint8)
    llrs = torch.from_numpy((1.0 - 2.0 * cw.astype(np.float32)) * 8.0)
    res = QPADMMDecoder(small_h, max_iter=2000,
                        device=CPU).decode_batch(llrs)
    assert bool(res.success.all())
    np.testing.assert_array_equal(res.bits.numpy(), cw)


def test_stream_protocol_matches_jax_chunk_by_chunk(small_h):
    """``stream_init`` then chunks of 64 iterations (a lane stops at its own
    max_iter of 150): done, per-lane counts and bits equal JAX's
    ``stream_*`` after every chunk; the finished state equals the batched
    decode."""
    llrs, _ = _llrs(small_h, 16, 0.0, seed=6)
    jdec = jadmm.QPADMMDecoder(small_h, max_iter=150)
    jdec.stream_chunk_iters = 64
    dec = QPADMMDecoder(small_h, max_iter=150, device=CPU)
    dec.stream_chunk_iters = 64
    jst = jdec.stream_init(jnp.asarray(llrs))
    st = dec.stream_init(torch.from_numpy(llrs))
    for chunk in range(4):
        jst = jdec.stream_chunk(jst)
        st = dec.stream_chunk(st)
        _same(dec.stream_done(st), jdec.stream_done(jst), f"done {chunk}")
        _same(st["it"], jst["it"], f"it {chunk}")
        got, want = dec.stream_finish(st), jdec.stream_finish(jst)
        _same(got.bits, want.bits, f"bits {chunk}")
        _same(got.success, want.success, f"success {chunk}")
    assert bool(st["done"].all()) and int(st["it"].max()) == 150
    batched = dec.decode_batch(torch.from_numpy(llrs))
    assert torch.equal(batched.bits, got.bits)
    assert torch.equal(batched.iterations, got.iterations)


@pytest.mark.gpu
def test_card_equals_cpu():
    """optimalH at -3 dB, 64 lanes at the defaults (max_iter 2000 to keep
    it short): bits and success on the card equal the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    h = _h("optimalH")
    llrs = torch.from_numpy(_llrs(h, 64, -3.0, seed=4)[0])
    cpu = QPADMMDecoder(h, max_iter=2000, device=CPU).decode_batch(llrs)
    card = QPADMMDecoder(h, max_iter=2000, device=dev).decode_batch(
        llrs.to(dev))
    assert torch.equal(card.bits.cpu(), cpu.bits)
    assert torch.equal(card.success.cpu(), cpu.success)
    same_it = (card.iterations.cpu() == cpu.iterations).float().mean()
    assert same_it.item() >= 0.95
