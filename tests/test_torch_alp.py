"""ALP decoder of the PyTorch port against the JAX package.

The cut search, the hashes, the appends and the tables must equal JAX's
exactly on the same numpy inputs. The whole decoder on ``data/H.txt`` (8
lanes, -1 dB) must give JAX's bits and success flags, the rule of
``tests/test_pallas_pdhg.py:93-95``, for the port's ``"xla"`` solver against
JAX's ``"xla"`` and for the port's ``"kernel"`` path (the twin on the CPU)
against JAX's ``"pallas-interpret"``; the ``"xla"`` pair must also agree on
rounds and dropped cuts. The certificate is held to the exact HiGHS oracle
of ``tests/test_alp.py``. The CUDA path is checked on the card (marked
``gpu``; ``python -m pytest tests/test_torch_alp.py -m gpu --noconftest``).
"""
import os

import numpy as np
import pytest
import torch

from ldpc_tpu_torch.channel.awgn import llr_variance
from ldpc_tpu_torch.codes.gf2 import gf2_nullspace
from ldpc_tpu_torch.codes.io import read_pcm
from ldpc_tpu_torch.decoders.alp import (ALPDecoder, alp_cut_candidates,
                                         alp_tables, append_cuts, cut_hashes)
from ldpc_tpu_torch.ops import pdhg_kernel

try:  # the card's host has no JAX; only the gpu cases run there
    import jax.numpy as jnp
    from ldpc_tpu.decoders import alp as jalp
except ImportError:
    jnp = None

DATA = os.path.join(os.path.dirname(__file__), "..", "data")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small tensors: one intra-op thread, so parallel test workers do not
    oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _h(name):
    return read_pcm(os.path.join(DATA, f"{name}.txt"))


def _llrs(h, lanes, snr, seed):
    """Codewords and channel LLRs (float32) made with numpy from a seed."""
    g, _ = gf2_nullspace(h)
    rng = np.random.default_rng(seed)
    cw = (rng.integers(0, 2, (lanes, g.shape[0])) @ g) % 2
    var = llr_variance(snr)
    y = 1.0 - 2.0 * cw + np.sqrt(var) * rng.standard_normal(cw.shape)
    return (2.0 * y / var).astype(np.float32), cw.astype(np.uint8)


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", ["tiny", "H", "optimalH", "H02"])
def test_tables_capacity_and_tiers_match_jax(name, tiny_h):
    h = tiny_h if name == "tiny" else _h(name)
    jdec = jalp.ALPDecoder(h, lp_backend="xla")
    dec = ALPDecoder(h)
    pert_dir, w1, w2 = alp_tables(h.shape[1])
    np.testing.assert_array_equal(pert_dir, np.asarray(jdec._pert_dir))
    np.testing.assert_array_equal(w1, np.asarray(jdec._hash_w[0]))
    np.testing.assert_array_equal(w2, np.asarray(jdec._hash_w[1]))
    assert w1.dtype == np.int32 and pert_dir.dtype == np.float32
    _eq(dec.pert_dir, jdec._pert_dir)
    _eq(dec.hash_w1, jdec._hash_w[0])
    assert dec.capacity == jdec.capacity and dec._tiers == jdec._tiers
    assert (dec.max_rows, dec.lp_max_iters, dec.lp_tol, dec.stall_ratio) == \
        (jdec.max_rows, jdec.lp_max_iters, jdec.lp_tol, jdec.stall_ratio)
    assert dec.lp_backend == "xla" and dec.prefer_streaming is False


@pytest.mark.parametrize("name,per_lane", [("H", False), ("optimalH", False),
                                           ("H", True)])
def test_cut_candidates_match_jax(name, per_lane):
    h = _h(name)
    rng = np.random.default_rng(len(name))
    u = rng.uniform(0, 1, (4, h.shape[1])).astype(np.float32)
    u[1] = np.round(u[1])                          # an integral lane
    u[2] = np.where(rng.random(h.shape[1]) < 0.8, np.round(u[2]), u[2])
    u[3, :7] = 0.5                                 # ties on the distance
    sup = h.astype(bool)
    if per_lane:                                   # per-lane support masks
        sup = np.stack([np.roll(sup, k, axis=1) for k in range(4)])
    rows, rhs, add = alp_cut_candidates(torch.from_numpy(sup),
                                        torch.from_numpy(u), 1e-3)
    jrows, jrhs, jadd = jalp.alp_cut_candidates(jnp.asarray(sup),
                                                jnp.asarray(u), 1e-3)
    _eq(rows, jrows)
    _eq(rhs, jrhs)
    _eq(add, jadd)
    assert rows.dtype == torch.float32 and add.any() and not add.all()


def test_cut_hashes_wrap_like_int32():
    """Weights near +-2**31: the exact sums overflow int32 and must wrap to
    JAX's int32 einsum result."""
    rng = np.random.default_rng(5)
    n = 64
    w1 = np.full(n, 2**31 - 1, np.int64)
    w1[::2] = -2**31
    w1 = (w1 - rng.integers(0, 3, n)).clip(-2**31, 2**31 - 1).astype(np.int32)
    w2 = rng.integers(-2**31, 2**31 - 1, n, dtype=np.int64).astype(np.int32)
    rows = rng.integers(-1, 2, (3, 20, n)).astype(np.float32)
    rows[0, 0] = 1.0
    rows[0, 1, ::2] = 0.0                          # all +1 on the 2**31-1s
    h1, h2 = cut_hashes(torch.from_numpy(rows), torch.from_numpy(w1),
                        torch.from_numpy(w2))
    j1, j2 = jalp.cut_hashes(jnp.asarray(rows), jnp.asarray(w1),
                             jnp.asarray(w2))
    _eq(h1, j1)
    _eq(h2, j2)
    exact = rows.astype(np.int64) @ w1.astype(np.int64)
    assert np.abs(exact).max() > 2**31                 # it did overflow
    wrapped = ((exact + 2**31) % 2**32 - 2**31).astype(np.int32)
    np.testing.assert_array_equal(h1.numpy(), wrapped)
    assert h1.dtype == torch.int32


@pytest.mark.parametrize("hashed", [False, True])
def test_append_cuts_matches_jax(hashed):
    """Dedupe against active cuts, overflow past the capacity, counts."""
    rng = np.random.default_rng(3)
    bsz, cap, m, n = 4, 24, 10, 16
    a_buf = np.zeros((bsz, cap, n), np.float32)
    rhs_buf = np.zeros((bsz, cap), np.float32)
    count = np.array([0, 5, 18, 24], np.int32)     # lane 2 overflows
    for b in range(bsz):
        a_buf[b, :count[b]] = rng.integers(-1, 2, (count[b], n))
        rhs_buf[b, :count[b]] = rng.integers(0, 4, count[b])
    rows = rng.integers(-1, 2, (bsz, m, n)).astype(np.float32)
    rows[1, 2] = a_buf[1, 3]                       # a duplicate of a cut
    rows[2, 0] = a_buf[2, 17]
    rhs = rng.integers(0, 4, (bsz, m)).astype(np.float32)
    add = rng.random((bsz, m)) < 0.7
    add[1, 2] = True
    add[2] = True
    w1, w2 = (np.array(w) for w in jalp._hash_weights(n))
    h_buf = [np.asarray(x) for x in jalp.cut_hashes(jnp.asarray(a_buf),
                                                    jnp.asarray(w1),
                                                    jnp.asarray(w2))]
    h_buf = [np.where(np.arange(cap) < count[:, None], x, 0).astype(np.int32)
             for x in h_buf]
    cand = jalp.cut_hashes(jnp.asarray(rows), jnp.asarray(w1),
                           jnp.asarray(w2))
    jkw = ({} if not hashed else
           dict(hash_state=tuple(jnp.asarray(x) for x in h_buf),
                cand_hashes=cand))
    want = jalp.append_cuts(jnp.asarray(a_buf), jnp.asarray(rhs_buf),
                            jnp.asarray(count), jnp.asarray(rows),
                            jnp.asarray(rhs), jnp.asarray(add), **jkw)
    tkw = ({} if not hashed else
           dict(hash_state=tuple(torch.from_numpy(x.copy()) for x in h_buf),
                cand_hashes=cut_hashes(torch.from_numpy(rows),
                                       torch.from_numpy(w1),
                                       torch.from_numpy(w2))))
    got = append_cuts(torch.from_numpy(a_buf.copy()),
                      torch.from_numpy(rhs_buf.copy()),
                      torch.from_numpy(count), torch.from_numpy(rows),
                      torch.from_numpy(rhs), torch.from_numpy(add), **tkw)
    for g, w in zip(got[:6], want[:6]):
        _eq(g, w)
        assert g.dtype == torch.float32 or g.dtype == torch.int32
    if hashed:
        _eq(got[6][0], want[6][0])
        _eq(got[6][1], want[6][1])
        assert got[4][1] == 1 and got[4][2] == 1   # the two duplicates
    # drops past the capacity, and a full lane takes nothing
    assert got[5][2] > 0 and got[2][2] == got[2][3] == cap
    assert got[3][3] == 0 and got[5][3] == add[3].sum() - int(got[4][3])


def _whole_decoder(backend, jbackend, seed):
    h = _h("H")
    llrs, _ = _llrs(h, 8, -1.0, seed=seed)
    kw = dict(max_rounds=8, lp_iters=200, max_rows=96)
    want = jalp.ALPDecoder(h, lp_backend=jbackend, **kw).decode_batch(
        jnp.asarray(llrs))
    got = ALPDecoder(h, lp_backend=backend, **kw).decode_batch(
        torch.from_numpy(llrs))
    return got, want


@pytest.mark.parametrize("seed", [0, 4])
def test_whole_decoder_xla_matches_jax_xla(seed):
    got, want = _whole_decoder("xla", "xla", seed)
    _eq(got.bits, want.bits)
    _eq(got.success, want.success)
    _eq(got.iterations, want.iterations)
    _eq(got.dropped, want.dropped)
    assert 0 < int(got.success.sum()) < 8        # both outcomes occur


def test_whole_decoder_kernel_path_matches_jax_pallas_interpret():
    before = pdhg_kernel.LAUNCHES
    got, want = _whole_decoder("kernel", "pallas-interpret", 1)
    _eq(got.bits, want.bits)
    _eq(got.success, want.success)
    assert pdhg_kernel.LAUNCHES == before        # the CPU runs the twin


@pytest.mark.parametrize("snr", [3.0, 1.0])
def test_alp_matches_exact_oracle(tiny_h, snr):
    """>= 22 of 24 certificate agreements with an exact HiGHS ALP, and equal
    bits where both certify (``tests/test_alp.py:91-107``)."""
    from test_alp import scalar_alp
    llrs, _ = _llrs(tiny_h, 24, snr, seed=int(snr) + 40)
    dec = ALPDecoder(tiny_h, lp_iters=2000, max_rounds=30, int_tol=2e-2)
    res = dec.decode_batch(torch.from_numpy(llrs))
    agree = 0
    for t in range(24):
        bits, ok = scalar_alp(tiny_h, llrs[t].astype(np.float64))
        if ok == bool(res.success[t]):
            agree += 1
            if ok:
                np.testing.assert_array_equal(res.bits[t].numpy(), bits)
    assert agree >= 22, f"only {agree}/24 certificate agreements"


def test_noiseless_and_stats(small_h):
    llrs, cw = _llrs(small_h, 8, 0.0, seed=2)
    clean = np.where(cw == 0, 6.0, -6.0).astype(np.float32)
    dec = ALPDecoder(small_h, lp_iters=800)
    res = dec.decode_batch(torch.from_numpy(clean))
    assert bool(res.success.all()) and (res.iterations == 1).all()
    np.testing.assert_array_equal(res.bits.numpy(), cw)
    assert res.dropped.dtype == torch.int32 and int(res.dropped.sum()) == 0
    st = dec.stats(torch.from_numpy(llrs))
    assert set(st) == {"count", "rounds", "integral", "done", "viol",
                       "dropped", "cum_h", "cum_g"}
    assert bool(st["done"].all()) and (st["count"] == st["cum_h"]).all()


def test_unported_options_raise(small_h):
    """The IPM backend is ported (its cut threshold is checked against
    ipm_tol); plain ALP has no Gaussian cut source; unknown backends, a
    threshold under the solver's tolerance and a foreign device raise."""
    assert ALPDecoder(small_h, lp_backend="ipm").lp_backend == "ipm"
    with pytest.raises(ValueError, match="lp_backend"):
        ALPDecoder(small_h, lp_backend="pallas")
    with pytest.raises(ValueError, match="cut_tol"):
        ALPDecoder(small_h, cut_tol=1e-4)
    with pytest.raises(ValueError, match="cut_tol"):
        ALPDecoder(small_h, lp_backend="ipm", cut_tol=1e-5)
    with pytest.raises(NotImplementedError, match="Gaussian"):
        ALPDecoder(small_h)._gauss_sup(None)
    with pytest.raises(ValueError, match="decoder on"):
        ALPDecoder(small_h).decode_batch(torch.zeros(2, 128, device="meta"))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_alp_on_card_kernel_vs_xla(cuda_device):
    h = _h("optimalH")
    llrs, cw = _llrs(h, 64, -2.0, seed=8)
    lam = torch.from_numpy(llrs).to(cuda_device)
    dec = ALPDecoder(h, device=cuda_device)
    assert dec.lp_backend == "kernel"
    before = pdhg_kernel.LAUNCHES
    res = dec.decode_batch(lam)
    assert pdhg_kernel.LAUNCHES > before
    ref = ALPDecoder(h, lp_backend="xla", device=cuda_device).decode_batch(
        lam)
    same = res.success == ref.success
    assert same.float().mean().item() >= 0.95
    both = res.success & ref.success
    assert torch.equal(res.bits[both], ref.bits[both])
    cpu = ALPDecoder(h, lp_backend="xla").decode_batch(torch.from_numpy(
        llrs))
    assert (cpu.success == ref.success.cpu()).float().mean().item() >= 0.95
