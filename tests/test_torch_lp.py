"""Full LP of the PyTorch port against the JAX package.

``pdhg_box_lp_shared`` against JAX's on random small LPs (within 1e-5: the
two GEMM libraries sum in different orders), the dense cascade matrix equal
to JAX's exactly, and ``FullLPDecoder`` against JAX's on ``data/H.txt``
(300 iterations): x within 1e-5, and bits and success equal on every lane
whose coordinates all lie at least 1e-3 from 0.5 and from the integrality
tolerances (elsewhere a last-bit difference may decide). TF32 is refused.
The card is checked against the CPU in a ``gpu`` case (``python -m pytest
tests/test_torch_lp.py -m gpu --noconftest``).
"""
import os

import numpy as np
import pytest
import torch

from ldpc_tpu_torch.channel.awgn import llr_variance
from ldpc_tpu_torch.codes.gf2 import gf2_nullspace
from ldpc_tpu_torch.codes.io import read_pcm
from ldpc_tpu_torch.decoders import make_decoder
from ldpc_tpu_torch.decoders.admm import ADMMStructure
from ldpc_tpu_torch.decoders.lp import FullLPDecoder, cascade_matrix
from ldpc_tpu_torch.ops.lp_solver import pdhg_box_lp_shared

try:  # the card's host has no JAX; only the gpu cases run there
    import jax.numpy as jnp
    from ldpc_tpu.decoders.lp import FullLPDecoder as JFullLPDecoder
    from ldpc_tpu.ops.lp_solver import pdhg_box_lp_shared as jshared
except ImportError:
    jnp = None

DATA = os.path.join(os.path.dirname(__file__), "..", "data")
CPU = torch.device("cpu")
X_TOL = 1e-5        # |x - x_jax| after the iterations, float32 GEMM order
MARGIN = 1e-3       # distance from 0.5 and int_tol that makes bits certain


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _h(name):
    return read_pcm(os.path.join(DATA, f"{name}.txt"))


def _llrs(h, lanes, snr, seed):
    g, _ = gf2_nullspace(h)
    rng = np.random.default_rng(seed)
    cw = (rng.integers(0, 2, (lanes, g.shape[0])) @ g) % 2
    var = llr_variance(snr)
    y = 1.0 - 2.0 * cw + np.sqrt(var) * rng.standard_normal(cw.shape)
    return (2.0 * y / var).astype(np.float32), cw.astype(np.uint8)


def _certain(x, int_tol):
    """Lanes whose every coordinate is MARGIN away from each threshold."""
    dist = np.min(np.stack([np.abs(x - 0.5), np.abs(x - int_tol),
                            np.abs(x - (1.0 - int_tol))]), axis=0)
    return (dist >= MARGIN).all(axis=1)


@pytest.mark.parametrize("bsz,rows,n,iters", [(4, 12, 9, 50),
                                              (8, 40, 30, 300),
                                              (3, 64, 17, 120)])
def test_shared_pdhg_matches_jax(bsz, rows, n, iters):
    rng = np.random.default_rng(rows)
    a = rng.integers(-1, 2, (rows, n)).astype(np.float32)
    a[0] = 0.0                                   # an empty row: sigma 0
    b = rng.integers(0, 3, rows).astype(np.float32)
    c = rng.standard_normal((bsz, n)).astype(np.float32)
    x0 = (c < 0).astype(np.float32)
    y0 = np.zeros((bsz, rows), np.float32)
    jx, jy = jshared(*map(jnp.asarray, (c, a, b, x0, y0)), iters)
    x, y = pdhg_box_lp_shared(*map(torch.from_numpy, (c, a, b, x0, y0)),
                              iters)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=0, atol=X_TOL)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0,
                               atol=10 * X_TOL)
    assert x.dtype == torch.float32 and float(x.min()) >= 0.0


@pytest.mark.parametrize("name", ["H", "optimalH"])
def test_cascade_matrix_equals_jax(name):
    h = _h(name)
    a = cascade_matrix(ADMMStructure.from_h(h))
    want = np.asarray(JFullLPDecoder(h)._a)
    assert a.dtype == want.dtype and a.shape == want.shape
    np.testing.assert_array_equal(a, want)
    if name == "optimalH":
        assert a.shape == (2320, 700)


@pytest.mark.parametrize("snr", [1.0, 3.0])
def test_full_lp_matches_jax(snr, small_h):
    llrs, _ = _llrs(small_h, 32, snr, seed=int(20 + snr))
    jdec = JFullLPDecoder(small_h, iters=300)
    dec = FullLPDecoder(small_h, iters=300, device=CPU)
    want = jdec.decode_batch(jnp.asarray(llrs))
    got = dec.decode_batch(torch.from_numpy(llrs))
    s = jdec.structure
    c = np.concatenate([llrs, np.zeros((32, s.n_var - s.n), np.float32)], 1)
    jx, _ = jshared(jnp.asarray(c), jdec._a, jdec._b,
                    jnp.asarray((c < 0).astype(np.float32)),
                    jnp.zeros((32, s.n_con), jnp.float32), 300)
    x = dec.solve(torch.from_numpy(llrs)).numpy()
    np.testing.assert_allclose(x, np.asarray(jx), rtol=0, atol=X_TOL)
    sure = _certain(x[:, :s.n], dec.int_tol)
    assert sure.sum() >= 16
    np.testing.assert_array_equal(got.bits.numpy()[sure],
                                  np.asarray(want.bits)[sure])
    np.testing.assert_array_equal(got.success.numpy()[sure],
                                  np.asarray(want.success)[sure])
    assert (got.iterations == 300).all()


def test_registry_builds_full_lp(small_h):
    for kind in ("full-lp", "fulllp"):
        dec = make_decoder(kind, small_h, device=CPU)
        assert isinstance(dec, FullLPDecoder)
        assert dec.iters == 2000 and dec.int_tol == 3e-2


def test_tf32_is_refused(small_h, monkeypatch):
    dec = FullLPDecoder(small_h, iters=5, device=CPU)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="full float32"):
        dec.decode_batch(torch.ones((2, dec.n)))


@pytest.mark.gpu
def test_card_equals_cpu():
    """optimalH at -3 dB, 32 lanes, 2000 iterations: x within 1e-4 of the
    CPU's (GEMM sum order over 2000 steps), bits and success equal on the
    lanes clear of the thresholds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    h = _h("optimalH")
    llrs = torch.from_numpy(_llrs(h, 32, -3.0, seed=9)[0])
    cpu = FullLPDecoder(h, device=CPU)
    card = FullLPDecoder(h, device=dev)
    x = cpu.solve(llrs).numpy()
    xc = card.solve(llrs.to(dev)).cpu().numpy()
    np.testing.assert_allclose(xc, x, rtol=0, atol=1e-4)
    sure = torch.from_numpy(_certain(x[:, :card.n], card.int_tol)
                            & _certain(xc[:, :card.n], card.int_tol))
    a, b = cpu.decode_batch(llrs), card.decode_batch(llrs.to(dev))
    assert torch.equal(a.bits[sure], b.bits.cpu()[sure])
    assert torch.equal(a.success[sure], b.success.cpu()[sure])
