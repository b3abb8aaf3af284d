"""BPSK-AWGN channel of the PyTorch port: closed forms against the JAX
package, trial-keyed noise, noise moments."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_tpu.channel import awgn as jawgn
from ldpc_tpu_torch.channel import awgn

SNRS = [-5.0, -4.5, -4.0, -3.5, -3.0, -2.5, -2.0, -1.5, -1.0, -0.5, 0.0,
        1.0, 2.0, 3.0]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small tensors: one intra-op thread, so parallel test workers do not
    oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("snr", SNRS)
def test_closed_forms_match_jax(snr):
    # llr_variance is float32 on both sides: bit-identical
    assert awgn.llr_variance(snr) == float(jawgn.llr_variance(snr))
    rng = np.random.default_rng(1)
    y = rng.normal(1.0, 1.0, (8, 40)).astype(np.float32)
    np.testing.assert_array_equal(awgn.llr(torch.from_numpy(y), snr).numpy(),
                                  np.asarray(jawgn.llr(jnp.asarray(y), snr)))


def test_bpsk_matches_jax():
    bits = np.random.default_rng(2).integers(0, 2, (4, 33)).astype(np.uint8)
    np.testing.assert_array_equal(awgn.bpsk(torch.from_numpy(bits)).numpy(),
                                  np.asarray(jawgn.bpsk(bits)))


def test_noise_independent_of_batching():
    trials = torch.arange(64)
    whole = awgn.awgn_noise(5, trials, 280)
    parts = torch.cat([awgn.awgn_noise(5, trials[s:s + 16], 280)
                       for s in range(0, 64, 16)])
    torch.testing.assert_close(whole, parts, rtol=0, atol=0)
    # and one trial drawn alone, out of order, equals its row
    torch.testing.assert_close(awgn.awgn_noise(5, trials[37:38], 280),
                               whole[37:38], rtol=0, atol=0)
    assert not torch.equal(whole, awgn.awgn_noise(6, trials, 280))


def test_noise_moments():
    z = awgn.awgn_noise(239, torch.arange(2048), 281).double()
    count = z.numel()
    assert z.dtype == torch.float64 and torch.isfinite(z).all()
    # mean and variance within 5 standard errors of N(0, 1)
    assert abs(z.mean().item()) < 5.0 / math.sqrt(count)
    assert abs(z.var().item() - 1.0) < 5.0 * math.sqrt(2.0 / count)
    # neighbouring bits and neighbouring trials uncorrelated
    for a, b in ((z[:, :-1], z[:, 1:]), (z[:-1], z[1:])):
        corr = (a * b).mean().item()
        assert abs(corr) < 5.0 / math.sqrt(a.numel())


def test_transmit_and_codewords():
    g = np.array([[1, 0, 1, 1], [0, 1, 0, 1]], dtype=np.uint8)
    gen = torch.Generator().manual_seed(3)
    cw = awgn.gen_random_codewords(g, 64, gen, "cpu")
    assert cw.dtype == torch.uint8 and cw.shape == (64, 4)
    coeffs_ok = {tuple(r) for r in ((np.array(c) @ g) % 2 for c in
                                    ((0, 0), (0, 1), (1, 0), (1, 1)))}
    assert {tuple(r) for r in cw.tolist()} <= coeffs_ok
    trials = torch.arange(64)
    y, lam = awgn.channel_llr(cw, 0.0, 9, trials)
    sigma = math.sqrt(awgn.llr_variance(0.0))
    torch.testing.assert_close(
        y, awgn.bpsk(cw) + sigma * awgn.awgn_noise(9, trials, 4))
    torch.testing.assert_close(lam, awgn.llr(y, 0.0), rtol=0, atol=0)
