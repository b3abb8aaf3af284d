"""Blocked Cholesky of the PyTorch port against the JAX package's
(``ldpc_tpu/ops/pallas/chol_kernel.py`` in interpret mode) and against
``jnp.linalg.cholesky``/``cho_solve``, mirroring ``tests/test_chol.py``; the
diagonal-block twin against JAX's diagonal kernel; and the NaN rule: a lane
that is not SPD is NaN in that lane only, in both IPM factor paths.

Tolerances are ``tests/test_chol.py``'s (2e-4 of the factor's scale, 5e-3
on the solve), since both sides are float32 factorizations that differ only
in the order of their sums. The CUDA kernel is checked against its twin on
the card (marked ``gpu``; ``python -m pytest tests/test_torch_chol.py -m gpu
--noconftest``).
"""
import numpy as np
import pytest
import torch

from ldpc_tpu_torch.ops import chol_kernel
from ldpc_tpu_torch.ops.chol import blocked_cho_solve, blocked_cholesky
from ldpc_tpu_torch.ops.chol_kernel import chol_diag_inv
from ldpc_tpu_torch.ops.chol_ref import chol_diag_inv_ref, cholesky_nan

try:  # the card's host has no JAX; only the gpu cases run there
    import jax
    import jax.numpy as jnp
    from ldpc_tpu.ops.pallas import chol_kernel as jchol
except ImportError:
    jnp = None


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def spd(rng, b, n, cond_boost=0.0):
    """``tests/test_chol.py``'s SPD generator."""
    a = rng.normal(size=(b, n, n)).astype(np.float32)
    m = np.einsum("bij,bkj->bik", a, a) / n + np.eye(n, dtype=np.float32)
    if cond_boost:
        d = np.exp(rng.uniform(-cond_boost, cond_boost,
                               (b, n))).astype(np.float32)
        m = m * d[:, :, None] * d[:, None, :]
    return m


@pytest.mark.parametrize("n", [64, 100, 280])
def test_factor_matches_jax(n):
    rng = np.random.default_rng(0)
    m = spd(rng, 4, n)
    fac = blocked_cholesky(torch.from_numpy(m))
    assert fac.nb == 64 and fac.n == n and fac.l.shape[1] == -(-n // 64) * 64
    l_ours = fac.l.numpy()[:, :n, :n]
    l_ref = np.asarray(jnp.linalg.cholesky(jnp.asarray(m)))
    jfac = jchol.blocked_cholesky(jnp.asarray(m), interpret=True)
    scale = np.abs(l_ref).max()
    np.testing.assert_allclose(l_ours, l_ref, atol=2e-4 * scale, rtol=2e-4)
    np.testing.assert_allclose(l_ours, np.asarray(jfac.l)[:, :n, :n],
                               atol=2e-4 * scale, rtol=2e-4)
    np.testing.assert_allclose(fac.inv_diag.numpy(), np.asarray(jfac.inv_diag),
                               atol=2e-4 * np.abs(fac.inv_diag.numpy()).max(),
                               rtol=2e-4)
    assert np.all(np.triu(fac.l.numpy(), 1) == 0)


@pytest.mark.parametrize("n", [64, 100, 280])
def test_solve_matches_jax(n):
    rng = np.random.default_rng(1)
    m = spd(rng, 4, n)
    r = rng.normal(size=(4, n)).astype(np.float32)
    x = blocked_cho_solve(blocked_cholesky(torch.from_numpy(m)),
                          torch.from_numpy(r)).numpy()
    chol = jnp.linalg.cholesky(jnp.asarray(m))
    x_ref = np.asarray(jax.scipy.linalg.cho_solve(
        (chol, True), jnp.asarray(r)[..., None])[..., 0])
    jx = np.asarray(jchol.blocked_cho_solve(
        jchol.blocked_cholesky(jnp.asarray(m), interpret=True),
        jnp.asarray(r)))
    np.testing.assert_allclose(x, x_ref, atol=5e-3, rtol=5e-3)
    np.testing.assert_allclose(x, jx, atol=5e-3, rtol=5e-3)
    assert np.abs(np.einsum("bij,bj->bi", m, x) - r).max() < 1e-2
    # the plain factor path of the IPM: cholesky_ex + cholesky_solve
    l = cholesky_nan(torch.from_numpy(m))
    x_xla = torch.cholesky_solve(torch.from_numpy(r)[..., None], l)[..., 0]
    np.testing.assert_allclose(x_xla.numpy(), x_ref, atol=5e-3, rtol=5e-3)


def test_ill_conditioned_diag_spread():
    """An IPM-like diagonal spread (entries over ~e^{+-8}) still factors to
    a solve with a cho_solve-grade residual (``tests/test_chol.py``'s
    bound: at most 10x JAX's residual plus 1e-3)."""
    rng = np.random.default_rng(2)
    m = spd(rng, 4, 128, cond_boost=4.0)
    r = rng.normal(size=(4, 128)).astype(np.float32)
    x = blocked_cho_solve(blocked_cholesky(torch.from_numpy(m)),
                          torch.from_numpy(r)).numpy()
    chol = jnp.linalg.cholesky(jnp.asarray(m))
    x_ref = np.asarray(jax.scipy.linalg.cho_solve(
        (chol, True), jnp.asarray(r)[..., None])[..., 0])
    res = np.abs(np.einsum("bij,bj->bi", m, x) - r).max()
    res_ref = np.abs(np.einsum("bij,bj->bi", m, x_ref) - r).max()
    assert res <= 10 * res_ref + 1e-3


def test_diag_twin_matches_jax_kernel():
    """The diagonal-block twin against JAX's ``_chol_diag_inv`` (interpret
    mode): L and L^{-1}, lower triangular; rtol 2e-4 (float32)."""
    rng = np.random.default_rng(4)
    d = spd(rng, 6, 64)
    l, inv = chol_diag_inv_ref(torch.from_numpy(d))
    jl, jinv = jchol._chol_diag_inv(jnp.asarray(d), 64, interpret=True)
    np.testing.assert_allclose(l.numpy(), np.asarray(jl), rtol=2e-4,
                               atol=2e-4 * np.abs(l.numpy()).max())
    np.testing.assert_allclose(inv.numpy(), np.asarray(jinv), rtol=2e-4,
                               atol=2e-4 * np.abs(inv.numpy()).max())
    eye = np.broadcast_to(np.eye(64, dtype=np.float32), d.shape)
    np.testing.assert_allclose(np.einsum("bij,bjk->bik", inv.numpy(),
                                         l.numpy()), eye, atol=1e-4)
    before = chol_kernel.LAUNCHES
    l2, inv2 = chol_diag_inv(torch.from_numpy(d))  # the CPU runs the twin
    assert torch.equal(l2, l) and torch.equal(inv2, inv)
    assert chol_kernel.LAUNCHES == before


@pytest.mark.parametrize("path", ["blocked", "xla"])
def test_non_spd_lane_nans_only_that_lane(path):
    rng = np.random.default_rng(3)
    m = spd(rng, 4, 100)
    m[2] = -np.eye(100, dtype=np.float32)          # not SPD
    mt = torch.from_numpy(m)
    l = (blocked_cholesky(mt).l if path == "blocked" else cholesky_nan(mt))
    l = l.numpy()
    assert np.isnan(l[2]).any()
    for b in (0, 1, 3):
        assert np.isfinite(l[b]).all()
    if path == "xla":                  # jnp's rule: NaN lower triangle
        jl = np.asarray(jnp.linalg.cholesky(jnp.asarray(m)))
        np.testing.assert_array_equal(np.isnan(l[2]), np.isnan(jl[2]))
        assert np.isnan(np.tril(l[2])).sum() == 100 * 101 // 2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_kernel_matches_twin_on_card(cuda_device):
    """128 SPD 64x64 blocks and one that is not: L and L^{-1} within 1e-4
    of the twin's scale (float32, another order of operations and 1/sqrtf
    where cuSOLVER uses its own square root); NaN in the bad lane only."""
    rng = np.random.default_rng(5)
    d = spd(rng, 129, 64)
    d[77] = -np.eye(64, dtype=np.float32)
    dt = torch.from_numpy(d).to(cuda_device)
    before = chol_kernel.LAUNCHES
    l, inv = chol_diag_inv(dt)
    lr, invr = chol_diag_inv_ref(dt)
    torch.cuda.synchronize()
    assert chol_kernel.LAUNCHES == before + 1
    good = torch.ones(129, dtype=torch.bool, device=cuda_device)
    good[77] = False
    assert bool(torch.isnan(l[77]).any()) and bool(l[good].isfinite().all())
    assert bool(inv[good].isfinite().all())
    assert float((l - lr)[good].abs().max()) <= 1e-4 * float(lr[good].abs()
                                                              .max())
    assert float((inv - invr)[good].abs().max()) <= 1e-4 * float(
        invr[good].abs().max())
    fac = blocked_cholesky(torch.from_numpy(spd(rng, 128, 280)).to(
        cuda_device))
    assert fac.l.shape == (128, 320, 320)
