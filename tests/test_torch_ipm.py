"""The batched IPM of the PyTorch port against the JAX package's
``ipm_box_lp(matvec_backend="xla", factor_backend="xla")`` and against the
exact HiGHS oracle, on ``tests/test_ipm.py``'s LP generator.

Bounds: both solvers step float32 Newton iterations that differ only in the
order of their sums, to the same tolerance, so the primal optimum (unique
for generic c) agrees to 1e-4 and the certificate to 1e-6. The duals of
these degenerate LPs are not unique, so they are held by the dual objective
(5e-4 relative) and by feasibility, not coordinate by coordinate. The port's
kernel/blocked backends (their twins on the CPU) are held to its own
xla/xla path with ``tests/test_ipm.py``'s 1e-3 objective bound. The CUDA
path is checked on the card (marked ``gpu``; ``python -m pytest
tests/test_torch_ipm.py -m gpu --noconftest``).
"""
import numpy as np
import pytest
import torch

from ldpc_tpu_torch.ops import chol_kernel, gemv_kernel
from ldpc_tpu_torch.ops.ipm_solver import ipm_box_lp

try:  # the card's host has no JAX or scipy; only the gpu cases run there
    import jax.numpy as jnp
    from scipy.optimize import linprog

    from ldpc_tpu.ops.ipm_solver import ipm_box_lp as jipm_box_lp
except ImportError:
    jnp = None


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rand_cut_lp(rng, n, r_active, r_cap, dense=False):
    """``tests/test_ipm.py``'s generator: one lane of signed ternary rows
    (odd-set-cut-like) with a feasible rhs."""
    a = np.zeros((r_cap, n), np.float32)
    b = np.zeros((r_cap,), np.float32)
    for i in range(r_active):
        supp = rng.choice(n, size=(n // 2 if dense else rng.integers(3, 9)),
                          replace=False)
        sgn = rng.choice([-1.0, 1.0], size=supp.size)
        if sgn.sum() <= -sgn.size:
            sgn[0] = 1.0
        a[i, supp] = sgn
        b[i] = np.sum(sgn > 0) - 1
    c = rng.normal(0.0, 4.0, n).astype(np.float32)
    return a, b, c


def _batch(seed, bsz=8, n=24, r_cap=32, dense=False, r_active=None):
    rng = np.random.default_rng(seed)
    lanes = [_rand_cut_lp(rng, n, r_active or rng.integers(4, 20), r_cap,
                          dense) for _ in range(bsz)]
    return tuple(np.stack(v) for v in zip(*lanes))     # a, b, c


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(v)) for v in arrays)


def _dual_obj(a, b, c, y):
    """max -b.y + sum(min(c + A^T y, 0)) per lane (the box LP's dual)."""
    rc = c + np.einsum("brn,br->bn", a, y)
    return -(b * y).sum(-1) + np.minimum(rc, 0.0).sum(-1)


@pytest.mark.parametrize("dense", [False, True])
def test_ipm_matches_jax_xla_and_highs(dense):
    a, b, c = _batch(7 + dense, dense=dense)
    x, y, err = ipm_box_lp(*_t(c, a, b), iters=40)
    jx, jy, jerr = jipm_box_lp(jnp.asarray(c), jnp.asarray(a),
                               jnp.asarray(b), iters=40,
                               matvec_backend="xla", factor_backend="xla")
    x, y, err = x.numpy(), y.numpy(), err.numpy()
    jx, jy, jerr = np.asarray(jx), np.asarray(jy), np.asarray(jerr)
    assert x.shape == (8, 24) and y.shape == (8, 32) and err.shape == (8,)
    np.testing.assert_allclose(x, jx, atol=1e-4)
    np.testing.assert_allclose(err, jerr, atol=1e-6)
    dual, jdual = _dual_obj(a, b, c, y), _dual_obj(a, b, c, jy)
    np.testing.assert_allclose(dual, jdual, rtol=5e-4, atol=5e-4)
    assert (y >= 0).all()
    for i in range(8):
        ref = linprog(c[i], A_ub=a[i], b_ub=b[i], bounds=(0, 1),
                      method="highs")
        assert ref.status == 0
        scale = 1.0 + abs(ref.fun)
        assert abs(float(c[i] @ x[i]) - ref.fun) / scale < 3e-4
        assert abs(dual[i] - ref.fun) / scale < 3e-4
        assert np.max(a[i] @ x[i] - b[i]) < 1e-4
        assert err[i] < 1e-3


def test_ipm_active_mask_zeroes_err():
    rng = np.random.default_rng(3)
    a1, b1, c1 = _rand_cut_lp(rng, 16, 10, 16)
    a, c = np.stack([a1, a1]), np.stack([c1, c1])
    b = np.stack([b1, np.zeros_like(b1)])              # lane 1: tighter rhs
    act = torch.tensor([True, False])
    x, _, err = ipm_box_lp(*_t(c, a, b), iters=30, active=act)
    jx, _, jerr = jipm_box_lp(jnp.asarray(c), jnp.asarray(a), jnp.asarray(b),
                              iters=30, active=jnp.asarray([True, False]))
    assert float(err[1]) == 0.0 == float(jerr[1])
    ref = linprog(c1, A_ub=a1, b_ub=b1, bounds=(0, 1), method="highs")
    assert abs(float(c1 @ x[0].numpy()) - ref.fun) / (1 + abs(ref.fun)) < 3e-4
    np.testing.assert_allclose(x[0].numpy(), np.asarray(jx)[0], atol=1e-4)


def test_ipm_box_only():
    """No active rows (the round-0 box LP): the optimum is the hard
    decision 1[c < 0]."""
    rng = np.random.default_rng(11)
    c = rng.normal(0.0, 5.0, (4, 20)).astype(np.float32)
    a = np.zeros((4, 8, 20), np.float32)
    b = np.zeros((4, 8), np.float32)
    x, _, err = ipm_box_lp(*_t(c, a, b), iters=30)
    jx, _, _ = jipm_box_lp(jnp.asarray(c), jnp.asarray(a), jnp.asarray(b),
                           iters=30)
    np.testing.assert_allclose(x.numpy(), (c < 0).astype(np.float32),
                               atol=1e-3)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), atol=1e-4)
    assert (err.numpy() < 1e-3).all()


def test_ipm_warm_start_matches_cold_and_jax():
    a, b, c = _batch(21, bsz=4, r_active=12)
    xc, yc, _ = ipm_box_lp(*_t(c, a, b), iters=40)
    x0 = (xc + 0.05).clamp(0.0, 1.0)
    xw, _, ew = ipm_box_lp(*_t(c, a, b), iters=40, x0=x0, y0=yc)
    jxw, _, _ = jipm_box_lp(jnp.asarray(c), jnp.asarray(a), jnp.asarray(b),
                            iters=40, x0=jnp.asarray(x0.numpy()),
                            y0=jnp.asarray(yc.numpy()))
    oc = (c * xc.numpy()).sum(1)
    ow = (c * xw.numpy()).sum(1)
    np.testing.assert_allclose(ow, oc, atol=1e-3)
    np.testing.assert_allclose(xw.numpy(), np.asarray(jxw), atol=1e-4)
    assert (ew.numpy() < 1e-3).all()


@pytest.mark.parametrize("matvec,factor", [("kernel", "xla"),
                                           ("xla", "blocked"),
                                           ("kernel", "blocked")])
def test_kernel_backends_match_xla_on_cpu(matvec, factor):
    """On a CPU tensor the kernel backends run the twins (no launch); the
    blocked factor pads n = 70 to 128. Same optimum as the xla/xla path."""
    a, b, c = _batch(33, bsz=4, n=70, r_cap=128, r_active=40)
    before = (gemv_kernel.GEMV_LAUNCHES, gemv_kernel.NORMAL_LAUNCHES,
              chol_kernel.LAUNCHES)
    xx, _, ex = ipm_box_lp(*_t(c, a, b), iters=40, matvec_backend="xla",
                           factor_backend="xla")
    xk, _, ek = ipm_box_lp(*_t(c, a, b), iters=40, matvec_backend=matvec,
                           factor_backend=factor)
    assert (gemv_kernel.GEMV_LAUNCHES, gemv_kernel.NORMAL_LAUNCHES,
            chol_kernel.LAUNCHES) == before
    ox, ok = (c * xx.numpy()).sum(1), (c * xk.numpy()).sum(1)
    np.testing.assert_allclose(ok, ox, atol=1e-3)
    assert (ek.numpy() < 1e-2).all() and (ex.numpy() < 1e-2).all()


def test_ipm_refuses_tf32_and_unknown_backends():
    a, b, c = _t(*_batch(1, bsz=2))
    prev = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        with pytest.raises(RuntimeError, match="full float32"):
            ipm_box_lp(c, a, b)
    finally:
        torch.set_float32_matmul_precision(prev)
    with pytest.raises(ValueError, match="matvec_backend"):
        ipm_box_lp(c, a, b, matvec_backend="pallas")
    with pytest.raises(ValueError, match="factor_backend"):
        ipm_box_lp(c, a, b, factor_backend="blocked-interpret")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_ipm_kernel_backends_on_card(cuda_device):
    """128 lanes at n = 280 on a strided row slice, as AGC-ALP solves:
    the kernel/blocked path against the plain xla/xla path on the card, and
    every kernel launched."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(9)
    lanes = [_rand_cut_lp(rng, 280, 200, 384) for _ in range(128)]
    a, b, c = (torch.from_numpy(np.stack(v)).to(cuda_device)
               for v in zip(*lanes))
    a_buf = torch.zeros((128, 512, 280), device=cuda_device)
    a_buf[:, :384] = a
    a_t = a_buf[:, :384]
    before = (gemv_kernel.GEMV_LAUNCHES, gemv_kernel.GEMV_T_LAUNCHES,
              gemv_kernel.NORMAL_LAUNCHES, chol_kernel.LAUNCHES)
    xk, _, ek = ipm_box_lp(c, a_t, b, iters=40, tol=1e-5)
    after = (gemv_kernel.GEMV_LAUNCHES, gemv_kernel.GEMV_T_LAUNCHES,
             gemv_kernel.NORMAL_LAUNCHES, chol_kernel.LAUNCHES)
    assert all(x > y for x, y in zip(after, before))
    xx, _, ex = ipm_box_lp(c, a_t, b, iters=40, tol=1e-5,
                           matvec_backend="xla", factor_backend="xla")
    ok, ox = (c * xk).sum(1), (c * xx).sum(1)
    assert float((ok - ox).abs().max()) <= 1e-3 * (1 + float(ox.abs().max()))
    assert bool((ek < 1e-2).all()) and bool((ex < 1e-2).all())
