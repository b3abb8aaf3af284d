"""The IPM's matvec and normal-matrix twins of the PyTorch port against the
JAX package's ``"xla"`` einsums at HIGHEST precision.

Inputs are signed cut rows (+-1/0) made with numpy from a seed, and Newton
weights d spanning 1e-8...1e8 as late in a solve. With such rows every
product is exact in float32 (+-d or 0): only the order of the sums differs,
so the bound is the float32 summation bound ``T * 2**-23 * sum |terms|``
per entry. ``normal_build`` is held to the einsum, not to JAX's
``"pallas-interpret"`` path, which drops two of its three bf16 planes of d.
The CUDA kernels are checked against the twins on the card (marked ``gpu``;
``python -m pytest tests/test_torch_gemv.py -m gpu --noconftest``).
"""
import numpy as np
import pytest
import torch

from ldpc_tpu_torch.ops import gemv_kernel
from ldpc_tpu_torch.ops.gemv_kernel import (batched_gemv, batched_gemv_t,
                                            normal_build)
from ldpc_tpu_torch.ops.gemv_ref import gemv_ref, gemv_t_ref, normal_ref

try:  # the card's host has no JAX; only the gpu cases run there
    import jax
    import jax.numpy as jnp
except ImportError:
    jnp = None

EPS32 = 2.0 ** -23
DELTA = 1e-6


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small tensors: one intra-op thread, so parallel test workers do not
    oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(bsz, cap, t, n, seed):
    """A (bsz, cap, n) cut buffer of +-1/0 rows (rows past 3t/4 zero, as a
    partly filled buffer), x in [0, 1], y >= 0, d over 1e-8..1e8 and
    dxx > 0, all float32."""
    rng = np.random.default_rng(seed)
    a = rng.integers(-1, 2, (bsz, cap, n)).astype(np.float32)
    a[:, 3 * t // 4:] = 0.0
    x = rng.uniform(size=(bsz, n)).astype(np.float32)
    y = np.abs(rng.normal(size=(bsz, t))).astype(np.float32)
    d = (10.0 ** rng.uniform(-8, 8, (bsz, t))).astype(np.float32)
    dxx = (10.0 ** rng.uniform(-4, 4, (bsz, n))).astype(np.float32)
    return a, x, y, d, dxx


def _jax_einsums(a, x, y, d, dxx):
    hi = jax.lax.Precision.HIGHEST
    f32 = jnp.float32
    a, x, y, d, dxx = map(jnp.asarray, (a, x, y, d, dxx))
    ax = jnp.einsum("brn,bn->br", a, x, precision=hi,
                    preferred_element_type=f32)
    aty = jnp.einsum("brn,br->bn", a, y, precision=hi,
                     preferred_element_type=f32)
    m = jnp.einsum("bri,br,brj->bij", a, d, a, precision=hi,
                   preferred_element_type=f32)
    m = m + jax.vmap(jnp.diag)(dxx) + DELTA * jnp.eye(a.shape[-1])[None]
    return np.asarray(ax), np.asarray(aty), np.asarray(m)


@pytest.mark.parametrize("bsz,cap,t,n", [(4, 128, 128, 280), (8, 256, 256, 84),
                                         (2, 384, 384, 96),
                                         (3, 512, 256, 280)])
def test_twins_match_jax_highest_einsums(bsz, cap, t, n):
    """The last case solves on a row slice a_buf[:, :T] of a larger
    buffer, as the decoder does."""
    a_buf, x, y, d, dxx = _inputs(bsz, cap, t, n, seed=t + n)
    a_np = a_buf[:, :t]
    want_ax, want_aty, want_m = _jax_einsums(a_np, x, y, d, dxx)
    a = torch.from_numpy(a_buf)[:, :t]
    assert a.stride(0) == cap * n                  # the strided slice
    got_ax = gemv_ref(a, torch.from_numpy(x))
    got_aty = gemv_t_ref(a, torch.from_numpy(y))
    got_m = normal_ref(a, torch.from_numpy(d), torch.from_numpy(dxx), DELTA)
    assert got_ax.shape == (bsz, t) and got_aty.shape == (bsz, n)
    assert got_m.shape == (bsz, n, n) and got_m.dtype == torch.float32
    abs_a = np.abs(a_np)
    bound_ax = t * EPS32 * np.einsum("brn,bn->br", abs_a, np.abs(x))
    bound_aty = t * EPS32 * np.einsum("brn,br->bn", abs_a, y)
    bound_m = t * EPS32 * (np.einsum("bri,br,brj->bij", abs_a, d, abs_a)
                           + dxx[:, :, None] * np.eye(n) + DELTA)
    assert (np.abs(got_ax.numpy() - want_ax) <= bound_ax + 1e-30).all()
    assert (np.abs(got_aty.numpy() - want_aty) <= bound_aty + 1e-30).all()
    assert (np.abs(got_m.numpy() - want_m) <= bound_m + 1e-30).all()
    # symmetric, with the diagonal added once
    np.testing.assert_array_equal(got_m.numpy(),
                                  got_m.transpose(1, 2).numpy())


def test_wrappers_run_the_twins_on_cpu():
    a_buf, x, y, d, dxx = _inputs(2, 256, 128, 40, seed=1)
    a = torch.from_numpy(a_buf)[:, :128]
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    dt, dxxt = torch.from_numpy(d), torch.from_numpy(dxx)
    before = (gemv_kernel.GEMV_LAUNCHES, gemv_kernel.GEMV_T_LAUNCHES,
              gemv_kernel.NORMAL_LAUNCHES)
    assert torch.equal(batched_gemv(a, xt), gemv_ref(a, xt))
    assert torch.equal(batched_gemv_t(a, yt), gemv_t_ref(a, yt))
    assert torch.equal(normal_build(a, dt, dxxt, DELTA),
                       normal_ref(a, dt, dxxt, DELTA))
    assert (gemv_kernel.GEMV_LAUNCHES, gemv_kernel.GEMV_T_LAUNCHES,
            gemv_kernel.NORMAL_LAUNCHES) == before
    meta = torch.zeros((2, 8, 4), device="meta")
    for fn, args in ((batched_gemv, (meta, meta[:, 0])),
                     (batched_gemv_t, (meta, meta[..., 0])),
                     (normal_build, (meta, meta[..., 0], meta[:, 0], DELTA))):
        with pytest.raises(ValueError, match="no implementation"):
            fn(*args)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("t", [128, 1408])
def test_kernels_match_twins_on_card(cuda_device, t):
    """AGC-ALP's shapes: 128 lanes, n = 280, a row slice of the
    (128, 1408, 280) buffer. Same bound as the CPU case: exact products,
    float32 sums in another order."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cap, n = 1408, 280
    a_buf, x, y, d, dxx = _inputs(128, cap, t, n, seed=t)
    a = torch.from_numpy(a_buf).to(cuda_device)[:, :t]
    xt, yt, dt, dxxt = (torch.from_numpy(v).to(cuda_device)
                        for v in (x, y, d, dxx))
    before = gemv_kernel.GEMV_LAUNCHES
    got = (batched_gemv(a, xt), batched_gemv_t(a, yt),
           normal_build(a, dt, dxxt, DELTA))
    want = (gemv_ref(a, xt), gemv_t_ref(a, yt),
            normal_ref(a, dt, dxxt, DELTA))
    torch.cuda.synchronize()
    assert gemv_kernel.GEMV_LAUNCHES == before + 1
    abs_a = a.abs()
    bounds = (t * EPS32 * gemv_ref(abs_a, xt.abs()),
              t * EPS32 * gemv_t_ref(abs_a, yt),
              t * EPS32 * (normal_ref(abs_a, dt, dxxt, DELTA)))
    for g, w, b in zip(got, want, bounds):
        assert g.shape == w.shape
        assert bool(((g - w).abs() <= b + 1e-30).all())
    assert torch.equal(got[2], got[2].transpose(1, 2))
