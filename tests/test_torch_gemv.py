"""The IPM's matvec and normal-matrix twins of the PyTorch port against the
JAX package's ``"xla"`` einsums at HIGHEST precision.

Inputs are signed cut rows (+-1/0) made with numpy from a seed, and Newton
weights d spanning 1e-8...1e8 as late in a solve. With such rows every
product is exact in float32 (+-d or 0): only the order of the sums differs,
so the bound is a float32 summation bound ``k * 2**-23 * sum |terms|`` per
entry (k = T against JAX; on the card k is the length of each sum, n for
A x and T for A^T y and the normal matrix). ``normal_build`` is held to the
einsum, not to JAX's ``"pallas-interpret"`` path, which drops two of its
three bf16 planes of d. The kernels read the int8 copy ``pack_rows``
makes; their plain version is the twin on the unpacked copy, equal to the
float32 slice bit for bit. The normal-matrix kernel splits d into three
bf16 planes; ``split_planes`` and ``normal_split_ref`` repeat that
arithmetic, and the tests show here that the split is exact. The CUDA kernels are checked against the twins
on the card (marked ``gpu``; ``python -m pytest tests/test_torch_gemv.py -m
gpu --noconftest``).
"""
import numpy as np
import pytest
import torch

from ldpc_tpu_torch.ops import gemv_kernel
from ldpc_tpu_torch.ops.gemv_kernel import (batched_gemv, batched_gemv_t,
                                            normal_build, pack_rows)
from ldpc_tpu_torch.ops.gemv_ref import (gemv_ref, gemv_t_ref, normal_ref,
                                         normal_split_ref, split_planes,
                                         unpack_rows)

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
    a8, ok = pack_rows(a)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    dt, dxxt = torch.from_numpy(d), torch.from_numpy(dxx)
    before = (gemv_kernel.GEMV_LAUNCHES, gemv_kernel.GEMV_T_LAUNCHES,
              gemv_kernel.NORMAL_LAUNCHES)
    assert bool(ok)
    assert torch.equal(batched_gemv(a8, xt), gemv_ref(a, xt))
    assert torch.equal(batched_gemv_t(a8, yt, 40), gemv_t_ref(a, yt))
    assert torch.equal(normal_build(a8, dt, dxxt, DELTA, 40),
                       normal_ref(a, dt, dxxt, DELTA))
    assert (gemv_kernel.GEMV_LAUNCHES, gemv_kernel.GEMV_T_LAUNCHES,
            gemv_kernel.NORMAL_LAUNCHES) == before
    meta = torch.zeros((2, 8, 4), device="meta")
    for fn, args in ((batched_gemv, (meta, meta[:, 0])),
                     (batched_gemv_t, (meta, meta[..., 0], 4)),
                     (normal_build, (meta, meta[..., 0], meta[:, 0], DELTA,
                                     4))):
        with pytest.raises(ValueError, match="no implementation"):
            fn(*args)


@pytest.mark.parametrize("n", [128, 280, 283, 640])
def test_pack_rows_is_exact_and_padded(n):
    """A lane-strided row slice of +-1/0 rows: the copy is contiguous int8
    with n rounded up to 16 columns, equal to the slice on its first n
    columns and zero on the pad, and flagged exact."""
    a_buf, *_ = _inputs(3, 200, 160, n, seed=n)
    a = torch.from_numpy(a_buf)[:, :160]
    assert not a.is_contiguous()
    a8, ok = pack_rows(a)
    n_pad = -(-n // 16) * 16
    assert a8.dtype == torch.int8 and a8.shape == (3, 160, n_pad)
    assert a8.is_contiguous() and ok.dim() == 0 and bool(ok)
    assert torch.equal(a8[..., :n].to(torch.float32), a)
    assert not bool(a8[..., n:].any())
    assert torch.equal(unpack_rows(a8, n), a)


@pytest.mark.parametrize("n", [128, 280, 283, 640])
def test_twins_on_the_packed_copy_equal_f32_bmm(n):
    """Bit for bit: the plain versions of the kernels (the twins on the
    unpacked copy, which the wrappers run on the CPU) see the same float32
    values and call the same bmm. The wrappers take only the packed copy."""
    a_buf, x, y, *_ = _inputs(3, 200, 160, n, seed=2 * n)
    a = torch.from_numpy(a_buf)[:, :160]
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    a8, _ = pack_rows(a)
    want_ax = torch.bmm(a, xt[..., None])[..., 0]
    want_aty = torch.bmm(yt[:, None], a)[:, 0]
    assert torch.equal(gemv_ref(unpack_rows(a8, n), xt), want_ax)
    assert torch.equal(gemv_t_ref(unpack_rows(a8, n), yt), want_aty)
    assert torch.equal(batched_gemv(a8, xt), want_ax)
    assert torch.equal(batched_gemv_t(a8, yt, n), want_aty)
    with pytest.raises(TypeError, match="int8 copy"):
        batched_gemv(a.contiguous(), xt)


@pytest.mark.parametrize("bad", [0.5, 2.0, -2.0, float("nan")])
def test_pack_rows_flags_entries_outside_the_set(bad):
    a = torch.zeros((2, 5, 30))
    a[1, 3, 7] = bad
    assert not bool(pack_rows(a)[1])
    a[1, 3, 7] = -1.0
    assert bool(pack_rows(a)[1])


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_split_planes_sum_back_exactly(seed):
    """d over the IPM's clamp range 1e-10...1e10, log-uniform with random
    mantissas, plus the clamp's two ends and values one ulp off powers of
    two: the three bf16 planes, added in float64, give d exactly, and each
    plane is what the one before left over."""
    rng = np.random.default_rng(seed)
    d = (10.0 ** rng.uniform(-10, 10, 200_000)).astype(np.float32)
    pow2 = (2.0 ** rng.integers(-33, 34, 64)).astype(np.float32)
    d = np.concatenate([d, pow2, np.nextafter(pow2, np.float32(0)),
                        np.nextafter(pow2, np.float32(np.inf)),
                        np.float32([1e-10, 1e10])]).clip(1e-10, 1e10)
    dt = torch.from_numpy(d)
    hi, mid, lo = split_planes(dt)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    total = hi.double() + mid.double() + lo.double()
    assert torch.equal(total, dt.double())
    assert torch.equal(hi.float() + (mid.float() + lo.float()), dt)
    # each plane holds at most 8 of the 24 bits: the leftovers shrink
    assert bool((mid.float().abs() <= hi.float().abs() * 2.0 ** -8).all())
    assert bool((lo.float().abs() <= hi.float().abs() * 2.0 ** -16).all())


@pytest.mark.parametrize("bsz,cap,t,n", [(4, 128, 128, 280), (2, 384, 384, 96),
                                         (3, 512, 256, 283), (1, 70, 63, 40)])
def test_split_twin_within_summation_bound(bsz, cap, t, n):
    """The kernel's arithmetic (three exact planes, float32 sums) against
    normal_ref: exact products on both sides, so within the float32
    summation bound T * 2**-23 * normal_ref(|a|, d, dxx) per entry; and
    with d of a single plane (powers of two) the two are equal bit for
    bit."""
    a_buf, _, _, d, dxx = _inputs(bsz, cap, t, n, seed=7 * t + n)
    a = torch.from_numpy(a_buf)[:, :t]
    dt, dxxt = torch.from_numpy(d), torch.from_numpy(dxx)
    got = normal_split_ref(a, dt, dxxt, DELTA)
    want = normal_ref(a, dt, dxxt, DELTA)
    bound = t * EPS32 * normal_ref(a.abs(), dt, dxxt, DELTA)
    assert got.shape == want.shape == (bsz, n, n)
    assert bool(((got - want).abs() <= bound + 1e-30).all())
    assert torch.equal(got, got.transpose(1, 2))
    d2 = torch.exp2(torch.floor(torch.log2(dt)))
    assert torch.equal(normal_split_ref(a, d2, dxxt, DELTA),
                       normal_ref(a, d2, dxxt, DELTA))


@pytest.mark.parametrize("bsz,cap,t,n", [(4, 128, 128, 280), (8, 256, 256, 84),
                                         (3, 512, 256, 280), (3, 70, 63, 283)])
def test_normal_build_on_the_packed_copy_equals_normal_ref_and_jax(bsz, cap, t,
                                                                   n):
    """On the CPU the wrapper runs normal_ref on the unpacked copy: the same
    bits as normal_ref on the float32 slice, and within the bound of
    test_twins_match_jax_highest_einsums of the normal matrix the JAX
    package builds with matvec_backend="xla" (its HIGHEST einsum,
    ldpc_tpu/ops/ipm_solver.py) on the same numpy inputs."""
    a_buf, _, _, d, dxx = _inputs(bsz, cap, t, n, seed=3 * t + n)
    a = torch.from_numpy(a_buf)[:, :t]
    dt, dxxt = torch.from_numpy(d), torch.from_numpy(dxx)
    a8, ok = pack_rows(a)
    got = normal_build(a8, dt, dxxt, DELTA, n)
    assert bool(ok)
    assert torch.equal(got, normal_ref(a, dt, dxxt, DELTA))
    assert torch.equal(got, got.transpose(1, 2))
    a_np = a_buf[:, :t]
    want = _jax_einsums(a_np, np.zeros((bsz, n), np.float32),
                        np.zeros((bsz, t), np.float32), d, dxx)[2]
    abs_a = np.abs(a_np)
    bound = t * EPS32 * (np.einsum("bri,br,brj->bij", abs_a, d, abs_a)
                         + dxx[:, :, None] * np.eye(n) + DELTA)
    assert (np.abs(got.numpy() - want) <= bound + 1e-30).all()


@pytest.mark.parametrize("case", ["float32", "pad", "rank", "d_shape",
                                  "dxx_shape", "d_dtype", "strided"])
def test_normal_build_refuses_wrong_inputs(case):
    a_buf, _, _, d, dxx = _inputs(2, 64, 64, 40, seed=5)
    a8, _ = pack_rows(torch.from_numpy(a_buf))
    dt, dxxt = torch.from_numpy(d), torch.from_numpy(dxx)
    n = 40
    error = ValueError
    if case == "float32":
        a8, error = torch.from_numpy(a_buf), TypeError
    elif case == "pad":
        n = 30                  # 30 columns pack to 32, not to 48
    elif case == "rank":
        a8 = a8[0]
    elif case == "d_shape":
        dt = dt[:, :-1]
    elif case == "dxx_shape":
        dxxt = dxxt[:1]
    elif case == "d_dtype":
        dt, error = dt.double(), TypeError
    elif case == "strided":
        a8 = a8[:, ::2]
        dt = dt[:, ::2].contiguous()
    with pytest.raises(error):
        normal_build(a8, dt, dxxt, DELTA, n)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("t", [128, 1408])
def test_kernels_match_twins_on_card(cuda_device, t):
    """AGC-ALP's shapes: 128 lanes, n = 280, a row slice of the
    (128, 1408, 280) buffer, the matvecs on its packed copy. Same bound as
    CPU case: exact products, float32 sums of n (A x) or T terms in another
    order."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cap, n = 1408, 280
    a_buf, x, y, d, dxx = _inputs(128, cap, t, n, seed=t)
    a = torch.from_numpy(a_buf).to(cuda_device)[:, :t]
    xt, yt, dt, dxxt = (torch.from_numpy(v).to(cuda_device)
                        for v in (x, y, d, dxx))
    a8, ok = pack_rows(a)
    before = gemv_kernel.GEMV_LAUNCHES
    got = (batched_gemv(a8, xt), batched_gemv_t(a8, yt, n),
           normal_build(a8, dt, dxxt, DELTA, n))
    want = (gemv_ref(a, xt), gemv_t_ref(a, yt),
            normal_ref(a, dt, dxxt, DELTA))
    torch.cuda.synchronize()
    assert bool(ok)
    assert gemv_kernel.GEMV_LAUNCHES == before + 1
    abs_a = a.abs()
    bounds = (n * EPS32 * gemv_ref(abs_a, xt.abs()),
              t * EPS32 * gemv_t_ref(abs_a, yt),
              t * EPS32 * (normal_ref(abs_a, dt, dxxt, DELTA)))
    for g, w, b in zip(got, want, bounds):
        assert g.shape == w.shape
        assert bool(((g - w).abs() <= b + 1e-30).all())
    assert torch.equal(got[2], got[2].transpose(1, 2))


@pytest.mark.gpu
@pytest.mark.parametrize("t,bsz,n", [(1, 1, 280), (1, 200, 283),
                                     (63, 3, 283), (63, 1, 280),
                                     (128, 128, 280), (128, 200, 283),
                                     (1408, 128, 280), (1408, 200, 283),
                                     (640, 128, 640), (2176, 64, 640)])
def test_packed_matvecs_any_shape_on_card(cuda_device, t, bsz, n):
    """Ragged T, B and n (a lane-strided slice, packed): within the float32
    summation bound of the twins, the same bits on a second call, and one
    launch counted per call."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(t + bsz + n)
    a_buf = rng.integers(-1, 2, (bsz, t + 5, n)).astype(np.float32)
    x = rng.uniform(size=(bsz, n)).astype(np.float32)
    y = np.abs(rng.normal(size=(bsz, t))).astype(np.float32)
    a = torch.from_numpy(a_buf).to(cuda_device)[:, :t]
    xt, yt = (torch.from_numpy(v).to(cuda_device) for v in (x, y))
    a8, ok = pack_rows(a)
    before = (gemv_kernel.GEMV_LAUNCHES, gemv_kernel.GEMV_T_LAUNCHES)
    fwd = [batched_gemv(a8, xt) for _ in range(2)]
    tr = [batched_gemv_t(a8, yt, n) for _ in range(2)]
    torch.cuda.synchronize()
    assert bool(ok)
    assert (gemv_kernel.GEMV_LAUNCHES, gemv_kernel.GEMV_T_LAUNCHES) == (
        before[0] + 2, before[1] + 2)
    assert torch.equal(fwd[0], fwd[1]) and torch.equal(tr[0], tr[1])
    # A^T y's per-lane run counts are left zero for the next call
    assert not any(bool(c.any()) for c in gemv_kernel._counts.values())
    abs_a = a.abs()
    assert bool(((fwd[0] - gemv_ref(a, xt)).abs()
                 <= n * EPS32 * gemv_ref(abs_a, xt) + 1e-30).all())
    assert bool(((tr[0] - gemv_t_ref(a, yt)).abs()
                 <= t * EPS32 * gemv_t_ref(abs_a, yt) + 1e-30).all())


@pytest.mark.gpu
@pytest.mark.parametrize("t,bsz,n", [(128, 128, 280), (512, 128, 280),
                                     (1152, 128, 280), (1408, 128, 280),
                                     (63, 3, 283), (1, 2, 280),
                                     (200, 5, 97), (640, 64, 640),
                                     (2176, 32, 640)])
def test_normal_build_tiers_on_card(cuda_device, t, bsz, n):
    """Every reported tier of the AGC-ALP path and shapes ragged in T, B and
    n: the tensor-core kernel on the packed copy within the float32
    summation bound of normal_ref (d over 1e-8...1e8, three exact bf16
    planes), M exactly symmetric, the same bits on a second call, one launch
    counted per call and per tier."""
    torch.backends.cuda.matmul.allow_tf32 = False
    a_buf, _, _, d, dxx = _inputs(bsz, t + 5, t, n, seed=t + bsz + n)
    a_buf[:, 3 * t // 4:] = np.random.default_rng(t).integers(
        -1, 2, a_buf[:, 3 * t // 4:].shape)
    a = torch.from_numpy(a_buf).to(cuda_device)[:, :t]
    dt, dxxt = (torch.from_numpy(v).to(cuda_device) for v in (d, dxx))
    a8, ok = pack_rows(a)
    gemv_kernel.reset_tier_counts()
    before = gemv_kernel.NORMAL_LAUNCHES
    got = [normal_build(a8, dt, dxxt, DELTA, n) for _ in range(2)]
    torch.cuda.synchronize()
    assert bool(ok)
    assert gemv_kernel.NORMAL_LAUNCHES == before + 2
    assert gemv_kernel.NORMAL_TIER_LAUNCHES == {t: 2}
    assert torch.equal(got[0], got[1])
    assert torch.equal(got[0], got[0].transpose(1, 2))
    want = normal_ref(a, dt, dxxt, DELTA)
    bound = t * EPS32 * normal_ref(a.abs(), dt, dxxt, DELTA)
    assert got[0].shape == want.shape
    assert bool(((got[0] - want).abs() <= bound + 1e-30).all())
