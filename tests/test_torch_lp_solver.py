"""PDHG solvers of the PyTorch port against the JAX package.

The same numpy-made LPs (random signed rows, shaped like
``tests/test_pallas_pdhg.py``'s) go through ``ldpc_tpu.ops.lp_solver`` and
the TPU kernel in Pallas interpret mode on one side, and through
``ldpc_tpu_torch.ops`` on the CPU on the other. Bounds are the JAX package's
own between its kernel and XLA: |dx| <= 2e-5, |dy| <= 2e-4, |d err| <= 1e-5
(3e-5 with ``average``); the only difference is the float32 summation order
of the matvecs. The CUDA kernel is held to its twin on the card (marked
``gpu``; run there with ``python -m pytest tests/test_torch_lp_solver.py -m
gpu --noconftest``, where the JAX side is absent).
"""
import numpy as np
import pytest
import torch

from ldpc_tpu_torch.ops import pdhg_kernel
from ldpc_tpu_torch.ops.lp_solver import (pdhg_box_lp, pdhg_box_lp_fused,
                                          pdhg_steps)
from ldpc_tpu_torch.ops.pdhg_ref import lane_err, pdhg_chunk_ref

try:  # the card's host has no JAX; only the gpu cases run there
    import jax.numpy as jnp
    from ldpc_tpu.ops import lp_solver as jlp
    from ldpc_tpu.ops.pallas.pdhg_kernel import pdhg_chunk_pallas
except ImportError:
    jnp = None

X_TOL, Y_TOL, ERR_TOL, AVG_TOL = 2e-5, 2e-4, 1e-5, 3e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small tensors: one intra-op thread, so parallel test workers do not
    oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _random_lp(seed, bsz=3, t_rows=128, n=280, active=40):
    """Random signed-row LPs resembling ALP cut buffers: rows past
    ``active`` are zero with rhs 0; numpy arrays (c, a, b, x0, y0)."""
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((bsz, n)).astype(np.float32)
    a = rng.integers(-1, 2, (bsz, t_rows, n)).astype(np.float32)
    a[:, active:] = 0.0
    b = (np.abs(rng.standard_normal((bsz, t_rows))) * 3.0).astype(np.float32)
    b[:, active:] = 0.0
    x0 = rng.uniform(size=(bsz, n)).astype(np.float32)
    y0 = np.zeros((bsz, t_rows), np.float32)
    return c, a, b, x0, y0


def _t(*arrays):
    return tuple(torch.from_numpy(np.asarray(v)) for v in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(v) for v in arrays)


def _close(got, want, atol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=atol)


@pytest.mark.parametrize("safety,omega", [(0.95, 1.0), (0.9, 2.0)])
def test_pdhg_steps_exact(safety, omega):
    _, a, _, _, _ = _random_lp(1, bsz=4, t_rows=96, n=130, active=50)
    a[1] = 0.0                                   # an empty lane
    tau, sigma = pdhg_steps(torch.from_numpy(a), safety, omega)
    jtau, jsigma = jlp.pdhg_steps(jnp.asarray(a), safety, omega)
    np.testing.assert_array_equal(tau.numpy(), np.asarray(jtau))
    np.testing.assert_array_equal(sigma.numpy(), np.asarray(jsigma))
    assert (sigma[:, 50:] == 0).all() and (tau[1] == np.float32(safety)
                                           * np.float32(omega)).all()


def test_pdhg_box_lp_fixed_iters_matches_jax():
    lp = _random_lp(0)
    x, y = pdhg_box_lp(*_t(*lp), 150)
    jx, jy = jlp.pdhg_box_lp(*_j(*lp), 150)
    _close(x, jx, X_TOL)
    _close(y, jy, Y_TOL)


@pytest.mark.parametrize("average", [False, True])
def test_pdhg_box_lp_tol_driven_matches_jax(average):
    """The chunk loop with tolerance, stall rule and an inactive lane."""
    c, a, b, x0, y0 = _random_lp(7, bsz=4, active=24)
    active = np.array([True, True, False, True])
    kw = dict(tol=1e-3, check_every=250, stall_ratio=0.8, average=average)
    x, y, v = pdhg_box_lp(*_t(c, a, b, x0, y0), 3000,
                          active=torch.from_numpy(active), **kw)
    jx, jy, jv = jlp.pdhg_box_lp(*_j(c, a, b, x0, y0), 3000,
                                 active=jnp.asarray(active), **kw)
    tol = AVG_TOL if average else X_TOL
    _close(x, jx, tol)
    _close(y, jy, Y_TOL)
    _close(v, jv, AVG_TOL if average else ERR_TOL)
    # the stall rule ends this solve above tol, after some chunks ran
    assert v[2] == 0.0 and not torch.equal(x, torch.from_numpy(x0))


def test_pdhg_box_lp_initial_error_stops_at_once():
    """A warm start already within tolerance runs no chunk: x0, y0 and
    their own error come back, as JAX's first cond sees them."""
    c, a, b, x0, y0 = _random_lp(3, bsz=2, active=0)
    x0 = (c < 0).astype(np.float32)              # the box optimum
    x, y, v = pdhg_box_lp(*_t(c, a, b, x0, y0), 640, tol=1e-3,
                          check_every=64)
    assert torch.equal(x, torch.from_numpy(x0))
    jx, _, jv = jlp.pdhg_box_lp(*_j(c, a, b, x0, y0), 640, tol=1e-3,
                                check_every=64)
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


@pytest.mark.parametrize("bsz,active_rows,iters,seed",
                         [(3, 40, 150, 0), (8, 32, 120, 11)])
@pytest.mark.parametrize("average", [False, True])
def test_chunk_ref_matches_pallas_interpreted(bsz, active_rows, iters, seed,
                                              average):
    """B = 3 runs the TPU kernel with G = 1, B = 8 with G = 8."""
    c, a, b, x0, y0 = _random_lp(seed, bsz=bsz, active=active_rows)
    tau, sigma = pdhg_steps(torch.from_numpy(a))
    x, y, err = pdhg_chunk_ref(*_t(c, a, b), tau, sigma, *_t(x0, y0), iters,
                               average=average)
    jx, jy, jerr = pdhg_chunk_pallas(
        *_j(c, a, b, tau.numpy(), sigma.numpy(), x0, y0), iters=iters,
        interpret=True, average=average)
    tol = AVG_TOL if average else X_TOL
    _close(x, jx, tol)
    _close(y, jy, Y_TOL)
    _close(err, jerr, AVG_TOL if average else ERR_TOL)
    # the reported error is the error of the returned iterate
    _close(err, lane_err(*_t(c, a, b), x, y).numpy(), 1e-6)


def test_chunk_ref_inactive_lanes_pass_through():
    """Per-lane ``active``: inactive lanes return x, y bit for bit and error
    0; active lanes equal an all-active run. The TPU kernel skips whole
    lane groups: an all-inactive group passes through the same way."""
    c, a, b, x0, y0 = _random_lp(13, bsz=4, active=32)
    tau, sigma = pdhg_steps(torch.from_numpy(a))
    args = (*_t(c, a, b), tau, sigma, *_t(x0, y0), 50)
    act = torch.tensor([False, True, False, True])
    x, y, err = pdhg_chunk_ref(*args, active=act)
    xa, ya, erra = pdhg_chunk_ref(*args)
    assert torch.equal(x[~act], torch.from_numpy(x0)[~act])
    assert torch.equal(y[~act], torch.from_numpy(y0)[~act])
    assert torch.equal(err[~act], torch.zeros(2))
    assert torch.equal(x[act], xa[act]) and torch.equal(y[act], ya[act])
    assert torch.equal(err[act], erra[act])
    none = torch.zeros(4, dtype=torch.bool)
    xs, ys, es = pdhg_chunk_ref(*args, active=none)
    jx, jy, je = pdhg_chunk_pallas(
        *_j(c, a, b, tau.numpy(), sigma.numpy(), x0, y0), iters=50,
        active=jnp.asarray(none.numpy()), interpret=True)
    for got, want in ((xs, jx), (ys, jy), (es, je)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("average", [False, True])
def test_fused_solver_matches_jax_fused_interpreted(average):
    if average:
        lp, kw = _random_lp(21, bsz=4, active=32), dict(
            iters=900, tol=1e-6, check_every=300)
    else:
        lp, kw = _random_lp(7, bsz=2, active=24), dict(
            iters=3000, tol=1e-3, check_every=250)
    x, y, v = pdhg_box_lp_fused(*_t(*lp), average=average, **kw)
    jx, jy, jv = jlp.pdhg_box_lp_fused(*_j(*lp), average=average,
                                       interpret=True, **kw)
    tol = AVG_TOL if average else X_TOL
    _close(x, jx, tol)
    _close(y, jy, Y_TOL)
    _close(v, jv, AVG_TOL if average else ERR_TOL)
    assert float(x.min()) >= 0.0 and float(x.max()) <= 1.0


def test_fused_solver_with_active_and_stall_matches_jax():
    c, a, b, x0, y0 = _random_lp(5, bsz=8, active=48)
    act = np.array([1, 1, 0, 1, 0, 0, 1, 1], bool)
    kw = dict(tol=3e-4, check_every=64, stall_ratio=0.8)
    x, y, v = pdhg_box_lp_fused(*_t(c, a, b, x0, y0), 2048,
                                active=torch.from_numpy(act), **kw)
    jx, jy, jv = jlp.pdhg_box_lp_fused(*_j(c, a, b, x0, y0), 2048,
                                       active=jnp.asarray(act),
                                       interpret=True, **kw)
    # inactive lanes: the port passes them through, the TPU kernel steps
    # them inside an active group; both zero their error
    _close(x[act], np.asarray(jx)[act], X_TOL)
    _close(y[act], np.asarray(jy)[act], Y_TOL)
    _close(v, jv, ERR_TOL)
    assert torch.equal(x[~act], torch.from_numpy(x0)[~act])


def test_fused_solver_takes_a_row_slice_of_a_buffer():
    """The decoder hands over ``a_buf[:, :T]`` and ``rhs_buf[:, :T]``."""
    c, a, b, x0, y0 = _random_lp(9, bsz=3, t_rows=256, active=40)
    a_t, b_t = torch.from_numpy(a), torch.from_numpy(b)
    kw = dict(tol=1e-3, check_every=64)
    x, y, v = pdhg_box_lp_fused(torch.from_numpy(c), a_t[:, :128],
                                b_t[:, :128], torch.from_numpy(x0),
                                torch.from_numpy(y0)[:, :128], 640, **kw)
    xc, yc, vc = pdhg_box_lp_fused(*_t(c, a[:, :128].copy(),
                                       b[:, :128].copy(), x0,
                                       y0[:, :128].copy()), 640, **kw)
    assert torch.equal(x, xc) and torch.equal(y, yc) and torch.equal(v, vc)


def test_chunk_wrapper_routes_cpu_to_twin():
    c, a, b, x0, y0 = _random_lp(2, bsz=2, t_rows=64, n=40, active=20)
    tau, sigma = pdhg_steps(torch.from_numpy(a))
    args = (*_t(c, a, b), tau, sigma, *_t(x0, y0), 20)
    before = pdhg_kernel.LAUNCHES
    got = pdhg_kernel.pdhg_chunk(*args, average=True)
    want = pdhg_chunk_ref(*args, average=True)
    assert pdhg_kernel.LAUNCHES == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    meta = [v.to("meta") for v in args[:7]]
    with pytest.raises(ValueError, match="no implementation"):
        pdhg_kernel.pdhg_chunk(*meta, 20)
    with pytest.raises(ValueError, match="iters"):
        pdhg_chunk_ref(*args[:7], 0)


@pytest.mark.parametrize("bad", [0.5, 2.0, -2.0, float("nan")])
@pytest.mark.parametrize("average", [False, True])
def test_chunk_wrapper_flags_rows_outside_the_set_on_cpu(bad, average):
    """The wrapper's fourth value: true for an active
    lane whose slice has an entry other than -1, 0, 1, made on the CPU with
    tensor operations; x, y and err are the plain version's."""
    c, a, b, x0, y0 = _random_lp(3, bsz=4, t_rows=64, n=40, active=20)
    a[1, 5, 7] = bad
    a[2, 63, 39] = bad
    tau, sigma = pdhg_steps(torch.from_numpy(np.nan_to_num(a)))
    args = (*_t(c, a, b), tau, sigma, *_t(x0, y0), 8)
    act = torch.tensor([True, True, False, True])
    out = pdhg_kernel.pdhg_chunk(*args, active=act, average=average)
    assert len(out) == 4 and out[3].dtype == torch.bool
    assert out[3].tolist() == [False, True, False, False]
    assert pdhg_kernel.pdhg_chunk(*args, average=average)[3].tolist() == [
        False, True, True, False]
    assert pdhg_kernel.outside_set(torch.from_numpy(a)).tolist() == [
        False, True, True, False]
    want = pdhg_chunk_ref(*args, active=act, average=average)
    for g, w in zip(out[:3], want):
        assert torch.equal(g, w) or bool(torch.isnan(w).any())


@pytest.mark.parametrize("bad", [0.5, -2.0])
@pytest.mark.parametrize("chunks", [1, 4])
def test_fused_solver_refuses_rows_outside_the_set(bad, chunks):
    """A row with an entry outside {-1, 0, 1} raises, whether the solve runs
    one chunk (read after the loop) or several (read with the second
    chunk's host read); an inactive lane's rows are not looked at; real cut
    rows pass."""
    c, a, b, x0, y0 = _random_lp(11, bsz=3, t_rows=64, n=40, active=30)
    kw = dict(tol=1e-9, check_every=16)
    good = pdhg_box_lp_fused(*_t(c, a, b, x0, y0), 16 * chunks, **kw)
    assert all(bool(torch.isfinite(v).all()) for v in good)
    a[1, 3, 7] = bad
    with pytest.raises(ValueError, match=r"entries in \{-1, 0, 1\}"):
        pdhg_box_lp_fused(*_t(c, a, b, x0, y0), 16 * chunks, **kw)
    act = torch.tensor([True, False, True])
    x, _, v = pdhg_box_lp_fused(*_t(c, a, b, x0, y0), 16 * chunks,
                                active=act, **kw)
    assert torch.equal(x[1], torch.from_numpy(x0)[1]) and float(v[1]) == 0.0


def test_fused_solver_makes_no_extra_host_read(monkeypatch):
    """The guard rides on the loop's own host read: with several chunks,
    one read per chunk after the first and none after the loop."""
    c, a, b, x0, y0 = _random_lp(13, bsz=2, t_rows=64, n=40, active=30)
    reads = []
    for name in ("item", "tolist"):
        real = getattr(torch.Tensor, name)

        def counted(self, _real=real, _name=name):
            reads.append(_name)
            return _real(self)

        monkeypatch.setattr(torch.Tensor, name, counted)
    pdhg_box_lp_fused(*_t(c, a, b, x0, y0), 64, tol=1e-9, check_every=16)
    assert len(reads) == 3, reads          # before chunks 2, 3 and 4
    del reads[:]
    pdhg_box_lp_fused(*_t(c, a, b, x0, y0), 16, tol=1e-9, check_every=16)
    assert len(reads) == 1, reads          # one chunk: the guard, at the end


def test_tier_launch_counter_counts_and_resets():
    """TIER_LAUNCHES counts launches by row count T (none on the CPU, where
    the wrapper runs the plain version) and reset_tier_counts clears it."""
    pdhg_kernel.TIER_LAUNCHES[128] += 2
    pdhg_kernel.TIER_LAUNCHES[896] += 1
    assert dict(pdhg_kernel.TIER_LAUNCHES) == {128: 2, 896: 1}
    pdhg_kernel.reset_tier_counts()
    assert not pdhg_kernel.TIER_LAUNCHES
    c, a, b, x0, y0 = _random_lp(2, bsz=2, t_rows=64, n=40, active=20)
    tau, sigma = pdhg_steps(torch.from_numpy(a))
    pdhg_kernel.pdhg_chunk(*_t(c, a, b), tau, sigma, *_t(x0, y0), 4)
    assert not pdhg_kernel.TIER_LAUNCHES


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("t_rows,active_rows", [(128, 40), (896, 600),
                                                (37, 37)])
@pytest.mark.parametrize("average", [False, True])
def test_kernel_matches_twin_on_card(cuda_device, t_rows, active_rows,
                                     average):
    c, a, b, x0, y0 = _random_lp(31, bsz=96, t_rows=t_rows,
                                 active=active_rows)
    dev = cuda_device
    c, a, b, x0, y0 = (torch.from_numpy(v).to(dev) for v in
                       (c, a, b, x0, y0))
    tau, sigma = pdhg_steps(a)
    act = torch.arange(96, device=dev) % 3 != 0
    before = pdhg_kernel.LAUNCHES
    x, y, err, _ = pdhg_kernel.pdhg_chunk(c, a, b, tau, sigma, x0, y0, 64,
                                          active=act, average=average)
    torch.cuda.synchronize()
    assert pdhg_kernel.LAUNCHES == before + 1
    xr, yr, er = pdhg_chunk_ref(c, a, b, tau, sigma, x0, y0, 64,
                                active=act, average=average)
    assert float((x - xr).abs().max()) <= X_TOL
    assert float((y - yr).abs().max()) <= Y_TOL
    assert float((err - er).abs().max()) <= ERR_TOL
    assert torch.equal(x[~act], x0[~act]) and torch.equal(y[~act], y0[~act])
    assert torch.equal(err[~act], torch.zeros_like(err[~act]))


@pytest.mark.gpu
def test_kernel_strided_slice_and_checks_on_card(cuda_device):
    dev = cuda_device
    c, a, b, x0, y0 = (torch.from_numpy(v).to(dev) for v in
                       _random_lp(32, bsz=16, t_rows=256, active=100))
    a_t, b_t, y_t = a[:, :128], b[:, :128].contiguous(), y0[:, :128]
    tau, sigma = pdhg_steps(a_t)
    y_t = y_t.contiguous()
    x, y, err, _ = pdhg_kernel.pdhg_chunk(c, a_t, b_t, tau, sigma, x0, y_t,
                                          64)
    xr, yr, er, _ = pdhg_kernel.pdhg_chunk(c, a_t.contiguous(), b_t, tau,
                                           sigma, x0, y_t, 64)
    assert torch.equal(x, xr) and torch.equal(y, yr) and torch.equal(err, er)
    with pytest.raises(ValueError, match="contiguous"):
        pdhg_kernel.pdhg_chunk(c, a_t, b[:, :128], tau, sigma, x0, y_t, 64)
    with pytest.raises(ValueError, match="rows must be contiguous"):
        pdhg_kernel.pdhg_chunk(c, a_t.transpose(1, 2).contiguous()
                               .transpose(1, 2), b_t, tau, sigma, x0, y_t,
                               64)
    with pytest.raises(TypeError):
        pdhg_kernel.pdhg_chunk(c, a_t.double(), b_t, tau, sigma, x0, y_t, 64)
    with pytest.raises(ValueError, match="shape"):
        pdhg_kernel.pdhg_chunk(c[:, :-1], a_t, b_t, tau, sigma, x0, y_t, 64)
    big = torch.zeros((1, 60000, 280), device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        pdhg_kernel.pdhg_chunk(c[:1], big, b_t[:1, :1].expand(1, 60000)
                               .contiguous(), tau[:1],
                               torch.zeros((1, 60000), device=dev), x0[:1],
                               torch.zeros((1, 60000), device=dev), 64)


@pytest.mark.gpu
@pytest.mark.parametrize("t_rows", [128, 256, 384, 512, 640, 896, 1, 333])
@pytest.mark.parametrize("average", [False, True])
def test_kernel_every_alp_tier_on_card(cuda_device, t_rows, average):
    """Every row tier of the ALP path at its batch (256 lanes, n = 280) and
    two ragged row counts, on a lane-strided slice: within the bounds of the
    plain version, inactive lanes passed through, the same bits on a second
    call, the launch counted under its tier, no lane flagged; T = 896 runs
    as a cluster of two blocks per lane."""
    dev = cuda_device
    c, a, b, x0, y0 = (torch.from_numpy(v).to(dev) for v in _random_lp(
        t_rows, bsz=256, t_rows=t_rows + 3, active=max(1, t_rows * 5 // 8)))
    a_t, b_t = a[:, :t_rows], b[:, :t_rows].contiguous()
    y_t = y0[:, :t_rows].contiguous()
    tau, sigma = pdhg_steps(a_t)
    act = torch.arange(256, device=dev) % 3 != 0
    plan = pdhg_kernel.kernel_plan(280, t_rows, average)
    assert plan["fits"]
    assert plan["blocks_per_lane"] == (2 if t_rows == 896 else 1)
    pdhg_kernel.reset_tier_counts()
    runs = [pdhg_kernel.pdhg_chunk(c, a_t, b_t, tau, sigma, x0, y_t, 64,
                                   active=act, average=average)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert dict(pdhg_kernel.TIER_LAUNCHES) == {t_rows: 2}
    for g, w in zip(*runs):
        assert torch.equal(g, w)
    x, y, err, flag = runs[0]
    xr, yr, er = pdhg_chunk_ref(c, a_t, b_t, tau, sigma, x0, y_t, 64,
                                active=act, average=average)
    assert float((x - xr).abs().max()) <= X_TOL
    assert float((y - yr).abs().max()) <= Y_TOL
    assert float((err - er).abs().max()) <= ERR_TOL
    assert torch.equal(x[~act], x0[~act]) and torch.equal(y[~act], y_t[~act])
    assert not bool(flag.any())


@pytest.mark.gpu
@pytest.mark.parametrize("t_rows", [128, 896])
def test_kernel_flags_rows_outside_the_set_on_card(cuda_device, t_rows):
    """The kernel's per-lane report equals the CPU's (outside_set), for an
    entry in either half of a split slice and in an inactive lane; the fused
    solver raises on it."""
    dev = cuda_device
    c, a, b, x0, y0 = (torch.from_numpy(v).to(dev) for v in _random_lp(
        5, bsz=8, t_rows=t_rows, active=t_rows // 2))
    a[1, 0, 0] = 0.5
    a[2, t_rows - 1, 279] = -2.0
    a[3, 7, 100] = 3.0
    a[6, t_rows // 2, 17] = float("nan")
    act = torch.arange(8, device=dev) != 3
    tau, sigma = pdhg_steps(torch.nan_to_num(a))
    flag = pdhg_kernel.pdhg_chunk(c, a, b, tau, sigma, x0, y0, 8,
                                  active=act)[3]
    assert flag.tolist() == pdhg_kernel.outside_set(a, act).tolist() == [
        False, True, True, False, False, False, True, False]
    with pytest.raises(ValueError, match=r"entries in \{-1, 0, 1\}"):
        pdhg_box_lp_fused(c, a, b, x0, y0, 128, tol=1e-9, check_every=64,
                          active=act)


def _h02_tiers():
    """Every row tier ALP solves on H02 (520 x 640): the decoder's tiers and
    its capacity, 128 ... 2176."""
    import os

    from ldpc_tpu_torch.codes.io import read_pcm
    from ldpc_tpu_torch.decoders.alp import ALPDecoder
    h = read_pcm(os.path.join(os.path.dirname(__file__), "..", "data",
                              "H02.txt"))
    dec = ALPDecoder(h, device="cpu")
    return h.shape[1], (*dec._tiers, dec.capacity)


def test_h02_tiers_reach_the_cluster_sizes():
    """The shapes the n = 640 kernel plans are asked for (the plans
    themselves need the card)."""
    n, tiers = _h02_tiers()
    assert n == 640
    assert tiers == (128, 256, 384, 512, 640, 896, 1152, 1408, 1664, 1920,
                     2176)


@pytest.mark.gpu
@pytest.mark.parametrize("average", [False, True])
def test_kernel_plan_fits_every_h02_tier_on_card(cuda_device, average):
    """At n = 640 every ALP tier fits: one block to T = 256, then clusters
    of 2, 4 and 8 blocks per lane (T = 2176 in 272 rows per block), each
    block within the card's shared memory."""
    n, tiers = _h02_tiers()
    props = torch.cuda.get_device_properties(cuda_device)
    plans = {t: pdhg_kernel.kernel_plan(n, t, average) for t in tiers}
    assert all(p["fits"] for p in plans.values()), plans
    assert [plans[t]["blocks_per_lane"] for t in tiers] == [
        1, 1, 2, 2, 4, 4, 4, 8, 8, 8, 8]
    assert max(p["smem_bytes"] for p in plans.values()) <= getattr(
        props, "shared_memory_per_block_optin", 232448)
    assert not pdhg_kernel.kernel_plan(n, 8 * 2176, average)["fits"]


@pytest.mark.gpu
@pytest.mark.parametrize("t_rows", [640, 896, 2176])
@pytest.mark.parametrize("average", [False, True])
def test_kernel_at_n640_matches_twin_on_card(cuda_device, t_rows, average):
    """H02's width, the tiers that need clusters of 4 and 8: within the
    bounds of the plain version, inactive lanes passed through, the same
    bits on a second call, no lane flagged."""
    dev = cuda_device
    c, a, b, x0, y0 = (torch.from_numpy(v).to(dev) for v in _random_lp(
        t_rows + 1, bsz=48, t_rows=t_rows, n=640,
        active=t_rows * 5 // 8))
    tau, sigma = pdhg_steps(a)
    act = torch.arange(48, device=dev) % 3 != 0
    runs = [pdhg_kernel.pdhg_chunk(c, a, b, tau, sigma, x0, y0, 64,
                                   active=act, average=average)
            for _ in range(2)]
    torch.cuda.synchronize()
    for g, w in zip(*runs):
        assert torch.equal(g, w)
    x, y, err, flag = runs[0]
    xr, yr, er = pdhg_chunk_ref(c, a, b, tau, sigma, x0, y0, 64,
                                active=act, average=average)
    assert float((x - xr).abs().max()) <= X_TOL
    assert float((y - yr).abs().max()) <= Y_TOL
    assert float((err - er).abs().max()) <= ERR_TOL
    assert torch.equal(x[~act], x0[~act]) and torch.equal(y[~act], y0[~act])
    assert not bool(flag.any())
