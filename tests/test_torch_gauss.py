"""GF(2) elimination of the PyTorch port against the JAX package, exactly
(``np.testing.assert_array_equal``): the column order, the elimination twin
(against ``gf2_eliminate_ordered`` and against ``gf2_eliminate_pallas`` in
interpret mode, on active lanes), and the whole ``calculate_gauss_batched``
on ``H.txt`` and ``optimalH.txt``, plus the scalar oracle of
``tests/test_gauss.py``. The CUDA kernel is held to the twin bit for bit on
the card (marked ``gpu``; ``python -m pytest tests/test_torch_gauss.py -m
gpu --noconftest``).
"""
import os

import numpy as np
import pytest
import torch

from ldpc_tpu_torch.codes.io import read_pcm
from ldpc_tpu_torch.ops import gauss_kernel
from ldpc_tpu_torch.ops.gauss_kernel import gauss_plan, gf2_eliminate
from ldpc_tpu_torch.ops.gauss_ref import gf2_eliminate_ref
from ldpc_tpu_torch.ops.gf2_gauss import (calculate_gauss_batched,
                                          fractional_column_order,
                                          gf2_eliminate_ordered)

try:  # the card's host has no JAX; only the gpu cases run there
    import jax.numpy as jnp
    from ldpc_tpu.ops import gf2_gauss as jgauss
    from ldpc_tpu.ops.pallas.gauss_kernel import gf2_eliminate_pallas
except ImportError:
    jnp = None

DATA = os.path.join(os.path.dirname(__file__), "..", "data")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _h(name):
    return read_pcm(os.path.join(DATA, f"{name}.txt"))


def _u(rng, bsz, n):
    """LP points with every kind of column: fractional, exact 0 and 1, ties
    on |u - 0.5| (u and 1 - u), and values at and around eps and 1 - eps."""
    u = rng.uniform(0.0, 1.0, (bsz, n)).astype(np.float32)
    u[0, : n // 3] = 0.0
    u[1, n // 4: n // 2] = 1.0
    u[2, ::3] = 0.5
    u[2, 1::5] = 0.25
    u[2, 2::7] = 0.75                                  # ties with the 0.25s
    edge = np.float32([1e-8, 0.99999999, 1 - 1e-8, 2e-8, 5e-9, 1 - 5e-8,
                       np.nextafter(np.float32(1e-8), np.float32(0)),
                       np.nextafter(np.float32(1e-8), np.float32(1))])
    u[3, : edge.size] = edge
    u[3, edge.size: 2 * edge.size] = edge[::-1]
    return u


@pytest.mark.parametrize("name", ["tiny", "H", "optimalH"])
def test_column_order_matches_jax(name, tiny_h):
    n = 7 if name == "tiny" else _h(name).shape[1]
    rng = np.random.default_rng(n)
    u = _u(rng, 4, n) if n > 16 else rng.uniform(0, 1, (3, n)).astype(
        np.float32)
    for eps in (1e-8, 1e-3):
        p = fractional_column_order(torch.from_numpy(u), eps)
        want = jgauss.fractional_column_order(jnp.asarray(u), eps)
        np.testing.assert_array_equal(p.numpy(), np.asarray(want))
        assert p.shape == u.shape


def test_elimination_twin_matches_jax_and_pallas_interpret():
    h = _h("optimalH")
    rng = np.random.default_rng(3)
    u = _u(rng, 4, h.shape[1])
    p = np.asarray(jgauss.fractional_column_order(jnp.asarray(u)))
    h_perm = np.stack([h[:, p[b]] for b in range(4)]).astype(np.uint8)
    got = gf2_eliminate_ordered(torch.from_numpy(h_perm))
    want = np.asarray(jgauss.gf2_eliminate_ordered(jnp.asarray(h_perm)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.uint8
    active = np.array([True, False, True, True])
    pallas = np.asarray(gf2_eliminate_pallas(jnp.asarray(h_perm),
                                             jnp.asarray(active),
                                             interpret=True))
    ref = gf2_eliminate_ref(torch.from_numpy(h_perm),
                            torch.from_numpy(active)).numpy()
    np.testing.assert_array_equal(ref[active], pallas[active])
    np.testing.assert_array_equal(ref[~active], h_perm[~active])
    before = gauss_kernel.LAUNCHES
    out = gf2_eliminate(torch.from_numpy(h_perm), torch.from_numpy(active))
    np.testing.assert_array_equal(out.numpy(), ref)  # the CPU runs the twin
    assert gauss_kernel.LAUNCHES == before


@pytest.mark.parametrize("name", ["H", "optimalH"])
@pytest.mark.parametrize("backend", ["xla", "kernel"])
def test_calculate_gauss_matches_jax(name, backend):
    h = _h(name)
    rng = np.random.default_rng(len(name))
    u = _u(rng, 4, h.shape[1])
    want = np.asarray(jgauss.calculate_gauss_batched(
        jnp.asarray(h), jnp.asarray(u), 1e-8, backend="xla"))
    active = torch.tensor([True, True, False, True])
    got = calculate_gauss_batched(torch.from_numpy(h), torch.from_numpy(u),
                                  1e-8, active=active, backend=backend)
    lanes = [0, 1, 3] if backend == "kernel" else [0, 1, 2, 3]
    np.testing.assert_array_equal(got.numpy()[lanes], want[lanes])
    assert got.dtype == torch.uint8 and got.shape == (4, *h.shape)


def test_calculate_gauss_matches_scalar_oracle(small_h):
    from test_gauss import scalar_calculate_gauss
    rng = np.random.default_rng(1)
    u = rng.uniform(0.0, 1.0, (4, small_h.shape[1])).astype(np.float32)
    u[0, :40] = 0.0
    u[1, 10:30] = 1.0
    out = calculate_gauss_batched(torch.from_numpy(small_h),
                                  torch.from_numpy(u), 1e-8).numpy()
    for b in range(4):
        np.testing.assert_array_equal(
            out[b], scalar_calculate_gauss(small_h, u[b]), err_msg=f"lane {b}")
    with pytest.raises(ValueError, match="gauss backend"):
        calculate_gauss_batched(torch.from_numpy(small_h),
                                torch.from_numpy(u), backend="pallas")


def _code_lanes(name, bsz, seed):
    """``bsz`` lanes of a code's H in the column order of LP points from
    ``_u``, as AGC-ALP hands them to the elimination."""
    h = _h(name)
    u = _u(np.random.default_rng(seed), max(bsz, 4), h.shape[1])[:bsz]
    p = fractional_column_order(torch.from_numpy(u)).numpy()
    return np.ascontiguousarray(
        np.stack([h[:, p[b]] for b in range(bsz)]), dtype=np.uint8)


def _bernoulli(rng, bsz, m, n, density):
    return (rng.uniform(size=(bsz, m, n)) < density).astype(np.uint8)


def _rank_deficient(rng, bsz, m, n, rank):
    """Rows that are GF(2) sums of ``rank`` base rows, and every seventh
    column zero: no lane's rank reaches m."""
    coef = _bernoulli(rng, bsz, m, rank, 0.5).astype(np.int64)
    base = _bernoulli(rng, bsz, rank, n, 0.5).astype(np.int64)
    out = (coef @ base % 2).astype(np.uint8)
    out[:, :, ::7] = 0
    return out


def _early_saturation(rng, bsz, m, n):
    """Lane 0 is [I | random]: its rank reaches m at column m - 1. Lane 1
    is zero (rank 0); the rest are dense and saturate a few columns after
    m."""
    out = _bernoulli(rng, bsz, m, n, 0.5)
    out[0, :, :m] = np.eye(m, dtype=np.uint8)
    out[1] = 0
    return out


def _third_off(bsz):
    return np.arange(bsz) % 3 != 0


# name -> (h_perm (B, m, n) uint8, active (B,) bool), made from a seed
_CASES = {
    "optimalH": lambda: (_code_lanes("optimalH", 128, 6), _third_off(128)),
    "H02": lambda: (_code_lanes("H02", 128, 6), _third_off(128)),
    "ragged-37x70": lambda: (
        _bernoulli(np.random.default_rng(37), 64, 37, 70, 0.3),
        _third_off(64)),
    "ragged-63x283": lambda: (
        _bernoulli(np.random.default_rng(63), 64, 63, 283, 0.1),
        _third_off(64)),
    "tall-70x37": lambda: (
        _bernoulli(np.random.default_rng(70), 32, 70, 37, 0.5),
        _third_off(32)),
    "rank-deficient-96x200": lambda: (
        _rank_deficient(np.random.default_rng(96), 32, 96, 200, 40),
        np.ones(32, dtype=bool)),
    "early-saturation-64x300": lambda: (
        _early_saturation(np.random.default_rng(64), 16, 64, 300),
        np.ones(16, dtype=bool)),
    "one-lane": lambda: (_code_lanes("optimalH", 1, 7),
                         np.ones(1, dtype=bool)),
    "129-lanes": lambda: (_code_lanes("optimalH", 129, 8), _third_off(129)),
    "all-inactive": lambda: (_code_lanes("optimalH", 16, 9),
                             np.zeros(16, dtype=bool)),
    # the largest lane of three word buckets: 12 words at 1024 threads,
    # 16 at 768 and 24 at 640 (above 48 KB of shared memory)
    "words-12-384x1024": lambda: (
        _bernoulli(np.random.default_rng(384), 12, 384, 1024, 0.5),
        _third_off(12)),
    "words-16-512x768": lambda: (
        _bernoulli(np.random.default_rng(512), 12, 512, 768, 0.5),
        _third_off(12)),
    "words-24-768x640": lambda: (
        _rank_deficient(np.random.default_rng(768), 12, 768, 640, 600),
        _third_off(12)),
}
_CPU_CASES = ("ragged-37x70", "ragged-63x283", "tall-70x37",
              "rank-deficient-96x200", "early-saturation-64x300")


@pytest.mark.parametrize("case", _CPU_CASES)
def test_elimination_twin_matches_jax_on_shapes(case):
    """The twin (what the kernel is held to on the card) against JAX's
    ``gf2_eliminate_ordered`` on the card cases' shapes, eight lanes each."""
    h_perm, active = (a[:8] for a in _CASES[case]())
    got = gf2_eliminate(torch.from_numpy(h_perm), torch.from_numpy(active))
    want = np.asarray(jgauss.gf2_eliminate_ordered(jnp.asarray(h_perm)))
    np.testing.assert_array_equal(got.numpy()[active], want[active])
    np.testing.assert_array_equal(got.numpy()[~active], h_perm[~active])
    if case.startswith("rank-deficient"):
        assert (want.any(axis=2).sum(axis=1) < h_perm.shape[1]).all()


@pytest.mark.parametrize("m, n, threads, words", [
    (160, 280, 288, 5), (520, 640, 640, 20), (1, 1, 32, 1),
    (256, 32, 32, 8), (257, 33, 64, 12), (37, 70, 96, 2), (63, 283, 288, 2),
    (70, 37, 64, 3), (384, 1024, 1024, 12), (512, 768, 768, 16),
    (513, 640, 640, 20), (768, 600, 608, 24)])
def test_gauss_plan_layout(m, n, threads, words):
    """One block per lane of one thread per column (n rounded up to a
    warp, within 1024 threads, 768 at 16 words, 640 above), ceil(m / 32)
    words of row bits (a multiple of 4 above 8), and in shared memory 4
    words of counters, P, a pivot row per column, an output row per row and
    an elim per row (words padded to a multiple of 4)."""
    plan = gauss_plan(m, n)
    assert set(plan) == {"threads_per_lane", "words", "smem_bytes"}
    assert plan["threads_per_lane"] == threads
    assert plan["words"] == words
    limit = 1024 if words <= 12 else 768 if words <= 16 else 640
    assert threads <= limit
    padded = -(-words // 4) * 4
    assert plan["smem_bytes"] == (4 + padded + threads + -(-m // 4) * 4
                                  + m * padded) * 4


@pytest.mark.parametrize("name, words", [("optimalH", 5), ("H02", 20)])
def test_gauss_plan_takes_the_codes(name, words):
    m, n = _h(name).shape
    plan = gauss_plan(m, n)
    assert plan["threads_per_lane"] == -(-n // 32) * 32
    assert plan["words"] == words and 32 * words >= m


@pytest.mark.parametrize("m, n", [(0, 10), (10, 0), (769, 10), (10, 1025),
                                  (385, 1000), (513, 641), (2000, 4000)])
def test_gauss_plan_refuses_beyond_its_limits(m, n):
    with pytest.raises(ValueError, match="gauss_plan"):
        gauss_plan(m, n)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(_CASES))
def test_kernel_matches_twin_on_card(cuda_device, case):
    """Active lanes bit-identical to ``gf2_eliminate_ordered``, inactive
    lanes passed through, one launch per call, and a second call
    bit-identical to the first."""
    h_np, act_np = _CASES[case]()
    h_perm = torch.from_numpy(h_np).to(cuda_device)
    active = torch.from_numpy(act_np).to(cuda_device)
    before = gauss_kernel.LAUNCHES
    got = gf2_eliminate(h_perm, active)
    torch.cuda.synchronize()
    assert gauss_kernel.LAUNCHES == before + 1
    want = gf2_eliminate_ordered(h_perm)
    assert torch.equal(got[active], want[active])
    assert torch.equal(got[~active], h_perm[~active])
    again = gf2_eliminate(h_perm, active)
    torch.cuda.synchronize()
    assert gauss_kernel.LAUNCHES == before + 2
    assert torch.equal(again, got)


@pytest.mark.gpu
@pytest.mark.parametrize("m, n", [(769, 8), (8, 1025)])
def test_kernel_refuses_shapes_beyond_its_plan_on_card(cuda_device, m, n):
    """A shape no plan takes raises on the card; it does not go to the
    twin."""
    h_perm = torch.zeros((2, m, n), dtype=torch.uint8, device=cuda_device)
    active = torch.ones(2, dtype=torch.bool, device=cuda_device)
    before = gauss_kernel.LAUNCHES
    with pytest.raises(ValueError, match="gauss_plan"):
        gf2_eliminate(h_perm, active)
    assert gauss_kernel.LAUNCHES == before
