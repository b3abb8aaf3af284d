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
from ldpc_tpu_torch.ops.gauss_kernel import gf2_eliminate
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


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["optimalH", "H02"])
def test_kernel_matches_twin_on_card(cuda_device, name):
    """128 lanes, a third inactive: active lanes bit-identical to the twin,
    inactive lanes passed through."""
    h = _h(name)
    rng = np.random.default_rng(6)
    u = torch.from_numpy(_u(rng, 128, h.shape[1])).to(cuda_device)
    ht = torch.from_numpy(h).to(cuda_device)
    p = fractional_column_order(u)
    idx = p[:, None, :].expand(128, *h.shape)
    h_perm = ht.expand(128, *h.shape).gather(2, idx).contiguous()
    active = torch.arange(128, device=cuda_device) % 3 != 0
    before = gauss_kernel.LAUNCHES
    got = gf2_eliminate(h_perm, active)
    want = gf2_eliminate_ordered(h_perm)
    torch.cuda.synchronize()
    assert gauss_kernel.LAUNCHES == before + 1
    assert torch.equal(got[active], want[active])
    assert torch.equal(got[~active], h_perm[~active])
