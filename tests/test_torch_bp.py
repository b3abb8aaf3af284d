"""BP decoder of the PyTorch port against the JAX package.

The CPU route (``ops/bp_ref.py``) is held to JAX's float32 BP layouts (and to
the TPU kernel in Pallas interpret mode) on the same numpy LLRs, with the
rule of ``tests/test_bp.py``: success flags equal on every lane, bits and
iterations equal on the lanes that succeeded. The CUDA kernel is held to
``bp_ref`` on the card (marked ``gpu``; run there with
``python -m pytest tests/test_torch_bp.py -m gpu --noconftest``, where the
JAX-side imports are absent).
"""
import os

import numpy as np
import pytest
import torch

from ldpc_tpu_torch.channel.awgn import llr_variance
from ldpc_tpu_torch.codes.gf2 import gf2_nullspace
from ldpc_tpu_torch.codes.graph import CodeGraph
from ldpc_tpu_torch.codes.io import read_pcm
from ldpc_tpu_torch.decoders.bp import BPDecoder
from ldpc_tpu_torch.ops import bp_kernel
from ldpc_tpu_torch.ops.bp_ref import bp_decode_ref, check_update_rowlayout

try:  # the card's host has no JAX; only the gpu case runs there
    import jax.numpy as jnp
    from ldpc_tpu.decoders.bp import BPDecoder as JBPDecoder
    from ldpc_tpu.decoders.bp import _check_update_rowlayout
except ImportError:
    jnp = None

DATA = os.path.join(os.path.dirname(__file__), "..", "data")
CPU = torch.device("cpu")


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


def _assert_same_decode(res, ref_bits, ref_success, ref_iters):
    ok = np.asarray(ref_success)
    np.testing.assert_array_equal(res.success.numpy(), ok)
    np.testing.assert_array_equal(res.bits.numpy()[ok],
                                  np.asarray(ref_bits)[ok])
    np.testing.assert_array_equal(res.iterations.numpy()[ok],
                                  np.asarray(ref_iters)[ok])


def _jax_decoder(h, layout, **kw):
    if layout == "mxu-f32":
        return JBPDecoder(h, layout="mxu", mxu_dtype=jnp.float32, **kw)
    return JBPDecoder(h, layout=layout, **kw)


@pytest.mark.parametrize("layout", ["edge", "mxu-f32"])
@pytest.mark.parametrize("snr", [0.0, -3.0])
@pytest.mark.parametrize("name,lanes", [("H", 256), ("optimalH", 256)])
def test_bp_ref_matches_jax(name, lanes, snr, layout):
    h = _h(name)
    llrs, _ = _llrs(h, lanes, snr, seed=int(10 * snr) + lanes)
    ref = _jax_decoder(h, layout, max_iter=30).decode_batch(jnp.asarray(llrs))
    res = BPDecoder(h, max_iter=30, device=CPU).decode_batch(
        torch.from_numpy(llrs))
    assert res.bits.dtype == torch.uint8 and res.success.dtype == torch.bool
    assert res.iterations.dtype == torch.int32
    _assert_same_decode(res, ref.bits, ref.success, ref.iterations)
    # a lane that never succeeds reports max_iter
    assert (res.iterations.numpy()[~res.success.numpy()] == 30).all()


def test_bp_ref_matches_scalar_oracle(tiny_h):
    from test_bp import scalar_bp_reference
    llrs, _ = _llrs(tiny_h, 32, 2.0, seed=7)
    res = BPDecoder(tiny_h, max_iter=20, device=CPU).decode_batch(
        torch.from_numpy(llrs))
    for t in range(32):
        bits, ok, iters = scalar_bp_reference(
            tiny_h, llrs[t].astype(np.float64), 20)
        assert bool(res.success[t]) == ok, f"trial {t}"
        if ok:
            np.testing.assert_array_equal(res.bits[t].numpy(), bits)
            assert int(res.iterations[t]) == iters


@pytest.mark.parametrize("variant", ["sumprod", "minsum"])
def test_check_update_matches_jax(opt_h, variant):
    g = CodeGraph.from_h(opt_h)
    rng = np.random.default_rng(3)
    v2c = rng.normal(0.0, 4.0, (16, g.m, g.dc_max)).astype(np.float32)
    v2c[..., 0] = np.where(rng.random((16, g.m)) < 0.1, 0.0, v2c[..., 0])
    v2c = np.where(g.row_mask, v2c, 64.0).astype(np.float32)
    out = check_update_rowlayout(torch.from_numpy(v2c),
                                 torch.from_numpy(g.row_mask), variant, 0.75)
    ref = _check_update_rowlayout(jnp.asarray(v2c), jnp.asarray(g.row_mask),
                                  variant, 0.75)
    # float32 with another summation order: a few ulp
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("variant,fixed", [("minsum", False),
                                           ("sumprod", True),
                                           ("minsum", True)])
def test_variants_match_jax_edge(small_h, variant, fixed):
    llrs, _ = _llrs(small_h, 128, 1.0, seed=11)
    kw = dict(max_iter=25, variant=variant, fixed_iters=fixed)
    ref = JBPDecoder(small_h, layout="edge", **kw).decode_batch(
        jnp.asarray(llrs))
    res = BPDecoder(small_h, **kw, device=CPU).decode_batch(
        torch.from_numpy(llrs))
    _assert_same_decode(res, ref.bits, ref.success, ref.iterations)


@pytest.mark.parametrize("variant,fixed", [("minsum", False),
                                           ("sumprod", True),
                                           ("minsum", True)])
def test_variants_through_registry_match_jax_mxu(small_h, variant, fixed):
    """``minsum`` and ``fixed_iters`` as a user builds them: the registry
    (``bp_variant``) and ``fixed_iters``, held against JAX's default ``mxu``
    layout in float32, the layout that serves them on the accelerator."""
    from ldpc_tpu_torch.config import DecoderConfig
    from ldpc_tpu_torch.decoders import make_decoder
    llrs, _ = _llrs(small_h, 128, 1.0, seed=17)
    dec = make_decoder("bp", small_h, DecoderConfig(bp_max_iter=25,
                                                    bp_variant=variant),
                       device=CPU)
    dec.fixed_iters = fixed
    assert dec.variant == variant
    ref = _jax_decoder(small_h, "mxu-f32", max_iter=25, variant=variant,
                       fixed_iters=fixed).decode_batch(jnp.asarray(llrs))
    res = dec.decode_batch(torch.from_numpy(llrs))
    _assert_same_decode(res, ref.bits, ref.success, ref.iterations)


def test_decoder_from_jax_graph_arrays(opt_h):
    jdec = JBPDecoder(opt_h, layout="edge", max_iter=30)
    graph = CodeGraph.from_arrays(jdec.graph.__dict__)
    llrs, _ = _llrs(opt_h, 128, -2.0, seed=5)
    res = BPDecoder(graph, max_iter=30, device=CPU).decode_batch(
        torch.from_numpy(llrs))
    ref = jdec.decode_batch(jnp.asarray(llrs))
    _assert_same_decode(res, ref.bits, ref.success, ref.iterations)
    direct = BPDecoder(opt_h, max_iter=30, device=CPU).decode_batch(
        torch.from_numpy(llrs))
    for a, b in zip(res[:3], direct[:3]):
        assert torch.equal(a, b)


def test_bp_ref_matches_pallas_kernel_interpreted(small_h, monkeypatch):
    """The TPU kernel the CUDA kernel replaces, run by the Pallas
    interpreter with float32 matmuls, on the same LLRs as bp_ref."""
    from jax.experimental import pallas as pl
    from ldpc_tpu.ops.pallas.bp_kernel import make_bp_pallas_decoder
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        lambda *a, **k: orig(*a, **dict(k, interpret=True)))
    llrs, _ = _llrs(small_h, 64, 0.0, seed=13)
    dec = make_bp_pallas_decoder(small_h, max_iter=15, tile_b=64,
                                 mm_dtype=jnp.float32)
    bits, done, iters = dec(jnp.asarray(llrs))
    res = BPDecoder(small_h, max_iter=15, device=CPU).decode_batch(
        torch.from_numpy(llrs))
    _assert_same_decode(res, bits, np.asarray(done)[:, 0] > 0,
                        np.asarray(iters)[:, 0])


def test_bp_ref_edge_cases(small_h):
    g = CodeGraph.from_h(small_h)
    dec = BPDecoder(g, max_iter=0, device=CPU)
    llrs, _ = _llrs(small_h, 8, 0.0, seed=1)
    res = dec.decode_batch(torch.from_numpy(llrs))
    np.testing.assert_array_equal(res.bits.numpy(),
                                  (llrs <= 0).astype(np.uint8))
    assert not res.success.any() and (res.iterations == 0).all()
    empty = BPDecoder(g, max_iter=5, device=CPU).decode_batch(
        torch.zeros(0, g.n))
    assert empty.bits.shape == (0, g.n) and empty.success.shape == (0,)
    with pytest.raises(ValueError):
        BPDecoder(small_h, variant="bogus", device=CPU)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name,snr", [("optimalH", -3.0), ("optimalH", 0.0),
                                      ("H02", -6.0)])
def test_kernel_matches_bp_ref_on_card(cuda_device, name, snr):
    h = _h(name)
    llrs, _ = _llrs(h, 1000, snr, seed=21)       # not a multiple of any tile
    dec = BPDecoder(h, max_iter=50, device=cuda_device)
    lam = torch.from_numpy(llrs).to(cuda_device)
    before = bp_kernel.LAUNCHES
    bits, success, iters = bp_kernel.bp_decode(lam, dec.row_col,
                                               dec.col_from_row, 50)
    torch.cuda.synchronize()
    assert bp_kernel.LAUNCHES == before + 1
    ref = bp_decode_ref(lam, dec.row_col, dec.row_mask, dec.col_mask,
                        dec.row_from_col, dec.col_from_row, 50)
    same = (success == ref.success) & (iters == ref.iterations)
    assert same.float().mean().item() >= 0.995
    both = same & success
    assert torch.equal(bits[both], ref.bits[both])
    via_decoder = dec.decode_batch(lam)
    assert torch.equal(via_decoder.success, success)
    # minsum runs on the card through bp_ref, as JAX's XLA layouts run it
    before = bp_kernel.LAUNCHES
    ms = BPDecoder(h, max_iter=50, variant="minsum",
                   device=cuda_device).decode_batch(lam)
    ms_cpu = BPDecoder(h, max_iter=50, variant="minsum",
                       device=CPU).decode_batch(lam.cpu())
    assert bp_kernel.LAUNCHES == before
    for got, want in zip(ms[:3], ms_cpu[:3]):
        assert torch.equal(got.cpu(), want)
    with pytest.raises(TypeError):
        bp_kernel.bp_decode(lam.double(), dec.row_col, dec.col_from_row, 50)


@pytest.mark.gpu
@pytest.mark.parametrize("variant,fixed", [("minsum", False),
                                           ("sumprod", True),
                                           ("minsum", True)])
def test_variants_on_card_equal_cpu(cuda_device, variant, fixed):
    """``minsum`` and ``fixed_iters`` decode on the card (through ``bp_ref``,
    no kernel launch) and equal the same decoder on the CPU."""
    h = _h("optimalH")
    llrs, _ = _llrs(h, 300, -1.0, seed=23)
    kw = dict(max_iter=30, variant=variant, fixed_iters=fixed)
    before = bp_kernel.LAUNCHES
    res = BPDecoder(h, **kw, device=cuda_device).decode_batch(
        torch.from_numpy(llrs).to(cuda_device))
    torch.cuda.synchronize()
    assert bp_kernel.LAUNCHES == before
    ref = BPDecoder(h, **kw, device=CPU).decode_batch(torch.from_numpy(llrs))
    same = (res.success.cpu() == ref.success) & (
        res.iterations.cpu() == ref.iterations)
    assert same.float().mean().item() >= 0.995
    both = same & ref.success
    assert torch.equal(res.bits.cpu()[both], ref.bits[both])


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["optimalH", "H02"])
def test_kernel_repeat_and_batch_slices_on_card(cuda_device, name):
    """A batch that fills no wave evenly: a second call is bit-identical,
    and a codeword's decode depends on its own LLRs alone, so the first 7
    lanes decoded alone equal them in the whole batch; one launch per
    call."""
    h = _h(name)
    llrs, _ = _llrs(h, 1003, -1.0, seed=4)
    dec = BPDecoder(h, max_iter=40, device=cuda_device)
    lam = torch.from_numpy(llrs).to(cuda_device)
    before = bp_kernel.LAUNCHES
    runs = [bp_kernel.bp_decode(lam, dec.row_col, dec.col_from_row, 40)
            for _ in range(2)]
    part = bp_kernel.bp_decode(lam[:7].contiguous(), dec.row_col,
                               dec.col_from_row, 40)
    torch.cuda.synchronize()
    assert bp_kernel.LAUNCHES == before + 3
    for got, want, piece in zip(runs[1], runs[0], part):
        assert torch.equal(got, want)
        assert torch.equal(piece, want[:7])


@pytest.mark.gpu
def test_kernel_refuses_shapes_it_cannot_hold_on_card(cuda_device):
    """A row degree above 32 (the sign parity is a 32-bit mask) is refused
    before any launch."""
    h = np.zeros((2, 40), dtype=np.uint8)
    h[0, :33] = 1
    h[1, 30:] = 1
    dec = BPDecoder(h, max_iter=5, device=cuda_device)
    lam = torch.ones((3, 40), device=cuda_device)
    before = bp_kernel.LAUNCHES
    with pytest.raises(ValueError, match="row degree 33"):
        bp_kernel.bp_decode(lam, dec.row_col, dec.col_from_row, 5)
    assert bp_kernel.LAUNCHES == before


@pytest.mark.gpu
def test_kernel_edge_cases_on_card(cuda_device):
    h = _h("H")
    dec = BPDecoder(h, max_iter=0, device=cuda_device)
    llrs, _ = _llrs(h, 37, 0.0, seed=2)
    lam = torch.from_numpy(llrs).to(cuda_device)
    bits, success, iters = bp_kernel.bp_decode(lam, dec.row_col,
                                               dec.col_from_row, 0)
    assert torch.equal(bits.cpu(), (lam <= 0).to(torch.uint8).cpu())
    assert not success.any() and (iters == 0).all()
    before = bp_kernel.LAUNCHES
    empty = bp_kernel.bp_decode(lam[:0], dec.row_col, dec.col_from_row, 5)
    assert empty[0].shape == (0, dec.n) and bp_kernel.LAUNCHES == before
    with pytest.raises(ValueError, match="contiguous"):
        bp_kernel.bp_decode(lam.t().contiguous().t(), dec.row_col,
                            dec.col_from_row, 5)
    with pytest.raises(ValueError, match="columns"):
        bp_kernel.bp_decode(lam[:, :-1].contiguous(), dec.row_col,
                            dec.col_from_row, 5)
    with pytest.raises(ValueError, match="CUDA tensor"):
        bp_kernel.bp_decode(lam, dec.row_col.cpu(), dec.col_from_row, 5)
