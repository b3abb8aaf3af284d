"""AGC-ALP of the PyTorch port against the JAX package.

The whole decoder on ``data/H.txt`` (8 lanes, 0.5 dB, ``max_rounds=8``,
``max_rows=96``, kept small so JAX's compile stays short) against JAX's
``AGCALPDecoder`` on the CPU, whose backends there are the IPM with xla
matvecs and xla factor and the xla elimination: bits and success equal on
every lane, the Gaussian cut source exercised, and the per-lane rounds and
cut counters equal except where an IPM stop decision differs (see
:func:`test_whole_decoder_matches_jax`). Then JAX's own AGC-ALP checks
(``tests/test_alp.py:135-153``), the registry, the constants, the backend-
aware cut threshold, and a CPU sweep. The CUDA path is checked on the card
(marked ``gpu``; ``python -m pytest tests/test_torch_agc_alp.py -m gpu
--noconftest``).
"""
import csv
import os

import numpy as np
import pytest
import torch

from ldpc_tpu_torch.apps import benchmark
from ldpc_tpu_torch.codes.gf2 import gf2_nullspace, is_codeword
from ldpc_tpu_torch.config import DecoderConfig
from ldpc_tpu_torch.decoders import make_decoder
from ldpc_tpu_torch.decoders.agc_alp import AGCALPDecoder
from ldpc_tpu_torch.decoders.alp import ALPDecoder
from ldpc_tpu_torch.ops import chol_kernel, gauss_kernel, gemv_kernel
from test_torch_alp import _h, _llrs

try:  # the card's host has no JAX; only the gpu cases run there
    import jax
    import jax.numpy as jnp
    from ldpc_tpu.decoders import agc_alp as jagc
    from ldpc_tpu.decoders import alp as jalp
    from ldpc_tpu.decoders import make_decoder as jmake_decoder
except ImportError:
    jnp = None

DATA = os.path.join(os.path.dirname(__file__), "..", "data")
COUNTERS = ("rounds", "cum_h", "cum_g", "dropped", "count")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_whole_decoder_matches_jax():
    """Lane 5 runs out of H cuts, takes 58 gauss cuts and certifies in its
    8th round in both packages, with equal counters.

    Lane 6 is the one whose counters differ, and the difference is an IPM
    stop decision, not a cut rule: after its second round both packages
    hold the same 24 cuts, but JAX's solve stops one 5-step chunk earlier
    (its plateau test reads errors that differ from the port's in the last
    float32 bits), at a point whose largest distance from integrality is
    3.5e-4 against the port's 2.5e-5. Five H rows read violated there by
    just over cut_tol = 3e-4, so JAX appends them and works one more round
    (4 rounds, 29 cuts) where the port's lane is done (3 rounds, 24 cuts).
    Both certify the same codeword."""
    h = _h("H")
    llrs, cw = _llrs(h, 8, 0.5, seed=3)
    kw = dict(max_rounds=8, max_rows=96)
    jdec = jagc.AGCALPDecoder(h, **kw)
    jst = jax.jit(jdec._run_loop)(jnp.asarray(llrs))
    want = jdec._finish(jst)
    dec = AGCALPDecoder(h, **kw)
    assert dec.lp_backend == "ipm" and jdec.lp_backend == "ipm"
    st = dec._run_loop(torch.from_numpy(llrs))
    got = dec._finish(st)
    np.testing.assert_array_equal(got.bits.numpy(), np.asarray(want.bits))
    np.testing.assert_array_equal(got.success.numpy(),
                                  np.asarray(want.success))
    np.testing.assert_array_equal(got.bits.numpy(), cw)
    assert int(st["cum_g"][5]) == 58 == int(jst["cum_g"][5])
    same = np.arange(8) != 6
    for key in COUNTERS:
        np.testing.assert_array_equal(st[key].numpy()[same],
                                      np.asarray(jst[key])[same], err_msg=key)
    assert (int(st["rounds"][6]), int(st["cum_h"][6])) == (3, 24)
    assert (int(jst["rounds"][6]), int(jst["cum_h"][6])) == (4, 29)
    assert int(st["dropped"].sum()) == 0


def test_agc_alp_noiseless_and_noisy(small_h):
    """``tests/test_alp.py:135-153`` on the port: noiseless lanes certify
    the sent word; noisy certified outputs are codewords, and AGC-ALP
    certifies at least as many frames as ALP less one."""
    g, _ = gf2_nullspace(small_h)
    rng = np.random.default_rng(4)
    cw = (rng.integers(0, 2, (16, g.shape[0])) @ g) % 2
    clean = ((1.0 - 2.0 * cw) * 6.0).astype(np.float32)
    dec = AGCALPDecoder(small_h, lp_iters=800, max_rounds=20)
    res = dec.decode_batch(torch.from_numpy(clean))
    assert bool(res.success.all())
    np.testing.assert_array_equal(res.bits.numpy(), cw)
    llrs, _ = _llrs(small_h, 16, 2.0, seed=7)
    res_agc = dec.decode_batch(torch.from_numpy(llrs))
    res_alp = ALPDecoder(small_h, lp_iters=800, max_rounds=20).decode_batch(
        torch.from_numpy(llrs))
    ok = res_agc.success
    valid = is_codeword(torch.from_numpy(small_h), res_agc.bits)
    assert bool(valid[ok].all())
    assert int(ok.sum()) >= int(res_alp.success.sum()) - 1
    st = dec.stats(torch.from_numpy(llrs))
    assert set(st) == {"count", "rounds", "integral", "done", "viol",
                       "dropped", "cum_h", "cum_g"}
    assert bool((st["count"] == st["cum_h"] + st["cum_g"]).all())


@pytest.mark.parametrize("kind", ["agc-alp", "agcalp", "agc", "AGC-ALP"])
def test_registry_gives_jax_defaults(kind, small_h):
    dec = make_decoder(kind, small_h)
    jdec = jmake_decoder(kind, small_h)
    assert isinstance(dec, AGCALPDecoder) and dec.name == "AGC-ALP"
    for attr in ("max_rows", "max_rounds", "lp_iters", "int_tol", "cut_tol",
                 "gauss_eps", "gauss_margin", "snap_tol", "lp_backend",
                 "gauss_backend", "capacity", "_tiers", "ipm_iters",
                 "ipm_tol", "ipm_check_every", "ipm_warm", "lp_tol",
                 "lp_max_iters", "stall_ratio", "perturb", "name"):
        assert getattr(dec, attr) == getattr(jdec, attr), attr
    cfg = DecoderConfig(agc_max_rows=200, lp_max_rounds=9)
    small = make_decoder(kind, small_h, cfg)
    assert (small.max_rows, small.max_rounds) == (200, 9)


def test_constants_at_the_reference_configuration():
    """optimalH at JAX's defaults: capacity 1408 cut rows per lane, row
    tiers 128/256/384/512/640/896/1152, the IPM's 40/1e-5/5/warm."""
    h = _h("optimalH")
    dec = AGCALPDecoder(h)
    jdec = jagc.AGCALPDecoder(h)
    assert dec.capacity == jdec.capacity == 1408
    assert dec._tiers == jdec._tiers == (128, 256, 384, 512, 640, 896, 1152)
    assert (dec.ipm_iters, dec.ipm_tol, dec.ipm_check_every, dec.ipm_warm) \
        == (jdec.ipm_iters, jdec.ipm_tol, jdec.ipm_check_every,
            jdec.ipm_warm) == (40, 1e-5, 5, True)
    assert (dec.ipm_matvec_backend, dec.ipm_factor_backend) == ("auto",
                                                                "auto")


@pytest.mark.parametrize("cls", ["ALP", "AGC-ALP"])
def test_cut_tol_checked_against_the_backend_in_use(cls, small_h):
    """The threshold must exceed the tolerance of the solver in use:
    ipm_tol 1e-5 with the IPM, lp_tol 3e-4 with PDHG (JAX ``alp.py:203-
    204``). AGC-ALP's own default, 3e-4 = lp_tol, is legal with the IPM."""
    port = ALPDecoder if cls == "ALP" else AGCALPDecoder
    jax_cls = jalp.ALPDecoder if cls == "ALP" else jagc.AGCALPDecoder
    dec = port(small_h, lp_backend="ipm", cut_tol=3e-4)
    assert dec.lp_backend == "ipm" and dec.cut_tol == 3e-4
    jax_cls(small_h, lp_backend="ipm", cut_tol=3e-4)
    with pytest.raises(ValueError, match="cut_tol"):
        port(small_h, lp_backend="ipm", cut_tol=1e-5)
    with pytest.raises(AssertionError, match="cut_tol"):
        jax_cls(small_h, lp_backend="ipm", cut_tol=1e-5)
    with pytest.raises(ValueError, match="cut_tol"):
        port(small_h, lp_backend="xla", cut_tol=3e-4)
    with pytest.raises(AssertionError, match="cut_tol"):
        jax_cls(small_h, lp_backend="xla", cut_tol=3e-4)


def test_alp_with_ipm_backend_decodes(small_h):
    """Plain ALP takes the IPM too (JAX ``alp.py:279-290``): noiseless lanes
    certify in one round."""
    g, _ = gf2_nullspace(small_h)
    rng = np.random.default_rng(9)
    cw = (rng.integers(0, 2, (4, g.shape[0])) @ g) % 2
    clean = ((1.0 - 2.0 * cw) * 6.0).astype(np.float32)
    res = ALPDecoder(small_h, lp_backend="ipm").decode_batch(
        torch.from_numpy(clean))
    assert bool(res.success.all()) and bool((res.iterations == 1).all())
    np.testing.assert_array_equal(res.bits.numpy(), cw)
    with pytest.raises(ValueError, match="gauss_backend"):
        AGCALPDecoder(small_h, gauss_backend="pallas")


def test_sweep_runs_agc_alp_on_cpu(tmp_path):
    rep, ext = tmp_path / "r.csv", tmp_path / "re.csv"
    before = (gauss_kernel.LAUNCHES, gemv_kernel.GEMV_LAUNCHES,
              chol_kernel.LAUNCHES)
    rows = benchmark.main([
        "--matrix", os.path.join(DATA, "H.txt"), "--decoders", "agc-alp",
        "--snrs=1.0", "--trials", "16", "--report", str(rep),
        "--extended-report", str(ext), "--device", "cpu"])
    assert [(name, snr) for name, snr, _ in rows] == [("AGC-ALP", 1.0)]
    assert (gauss_kernel.LAUNCHES, gemv_kernel.GEMV_LAUNCHES,
            chol_kernel.LAUNCHES) == before
    with open(rep) as f:
        recs = list(csv.DictReader(f))
    assert [r["Method"] for r in recs] == ["AGC-ALP"]
    with open(ext) as f:
        ext_rec = list(csv.DictReader(f))[0]
    res = rows[0][2]
    assert res.total == int(ext_rec["Trials"]) == 16
    assert 0.0 <= res.fer <= 1.0 and res.sum_iterations >= 16
    assert int(ext_rec["Dropped"]) == 0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_agc_alp_on_card_kernels_vs_plain(cuda_device):
    """optimalH, 32 lanes at -2 dB: the kernel backends (the default on
    CUDA) against the plain ones; every kernel of the path launched,
    success agreeing on >= 90 % of lanes (the IPM's stop decisions differ
    in float32 rounding, see test_whole_decoder_matches_jax)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    h = _h("optimalH")
    llrs, _ = _llrs(h, 32, -2.0, seed=8)
    lam = torch.from_numpy(llrs).to(cuda_device)
    counts = lambda: (gauss_kernel.LAUNCHES, gemv_kernel.GEMV_LAUNCHES,
                      gemv_kernel.GEMV_T_LAUNCHES,
                      gemv_kernel.NORMAL_LAUNCHES, chol_kernel.LAUNCHES)
    before = counts()
    res = AGCALPDecoder(h, device=cuda_device).decode_batch(lam)
    assert all(a > b for a, b in zip(counts(), before))
    plain = AGCALPDecoder(h, gauss_backend="xla", device=cuda_device)
    plain.ipm_matvec_backend = plain.ipm_factor_backend = "xla"
    ref = plain.decode_batch(lam)
    assert (res.success == ref.success).float().mean().item() >= 0.9
    ok = res.success
    assert bool(is_codeword(torch.from_numpy(h).to(cuda_device),
                            res.bits)[ok].all())
