"""The plain references agree with themselves, and with the program's own
plain twins, on small codes on the CPU."""
import numpy as np
import pytest
import torch

from ldpc_bench.cell import ROOT, Cell
from ldpc_bench.reference import alp, bp, channel, classify, gf2

SMALL = str(ROOT / "data" / "H.txt")
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def small():
    h = gf2.read_matrix(SMALL)
    g = gf2.nullspace(h)
    gen = torch.Generator().manual_seed(5)
    coeffs = torch.randint(0, 2, (48, g.shape[0]), generator=gen,
                           dtype=torch.float32)
    return h, g, gf2.codewords(coeffs, g)


def test_nullspace_is_the_programs_and_orthogonal(small):
    from ldpc_tpu_torch.codes.gf2 import _nullspace_numpy
    h, g, cw = small
    assert not ((h.astype(np.int64) @ g.T.astype(np.int64)) % 2).any()
    assert np.array_equal(g, _nullspace_numpy(h)[0])
    assert bool(gf2.syndrome_zero(torch.from_numpy(h), cw).all())


def test_optimalh_reads_as_the_frozen_copy():
    c = Cell("bp100-optimalH-m3db")
    h = gf2.read_matrix(str(c.code_path))
    assert h.shape == (160, 280) and int(h.sum()) == 900
    assert np.array_equal(h, gf2.read_matrix(str(ROOT / "data" /
                                                  "optimalH.txt")))


@pytest.mark.parametrize("control", [False, True])
def test_channel_repeats_and_matches_the_program(small, control):
    from ldpc_tpu_torch.channel.awgn import noise_scales, transmit
    _, _, cw = small
    idx = torch.arange(100, 148)
    y = channel.received(cw, -3.0, 2**31 + 7, idx, control)
    assert torch.equal(y, channel.received(cw, -3.0, 2**31 + 7, idx,
                                           control))
    y_p = transmit(cw, -3.0, 2**31 + 7, idx)
    llr_p = noise_scales(-3.0)[1] * y_p
    gap = (channel.llrs(y, -3.0) - llr_p).abs().max().item()
    if control:
        assert 0.0 < gap < 1e-3
    else:
        assert gap == 0.0


def test_tf32_rounding():
    v = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 3 * 2**-11, -2.5, 0.0])
    r = alp._tf32(v)
    assert r.tolist() == [1.0, 1.0, 1.0 + 4 * 2**-11, -2.5, 0.0]


def _llrs(h, g, lanes, snr, seed):
    gen = torch.Generator().manual_seed(seed)
    coeffs = torch.randint(0, 2, (lanes, g.shape[0]), generator=gen,
                           dtype=torch.float32)
    cw = gf2.codewords(coeffs, g)
    y = channel.received(cw, snr, seed, torch.arange(lanes))
    return cw, y, channel.llrs(y, snr)


def test_bp_lanes_are_independent_and_equal_the_twin(small):
    from ldpc_tpu_torch.decoders.bp import BPDecoder
    h, g, _ = small
    cw, y, llr = _llrs(h, g, 64, 1.0, 11)
    t = bp.prepare(h, {"bp_max_iter": 30}, CPU)
    whole = bp.decode(t, llr)
    halves = [bp.decode(t, part) for part in (llr[:32], llr[32:])]
    for k in ("bits", "success", "iterations"):
        assert torch.equal(whole[k], torch.cat([p[k] for p in halves]))
    prog = BPDecoder(h, max_iter=30, device="cpu").decode_batch(llr)
    assert not bp.lanes_differ({"bits": prog.bits, "success": prog.success,
                                "iterations": prog.iterations}, whole)[
        "lanes_differ"].any()
    ctr = classify.counters(torch.from_numpy(h), whole, cw, y)
    assert ctr[0] == 64 and 0 < ctr[1] <= 64 and ctr[6] > 0


def test_bp_control_differs(small):
    h, g, _ = small
    _, _, llr = _llrs(h, g, 64, 1.0, 12)
    t = bp.prepare(h, {"bp_max_iter": 30}, CPU)
    d = bp.lanes_differ(bp.decode(t, llr, control=True), bp.decode(t, llr))
    assert d["lanes_differ"].any()


def test_alp_repeats_and_equals_the_programs_kernel_path(small):
    from ldpc_tpu_torch.decoders.alp import ALPDecoder
    h, g, _ = small
    cfg = Cell("alp-optimalH-m3db").reference_config()
    dec = ALPDecoder(h, device="cpu")
    dec.lp_backend = "kernel"         # the fused loop, its twin on the CPU
    cfg.update(max_rows=dec.max_rows, capacity=dec.capacity,
               row_tiers=list(dec._tiers))
    cw, y, llr = _llrs(h, g, 24, 1.0, 13)
    t = alp.prepare(h, cfg, CPU)
    a, b = alp.decode(t, llr), alp.decode(t, llr)
    for k in ("bits", "success", "iterations", "dropped"):
        assert torch.equal(a[k], b[k])
    prog = dec.decode_batch(llr)
    d = alp.lanes_differ({"bits": prog.bits, "success": prog.success,
                          "iterations": prog.iterations}, a)
    assert not d["lanes_differ"].any()
    assert torch.equal(prog.dropped, a["dropped"])
