"""The readers of the fused Cholesky factor (``chol_factor_roofline``,
``ipm.fused_factor_share``, both in ``agcalp-optimalH-m3db``) and the
factor's count (``counts/chol_factor.py``), on the CPU: hand-worked counts,
the readers on hand-made counters and summaries, and nothing read on a
program without the fused factor (the commit before it)."""
from collections import Counter

import pytest
import torch

from ldpc_bench.cell import Cell
from ldpc_bench.counts import chol_factor
from ldpc_bench.counts.peaks import PEAKS
from ldpc_bench.trace import Context
from ldpc_tpu_torch.ops import chol_kernel, ipm_solver

CELL = "agcalp-optimalH-m3db"
NEW = ("chol_factor_roofline", "ipm.fused_factor_share")
H100 = PEAKS["NVIDIA H100 80GB HBM3"]


def _reader(name):
    return Cell(CELL).metric(name)


class _Dec:
    ipm_check_every = 5


def _ctx():
    return Context(_Dec(), {}, torch.device("cpu"), H100)


def test_the_cell_lists_the_new_metrics():
    names = {m["name"] for m in Cell(CELL).per_layer}
    assert set(NEW) <= names
    for name in NEW:
        assert hasattr(_reader(name), "read")


def test_counts_by_hand():
    """n = 64: the factor 64^3 / 3 and one block's inverse as much; M read
    (4096 floats), L's and the block's lower triangles written (2080
    each). n = 280: blocks of 64, 64, 64, 64 and 24 columns."""
    assert chol_factor.flops(1, 64) == pytest.approx(2 * 64 ** 3 / 3)
    assert chol_factor.bytes_moved(1, 64) == 4 * (4096 + 2080 + 2080)
    assert chol_factor.flops(2, 280) == pytest.approx(
        2 * (280 ** 3 / 3 + 4 * 64 ** 3 / 3 + 24 ** 3 / 3))
    assert chol_factor.bytes_moved(128, 280) == 4 * 128 * (
        280 * 280 + 280 * 281 / 2 + 4 * 2080 + 300)


def _summary(factor_us, solve_us=0.0):
    return {"device_us_by_name": {
        "_anonymous_namespace_::chol_factor_kernel(float const*, float*)":
            factor_us,
        "_anonymous_namespace_::chol_solve_kernel(float const*)": solve_us,
        "normal_build_kernel": 99.0}}


def test_roofline_reader_on_hand_made_counts(monkeypatch):
    monkeypatch.setattr(chol_kernel, "FACTOR_SHAPE_LAUNCHES",
                        Counter({(128, 280): 10}))
    monkeypatch.setattr(chol_kernel, "SOLVE_LAUNCHES", 20)
    mod, ctx = _reader("chol_factor_roofline"), _ctx()
    mod.install(ctx)
    chol_kernel.FACTOR_SHAPE_LAUNCHES.update({(128, 280): 100,
                                              (64, 280): 4})
    chol_kernel.SOLVE_LAUNCHES += 208
    bound = (100 * max(chol_factor.flops(128, 280) / H100["fp32_flops"],
                       chol_factor.bytes_moved(128, 280)
                       / H100["hbm_bytes_s"])
             + 4 * max(chol_factor.flops(64, 280) / H100["fp32_flops"],
                       chol_factor.bytes_moved(64, 280)
                       / H100["hbm_bytes_s"]))
    got = mod.read(ctx, _summary(8000.0, 1500.0))
    assert got == pytest.approx(100.0 * bound / 8e-3)
    notes = ctx.notes["chol_factor_roofline"]
    assert notes["launches"] == 104 and notes["binds"] == "bytes"
    assert notes["launches_by_shape"] == {"64x280": 4, "128x280": 100}
    assert notes["solve_s"] == pytest.approx(1.5e-3)
    assert notes["solve_launches"] == 208
    assert mod.read(ctx, _summary(0.0)) is None


def test_share_reader_on_hand_made_counts(monkeypatch):
    monkeypatch.setattr(chol_kernel, "FACTOR_LAUNCHES", 7)
    monkeypatch.setattr(ipm_solver, "COUNTS", Counter(chunks=3))
    mod, ctx = _reader("ipm.fused_factor_share"), _ctx()
    mod.install(ctx)
    ipm_solver.COUNTS["chunks"] += 40
    chol_kernel.FACTOR_LAUNCHES += 200
    assert mod.read(ctx, {}) == pytest.approx(1.0)
    assert ctx.notes["ipm.fused_factor_share"] == {"factor_launches": 200,
                                                   "newton_steps": 200}
    chol_kernel.FACTOR_LAUNCHES -= 50
    assert mod.read(ctx, {}) == pytest.approx(0.75)


@pytest.mark.parametrize("name", NEW)
def test_readers_read_nothing_on_a_program_without_them(name, monkeypatch):
    monkeypatch.delattr(chol_kernel, "FACTOR_SHAPE_LAUNCHES")
    monkeypatch.delattr(chol_kernel, "FACTOR_LAUNCHES")
    mod, ctx = _reader(name), _ctx()
    mod.install(ctx)
    assert mod.read(ctx, _summary(8000.0)) is None


def test_share_reads_nothing_without_newton_steps():
    mod, ctx = _reader("ipm.fused_factor_share"), _ctx()
    mod.install(ctx)
    assert mod.read(ctx, {}) is None
