"""The AGC-ALP cell, ``agcalp-optimalH-m3db``, on the CPU:

* its files are found by name, and its configuration's ``assumed`` holds
  the constants the program's decoder runs with;
* its plain reference (``reference/agc-alp.py``) repeats bit for bit, agrees
  with the program's plain path (the IPM on its ``xla`` backends, no CUDA
  graphs, the plain elimination) on a small code in every lane's
  certificate and word, and differs under ``control``;
* the counts of its two kernels reproduce hand-worked shapes, and its
  readers read hand-made records and return None on a program without what
  they read;
* a small run of the cell comes out correct when its lanes are not coupled
  (one lane a batch), records a streamed block exactly when they are, and
  comes out not correct under the control, with the program's Gaussian cut
  source switched off (ALP's cuts only, still with the IPM), and with a
  trial recorded twice.

The harness's look for a chip is skipped (``device="cpu"``).
"""
import inspect
import json
from collections import Counter

import numpy as np
import pytest
import torch

from ldpc_bench import calibrate, record, run
from ldpc_bench.cell import ROOT, Cell
from ldpc_bench.check import verdict
from ldpc_bench.counts import gf2_gauss, normal_build
from ldpc_bench.counts.peaks import PEAKS, bound_s
from ldpc_bench.metrics import _program
from ldpc_bench.reference import alp, channel, gf2
from ldpc_bench.tests.test_bench_stream import _twice
from ldpc_bench.trace import Context

CELL = "agcalp-optimalH-m3db"
SMALL = str(ROOT / "data" / "H.txt")
SEED = 2**31 + 59
H100 = PEAKS["NVIDIA H100 80GB HBM3"]
NEW = ("normal_build_roofline", "gf2_gauss_roofline", "agc.gauss_lane_share",
       "ipm.sync_reads_per_trial")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _decoder(h):
    from ldpc_tpu_torch.config import DecoderConfig
    from ldpc_tpu_torch.decoders import make_decoder
    return make_decoder("agc-alp", h, DecoderConfig(
        **Cell(CELL).config["decoder_config"]), device="cpu")


def test_cell_files_found_by_name():
    c = Cell(CELL)
    assert c.code_path.is_file() and c.config["decoder"] == "agc-alp"
    assert c.config["batch"] == 128 and c.config["reduced"] == []
    assert c.traffic["snr_db"] == -3.0 and c.traffic["block_batches"] == 8
    ref = c.reference()
    for name in ("prepare", "decode", "lanes_differ"):
        assert hasattr(ref, name)
    assert sorted(m["name"] for m in c.end_to_end) == ["cw_per_s.alp",
                                                       "setup_s"]
    names = {m["name"] for m in c.per_layer}
    assert set(NEW) | {"device.idle_share.alp", "decoder.idle_share.alp",
                       "harness.idle_share.alp"} == names
    for m in c.per_layer:
        assert hasattr(c.metric(m["name"]), "read")
    assert set(c.spec["limits"]) >= {"llr_gap", "classify_gap"}
    assert c.spec["limits"]["llr_gap"] > 0 == c.spec["limits"]["classify_gap"]


def test_assumed_constants_are_the_decoders():
    """What the reference assumes is what the program's AGC-ALP runs."""
    from ldpc_tpu_torch.decoders import alp as program
    from ldpc_tpu_torch.decoders import DEFAULT_BATCH
    from ldpc_tpu_torch.ops.ipm_solver import ipm_box_lp
    c = Cell(CELL)
    cfg = c.reference_config()
    dec = _decoder(gf2.read_matrix(str(c.code_path)))
    default = {k: p.default for k, p in
               inspect.signature(ipm_box_lp).parameters.items()}
    assert cfg["batch"] == DEFAULT_BATCH["agc-alp"]
    assert (cfg["max_rows"], cfg["capacity"], cfg["row_tiers"]) == (
        dec.max_rows, dec.capacity, list(dec._tiers))
    assert (cfg["ipm_iters"], cfg["ipm_tol"], cfg["ipm_check_every"]) == (
        dec.ipm_iters, dec.ipm_tol, dec.ipm_check_every)
    assert dec.ipm_warm and dec.lp_backend == "ipm"
    assert (cfg["ipm_delta"], cfg["ipm_warm_shift"], cfg["stall_ratio"]) == (
        default["delta"], default["warm_shift"], default["stall_ratio"])
    assert cfg["stall_ratio"] == dec.stall_ratio and \
        cfg["lp_tol"] == dec.lp_tol
    assert (cfg["cut_tol"], cfg["snap_tol"], cfg["gauss_eps"],
            cfg["perturb"]) == (dec.cut_tol, dec.snap_tol, dec.gauss_eps,
                                dec.perturb) and dec.gauss_margin == 0.0
    assert (cfg["perturb_seed"], cfg["hash_seed"]) == (program._PERT_SEED,
                                                       program._HASH_SEED)
    assert (cfg["lp_max_rounds"], cfg["lp_int_tol"]) == (dec.max_rounds,
                                                        dec.int_tol)


@pytest.fixture(scope="module")
def small():
    """The small code, the program's decoder on it, the reference's
    tables, and 24 lanes at 0 dB (a few of them need the Gaussian cuts)."""
    h = gf2.read_matrix(SMALL)
    g = gf2.nullspace(h)
    dec = _decoder(h)
    cfg = Cell(CELL).reference_config()
    cfg.update(max_rows=dec.max_rows, capacity=dec.capacity,
               row_tiers=list(dec._tiers))
    gen = torch.Generator().manual_seed(13)
    coeffs = torch.randint(0, 2, (24, g.shape[0]), generator=gen,
                           dtype=torch.float32)
    y = channel.received(gf2.codewords(coeffs, g), 0.0, 13, torch.arange(24))
    ref = Cell(CELL).reference()
    return dec, ref, ref.prepare(h, cfg, "cpu"), channel.llrs(y, 0.0)


def test_reference_repeats_bit_for_bit(small):
    _, ref, t, llr = small
    a, b = ref.decode(t, llr[:12]), ref.decode(t, llr[:12])
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_reference_agrees_with_the_programs_plain_path(small):
    """Batched, lane by lane: every certificate and certified word equal.
    Rounds and cut counts: the two run the same float32 operations in the
    same order, and agree here in every lane; a BLAS that sums a product
    in another order moves a last bit, which the cut loop, chaotic in
    float32, can grow into other cuts and rounds, so up to one lane in
    eight may differ in them."""
    dec, ref, t, llr = small
    assert dec.ipm_matvec_backend == dec.ipm_factor_backend == "auto"
    want = ref.decode(t, llr)
    st = dec._run_loop(llr)
    res = dec._finish(st)
    assert int(st["cum_g"].sum()) > 0          # the Gaussian cuts ran
    prog = {"bits": res.bits, "success": res.success,
            "iterations": res.iterations}
    d = ref.lanes_differ(prog, want)
    assert not d["certificates_differ"].any()
    assert torch.equal(res.success, want["success"])
    moved = (res.iterations != want["iterations"]) | \
        (st["count"] != want["cuts"]) | (res.dropped != want["dropped"])
    assert int(moved.sum()) <= llr.shape[0] // 8


def test_control_differs(small):
    _, ref, t, llr = small
    d = ref.lanes_differ(ref.decode(t, llr, control=True), ref.decode(t, llr))
    assert d["lanes_differ"].any()


def test_tf32_control_is_alps():
    ref = Cell(CELL).reference()
    v = torch.tensor([1.0 + 3 * 2**-11, 0.3])
    ipm = ref._Ipm(Cell(CELL).reference_config(), control=True)
    assert torch.equal(ipm.r(v), alp._tf32(v))


def test_elimination_is_the_reduced_echelon_form():
    """Hand-worked: columns taken in the given order, pivot rows in pivot
    order, every pivot column a unit column, zero rows last."""
    ref = Cell(CELL).reference()
    hp = torch.tensor([[[1, 1, 0, 1], [1, 1, 1, 0], [0, 0, 1, 1]]],
                      dtype=torch.uint8)
    want = torch.tensor([[[1, 1, 0, 1], [0, 0, 1, 1], [0, 0, 0, 0]]],
                        dtype=torch.uint8)
    assert torch.equal(ref.rref(hp), want)
    # float32: 1 - 1e-8 rounds to 1, so 1.0 is fractional, 0.5 from 0.5
    u = torch.tensor([[0.0, 0.3, 1.0, 0.5, 0.9, 1e-9]])
    assert ref.column_order(u, 1e-8).tolist() == [[3, 1, 4, 2, 0, 5]]
    from ldpc_tpu_torch.ops.gf2_gauss import fractional_column_order
    gen = torch.Generator().manual_seed(3)
    u = torch.rand((6, 40), generator=gen).where(
        torch.rand((6, 40), generator=gen) < 0.6, torch.tensor(0.0))
    u[:, ::7] = 1.0
    u[:, 1::9] = 0.5
    assert torch.equal(ref.column_order(u, 1e-8),
                       fractional_column_order(u, 1e-8))


def test_normal_build_hand_worked_shape():
    """128 lanes of T = 1408 at n = 280, the symmetric half on three bf16
    planes: 42.5 GFLOP, 0.0430 ms at 989.4 TFLOP/s (PERF.md's table of
    kernels); 92.9 MB, 0.0277 ms: bound by operations."""
    f = normal_build.flops(128, 1408, 280)
    assert f == 3 * 128 * 1408 * 280 * 281
    b = normal_build.bytes_moved(128, 1408, 280)
    assert b == 128 * (1408 * 288 + 4 * 1408 + 4 * 280 + 4 * 280 * 280)
    t, what = normal_build.bound_s(f, b, 989.4e12, H100["hbm_bytes_s"])
    assert what == "operations" and t * 1e3 == pytest.approx(0.04298,
                                                             rel=1e-3)
    assert normal_build.bound_s(0.0, 3.35e12, 989.4e12, 3.35e12) == (
        1.0, "bytes")


def test_gf2_gauss_hand_worked_shape():
    """128 lanes of 160 x 280: 11.5 MB read and written, 3.42 us at 3.35
    TB/s (PERF.md's table of kernels); inactive lanes move as much."""
    b = gf2_gauss.bytes_moved(128, 160, 280)
    assert b == 128 * (2 * 160 * 280 + 1)
    t, what = bound_s(gf2_gauss.flops(64, 160, 280), b, H100)
    assert what == "bytes" and t * 1e6 == pytest.approx(3.4236, rel=1e-3)


def _ctx():
    return Context(None, {}, torch.device("cpu"), H100)


def test_normal_build_reader_on_hand_made_records(monkeypatch):
    mod = Cell(CELL).metric("normal_build_roofline")
    monkeypatch.setattr(mod, "_tensor_peak", lambda device: 989.4e12)
    ctx = _ctx()
    ctx.records[mod.KEY] = [((128, 1408, 280), 2, 5), ((128, 640, 280), 1, 5)]
    ctx.records[mod.KEY + ".tiers"] = [Counter()]
    one = normal_build.flops(128, 1408, 280) / 989.4e12
    two = normal_build.flops(128, 640, 280) / 989.4e12
    kernel_s = 20 * one
    s = {"device_us_by_name": {"normal_build_kernel(...)": kernel_s * 1e6}}
    assert mod.read(ctx, s) == pytest.approx(100.0 * (10 * one + 5 * two)
                                             / kernel_s)
    note = ctx.notes[mod.KEY]
    assert note["launches_by_tier"] == {640: 5, 1408: 10}
    assert note["binds"] == "operations"
    assert mod.read(ctx, {"device_us_by_name": {}}) is None


def test_ipm_reads_reader_on_hand_made_counts(monkeypatch):
    mod = Cell(CELL).metric("ipm.sync_reads_per_trial")
    start = {"alp": {"reads.done": 1}, "lp": {}, "harness": {},
             "pdhg_kernel": {"launches": 0}}
    now = {"alp": {"reads.done": 11, "lanes": 50}, "lp": {"reads.poll": 7},
           "harness": {"reads.refill": 10}, "pdhg_kernel": {"launches": 0}}
    monkeypatch.setattr(_program, "counts", lambda: start)
    monkeypatch.setattr(mod, "_ipm", lambda: ({"reads.poll": 4}, 8))
    ctx = _ctx()
    mod.install(ctx)
    monkeypatch.setattr(_program, "counts", lambda: now)
    monkeypatch.setattr(mod, "_ipm", lambda: (
        {"reads.poll": 44, "solves": 9, "chunks": 30}, 8))
    # PDHG's reads are not the IPM's: 10 + 40 + 10 reads over 20 trials
    assert mod.read(ctx, {"trials": 20}) == pytest.approx(3.0)
    assert ctx.notes[mod.KEY]["graph_captures"] == 0
    assert mod.read(ctx, {"trials": 0}) is None


@pytest.mark.parametrize("name", NEW)
def test_readers_read_nothing_on_a_program_without_them(name, monkeypatch):
    """As at the commit before the solver's counters: the readers install
    and return None, with no error."""
    from ldpc_tpu_torch.ops import ipm_solver
    monkeypatch.delattr(ipm_solver, "COUNTS")
    mod = Cell(CELL).metric(name)
    ctx = _ctx()
    mod.install(ctx)
    s = {"device_us_by_name": {"normal_build_kernel": 5.0,
                               "gf2_gauss_kernel": 5.0},
         "trials": 10, "busy_us": 10.0, "window_us": 20.0}
    assert mod.read(ctx, s) is None


def test_gauss_lane_share_reads_the_need_masks():
    mod = Cell(CELL).metric("agc.gauss_lane_share")
    h = gf2.read_matrix(SMALL)
    dec = _decoder(h)
    ctx = Context(dec, {}, torch.device("cpu"), None)
    mod.install(ctx)
    from ldpc_tpu_torch.decoders import alp as program
    ctx.tracing = True
    x = torch.full((4, h.shape[1]), 0.5)
    dec._gauss_sup(x, torch.tensor([True, False, True, False]))
    program.COUNTS["lanes"] += 8               # as two rounds of 4 lanes
    assert mod.read(ctx, {}) == pytest.approx(2 / 8)
    assert ctx.notes[mod.KEY] == {"gauss_lanes": 2, "lane_rounds": 8,
                                  "calls": 1}


SIZES = {"batch": 1, "block_batches": 4, "check_blocks": 1,
         "trace_blocks": 1}


def _run(capsys, sizes=None, prepare=None, seed=SEED):
    rc = run.main(["--workload", CELL, "--seed", str(seed), "--seconds",
                   "0.01", "--trace", "0"], device="cpu",
                  sizes={**SIZES, **(sizes or {})}, prepare=prepare)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_uncoupled_run_is_correct(capsys):
    out = _run(capsys)
    assert out["correct"] is True, out["check"]
    assert out["failed"] == 0 and out["attempted"] == 4
    assert all(v["value"] == 0 for v in out["check"].values()), out["check"]


def test_streamed_run_is_recorded_exactly(capsys):
    from ldpc_tpu_torch.harness import experiment
    refills = experiment.COUNTS["reads.refill"]
    out = _run(capsys, sizes={"batch": 2, "block_batches": 3})
    assert experiment.COUNTS["reads.refill"] > refills      # it streamed
    assert out["failed"] == 0
    assert out["check"]["llr_gap"]["value"] == 0, out["check"]
    assert out["check"]["classify_gap"]["value"] == 0, out["check"]


def test_gauss_source_off_is_not_correct(capsys):
    def alp_cuts_only(dec):
        dec.use_gauss = False
    out = _run(capsys, prepare=alp_cuts_only)
    assert out["correct"] is False, out["check"]


def test_a_trial_recorded_twice_is_not_correct(capsys, monkeypatch):
    monkeypatch.setattr(record.Recorder, "_write",
                        _twice(record.Recorder._write))
    assert _run(capsys)["correct"] is False


def test_control_is_not_correct():
    """The reference one precision step lower in the program's place, on
    three seeds: not correct on any of them."""
    limits = Cell(CELL).spec["limits"]
    readings = calibrate.control_readings(
        CELL, [2**31 + 61, 2**31 + 62, 2**31 + 63], device="cpu",
        sizes={"batch": 1, "block_batches": 4, "check_blocks": 1})
    assert all(not verdict(r, limits)[0] for r in readings), readings


def test_the_cell_names_no_number_twice():
    limits = Cell(CELL).spec["limits"]
    assert len(limits) == len(set(limits))
    assert np.isfinite(list(limits.values())).all()
