"""The QP-ADMM cell, ``qpadmm-optimalH-m3db``, on the CPU:

* its files are found by name, and its configuration holds the constants
  and the cascade the program's decoder runs with;
* its plain reference (``reference/qp-admm.py``) builds the program's
  cascade, repeats bit for bit, agrees with the program's plain path lane
  by lane (batched and streamed) on a small code, and differs under
  ``control``;
* the count of ``admm_iterate`` reproduces hand-worked cascades, and the
  three readers read hand-made records and return None on a program
  without the spans or counters they read;
* a small streamed run of the cell comes out correct, and not correct
  under the control, with one trial's word altered and with a trial
  recorded twice.

The harness's look for a chip is skipped (``device="cpu"``).
"""
import json

import numpy as np
import pytest
import torch

from ldpc_bench import calibrate, record, run
from ldpc_bench.cell import ROOT, Cell
from ldpc_bench.check import verdict
from ldpc_bench.counts import admm_iterate
from ldpc_bench.counts.peaks import PEAKS, bound_s
from ldpc_bench.metrics import _admm, _program
from ldpc_bench.reference import channel, gf2
from ldpc_bench.tests.test_bench_stream import _twice
from ldpc_bench.trace import Context

CELL = "qpadmm-optimalH-m3db"
SMALL = str(ROOT / "data" / "H.txt")
SEED = 2**31 + 71
H100 = PEAKS["NVIDIA H100 80GB HBM3"]
NEW = ("admm_iterate_roofline", "admm.lane_iter_share", "admm.idle_share")
KERNEL = "void (anonymous namespace)::admm_iterate_kernel<256, 2>(Params)"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rate(c):
    return next(m["name"] for m in c.end_to_end
                if m["name"].startswith("cw_per_s."))


def _decoder(h, max_iter=None):
    from ldpc_tpu_torch.config import DecoderConfig
    from ldpc_tpu_torch.decoders import make_decoder
    cfg = dict(Cell(CELL).config["decoder_config"])
    if max_iter is not None:
        cfg["admm_max_iter"] = max_iter
    return make_decoder("qp-admm", h, DecoderConfig(**cfg), device="cpu")


def test_cell_files_found_by_name():
    c = Cell(CELL)
    assert c.code_path.is_file() and c.config["decoder"] == "qp-admm"
    assert c.config["batch"] == 1024 and c.config["reduced"] == []
    assert c.traffic["snr_db"] == -3.0 and c.traffic["block_batches"] == 8
    assert c.chips == 1
    ref = c.reference()
    for name in ("prepare", "decode", "lanes_differ"):
        assert hasattr(ref, name)
    rate = _rate(c)
    suffix = rate.split(".", 1)[1]
    assert sorted(m["name"] for m in c.end_to_end) == [rate, "setup_s"]
    names = {m["name"] for m in c.per_layer}
    assert set(NEW) | {f"device.idle_share.{suffix}",
                       f"harness.idle_share.{suffix}"} == names
    for m in c.per_layer:
        assert hasattr(c.metric(m["name"]), "read")
        assert m["moves"] == rate
    assert set(c.spec["limits"]) >= {"llr_gap", "lanes_differ",
                                     "counters_gap", "classify_gap"}
    assert c.spec["limits"]["llr_gap"] > 0 == c.spec["limits"]["classify_gap"]
    assert c.spec["check_blocks"] >= 1 and c.spec["trace_blocks"] >= 1


def test_configuration_is_what_the_program_runs():
    """The published constants (the program's defaults), the batch, the
    chunk and the cascade that the configuration states are the
    program's."""
    from ldpc_tpu_torch.config import DecoderConfig
    from ldpc_tpu_torch.decoders import DEFAULT_BATCH
    from ldpc_tpu_torch.decoders.admm import QPADMMDecoder, _structure_caps
    c = Cell(CELL)
    cfg = c.reference_config()
    default = DecoderConfig()
    for key in ("admm_alpha", "admm_mu", "admm_max_iter", "admm_eps_stop"):
        assert cfg[key] == getattr(default, key), key
    assert (cfg["admm_alpha"], cfg["admm_mu"], cfg["admm_max_iter"],
            cfg["admm_eps_stop"]) == (1.2, 0.55, 10000, 1e-5)
    assert cfg["batch"] == c.config["batch"] == DEFAULT_BATCH["qp-admm"]
    assert cfg["streamed"] and not hasattr(QPADMMDecoder,
                                           "prefer_streaming")
    assert cfg["stream_chunk_iters"] == QPADMMDecoder.stream_chunk_iters
    h = gf2.read_matrix(str(c.code_path))
    n_var, cons, entries = c.reference().cascade(h)
    shape = c.config["cascade"]
    assert (shape["n_var"], shape["n_con"], shape["k_max"]) == \
        _structure_caps(h) == (n_var, len(cons), max(map(len, entries)))
    assert shape["entries"] == sum(len(v) for v, _, _ in cons) == \
        sum(map(len, entries))


@pytest.fixture(scope="module")
def small():
    """The small code, the program's decoder on it at 300 iterations, the
    reference's tables, and 16 lanes at -1 dB (some stop, some do not)."""
    h = gf2.read_matrix(SMALL)
    g = gf2.nullspace(h)
    cfg = {**Cell(CELL).reference_config(), "admm_max_iter": 300}
    gen = torch.Generator().manual_seed(17)
    coeffs = torch.randint(0, 2, (16, g.shape[0]), generator=gen,
                           dtype=torch.float32)
    y = channel.received(gf2.codewords(coeffs, g), -1.0, 17,
                         torch.arange(16))
    ref = Cell(CELL).reference()
    return h, _decoder(h, 300), ref, ref.prepare(h, cfg, "cpu"), \
        channel.llrs(y, -1.0)


def test_reference_builds_the_programs_cascade(small):
    from ldpc_tpu_torch.decoders.admm import _from_h_numpy
    h, _, ref, t, _ = small
    s = _from_h_numpy(h)
    assert (t["n_var"], t["n_con"], t["k"]) == (s.n_var, s.n_con,
                                                s.var_con.shape[1])
    assert np.array_equal(t["b"].numpy(), s.b)
    assert np.array_equal(t["e"].numpy(), s.e)
    con_var = t["con_var"].view(3, -1).t().numpy()
    con_coef = t["con_coef"].t().numpy()
    assert np.array_equal(con_coef, s.con_coef)
    assert np.array_equal(np.where(con_coef != 0, con_var, s.n_var),
                          s.con_var)
    var_coef = t["var_coef"].t().numpy()
    var_con = t["var_con"].view(t["k"], -1).t().numpy()
    assert np.array_equal(var_coef, s.var_coef)
    assert np.array_equal(np.where(var_coef != 0, var_con, s.n_con),
                          s.var_con)


def test_hand_worked_cascade():
    """One check of degree 4: an auxiliary variable and two parity
    triples, (x0, x1, a) and (a, x2, x3)."""
    ref = Cell(CELL).reference()
    n_var, cons, entries = ref.cascade(np.array([[1, 1, 1, 1]]))
    assert n_var == 5 and len(cons) == 8
    assert [c[0] for c in cons] == [[0, 1, 4]] * 4 + [[4, 2, 3]] * 4
    assert [c[2] for c in cons] == [0.0, 0.0, 0.0, 2.0] * 2
    assert [len(e) for e in entries] == [4, 4, 4, 4, 8]
    assert entries[4][:4] == [(0, -1.0), (1, -1.0), (2, 1.0), (3, 1.0)]


def test_reference_repeats_bit_for_bit(small):
    _, _, ref, t, llr = small
    a, b = ref.decode(t, llr), ref.decode(t, llr)
    for k in ("bits", "success", "iterations"):
        assert torch.equal(a[k], b[k]), k
    assert a["dropped"] is None


def test_reference_agrees_with_the_programs_plain_path(small):
    """Lane by lane, batched and streamed: every bit, success and
    iteration count equal (the reference's sums are the program's plain
    twin's but for the stop's sum of squares, which no lane here meets
    at a tie)."""
    _, dec, ref, t, llr = small
    want = ref.decode(t, llr)
    its = want["iterations"]
    assert 0 < int((its < 300).sum()) < its.numel()   # some stop, some not
    res = dec.decode_batch(llr)
    prog = {"bits": res.bits, "success": res.success,
            "iterations": res.iterations}
    assert not ref.lanes_differ(prog, want)["lanes_differ"].any()
    dec.stream_chunk_iters = 64
    st = dec.stream_init(llr)
    while not bool(dec.stream_done(st).all()):
        st = dec.stream_chunk(st)
    res = dec.stream_finish(st)
    prog = {"bits": res.bits, "success": res.success,
            "iterations": res.iterations}
    assert not ref.lanes_differ(prog, want)["lanes_differ"].any()


def test_reference_fails_every_lane_without_the_precondition(small):
    h, _, ref, _, llr = small
    # min(e) on the small code is 8 (an auxiliary variable's): mu 0.05
    # puts min(e) mu below alpha 1.2
    assert float(ref.prepare(h, Cell(CELL).reference_config(),
                             "cpu")["e"].min()) == 8.0
    t = ref.prepare(h, {**Cell(CELL).reference_config(), "admm_mu": 0.05,
                        "admm_max_iter": 40}, "cpu")
    out = ref.decode(t, llr[:4])
    assert not out["success"].any() and not out["bits"].any()


def test_control_differs(small):
    _, _, ref, t, llr = small
    d = ref.lanes_differ(ref.decode(t, llr, control=True), ref.decode(t, llr))
    assert int(d["lanes_differ"].sum()) >= llr.shape[0] // 2


def test_admm_iterate_hand_worked_cascades():
    """The degree-4 check above: 24 entries, 5 variables, 8 constraints,
    2 * 24 + 4 * 5 + 10 * 8 = 148 operations a lane-iteration. optimalH's
    cascade: 39,920, 40.9 M an iteration of 1,024 lanes, 0.610 us at 67
    TFLOP/s against 13.95 us for the launch's bytes: 512 full iterations
    bind by operations."""
    assert admm_iterate.ops_per_lane_iteration(5, 8, 24) == 148
    assert admm_iterate.flops(10, 5, 8, 24) == 1480.0
    assert admm_iterate.bytes_moved(2, 5, 8, 24) == \
        2 * (12 * 5 + 16 * 8 + 10) + 16 * 24 + 4 * 8 + 4 * 5
    per = admm_iterate.ops_per_lane_iteration(700, 2320, 6960)
    assert per == 39920
    t, what = bound_s(admm_iterate.flops(1024, 700, 2320, 6960), 0.0, H100)
    assert what == "operations" and t * 1e6 == pytest.approx(0.6101,
                                                             rel=1e-3)
    nbytes = admm_iterate.bytes_moved(1024, 700, 2320, 6960)
    assert nbytes / H100["hbm_bytes_s"] * 1e6 == pytest.approx(13.954,
                                                               rel=1e-3)
    t, what = bound_s(admm_iterate.flops(512 * 1024, 700, 2320, 6960),
                      nbytes, H100)
    assert what == "operations"


def _ctx(decoder=None):
    return Context(decoder, dict(Cell(CELL).config), torch.device("cpu"),
                   H100)


def _records(ctx, chunks, start=None, now=None):
    """Hand-made chunk records and the program's counters before and
    after the slice."""
    ctx.records[_admm.KEY] = [
        (lanes, torch.tensor(active), torch.tensor(work))
        for lanes, active, work in chunks]
    ctx.records[_admm.KEY + ".counts"] = [start or {}]
    return now or {"chunks": len(chunks)}


def test_roofline_reader_on_hand_made_records(monkeypatch):
    mod = Cell(CELL).metric("admm_iterate_roofline")
    ctx = _ctx()
    now = _records(ctx, [(1024, 1024, 400_000), (1024, 100, 50)],
                   start={"chunks": 3}, now={"chunks": 5})
    monkeypatch.setattr(_admm, "program_counts", lambda: now)
    one = bound_s(admm_iterate.flops(400_000, 700, 2320, 6960),
                  admm_iterate.bytes_moved(1024, 700, 2320, 6960), H100)
    two = bound_s(admm_iterate.flops(50, 700, 2320, 6960),
                  admm_iterate.bytes_moved(100, 700, 2320, 6960), H100)
    assert (one[1], two[1]) == ("operations", "bytes")
    kernel_s = 0.01
    s = {"device_us_by_name": {KERNEL: kernel_s * 1e6, "other": 9.0}}
    assert mod.read(ctx, s) == pytest.approx(
        100.0 * (one[0] + two[0]) / kernel_s)
    note = ctx.notes[mod.KEY]
    assert (note["launches"], note["chunks"], note["lane_iterations"]) == (
        2, 2, 400_050)
    assert note["rows"] == [700, 2320, 6960]
    assert mod.read(ctx, {"device_us_by_name": {"other": 9.0}}) is None


def test_lane_iter_share_reader_on_hand_made_records(monkeypatch):
    mod = Cell(CELL).metric("admm.lane_iter_share")
    dec = type("Dec", (), {"stream_chunk_iters": 512})()
    ctx = _ctx(dec)
    now = _records(ctx, [(1024, 1024, 400_000), (1024, 10, 5_000),
                         (1024, 1, 512), (1024, 0, 0)],
                   start={"chunks": 7, "lanes_started": 100},
                   now={"chunks": 11, "lanes_started": 1200})
    monkeypatch.setattr(_admm, "program_counts", lambda: now)
    start = {"alp": {}, "lp": {}, "harness": {"reads.refill": 1},
             "pdhg_kernel": {"launches": 0}}
    end = {"alp": {}, "lp": {}, "harness": {"reads.refill": 4,
                                           "reads.poll": 1},
           "pdhg_kernel": {"launches": 0}}
    ctx.records["program.counts"] = [start]
    monkeypatch.setattr(_program, "counts", lambda: end)
    assert mod.read(ctx, {"trials": 1000}) == pytest.approx(
        405_512 / (4 * 1024 * 512))
    note = ctx.notes[mod.KEY]
    assert note["lanes_started"] == 1100 and note["launches_seen"] == 4
    assert note["empty_chunks"] == 1
    assert note["per_trial"] == {"reads.refill": 0.003, "reads.poll": 0.001}


def test_idle_share_reader_on_hand_made_gaps():
    mod = Cell(CELL).metric("admm.idle_share")
    s = {"busy_us": 50.0, "window_us": 100.0,
         "idle_by_host": [("admm.chunk > python", 10.0),
                          ("admm.init > aten::cat", 5.0),
                          ("harness.refill > aten::nonzero", 20.0),
                          ("no span > python", 15.0)]}
    assert mod.read(_ctx(), s) == pytest.approx(0.15)


class _Parent:
    """A QP-ADMM decoder's stream as the program before its counters
    runs it, down to the state's shape."""

    stream_chunk_iters = 8

    def stream_chunk(self, st):
        return {**st, "it": st["it"] + 8, "done": st["it"] >= 8}


@pytest.mark.parametrize("name", NEW)
def test_readers_read_nothing_on_a_program_without_them(name, monkeypatch):
    """As at the commit before QP-ADMM's spans and counters: the readers
    install and return None, with no error."""
    from ldpc_tpu_torch.decoders import admm
    from ldpc_tpu_torch.utils import profiling
    monkeypatch.delattr(admm, "COUNTS")
    monkeypatch.setattr(profiling, "SPANS", frozenset(
        n for n in profiling.SPANS if not n.startswith("admm.")))
    mod = Cell(CELL).metric(name)
    ctx = _ctx(_Parent())
    mod.install(ctx)
    ctx.tracing = True
    st = {"it": torch.zeros(2, dtype=torch.int32),
          "done": torch.zeros(2, dtype=torch.bool)}
    st = ctx.decoder.stream_chunk(ctx.decoder.stream_chunk(st))
    ctx.tracing = False
    assert st["it"].tolist() == [16, 16]
    s = {"device_us_by_name": {KERNEL: 5.0}, "trials": 10,
         "busy_us": 10.0, "window_us": 20.0,
         "idle_by_host": [("admm.chunk > python", 5.0)]}
    assert mod.read(ctx, s) is None


def test_the_wrapper_records_each_chunks_lane_iterations(small):
    """While tracing, each chunk's lanes, the lanes not done at its start
    and the growth of the state's counts; nothing while not tracing."""
    h, _, _, _, llr = small
    dec = _decoder(h, 300)
    dec.stream_chunk_iters = 64
    ctx = _ctx(dec)
    _admm.install(ctx)
    _admm.install(ctx)                   # a second reader wraps nothing
    st = dec.stream_init(llr[:6])
    st = dec.stream_chunk(st)           # not tracing: not recorded
    ctx.tracing = True
    its = [st["it"].clone()]
    done = [st["done"].clone()]
    for _ in range(6):
        st = dec.stream_chunk(st)
        its.append(st["it"].clone())
        done.append(st["done"].clone())
    ctx.tracing = False
    recs, grown = _admm.chunks(ctx)
    assert grown["chunks"] == 7 and len(recs) == 6   # the first untraced
    want = [(6, int((~done[j]).sum()), int((its[j + 1] - its[j]).sum()))
            for j in range(6)]
    assert recs == want
    assert sum(w for _, _, w in recs) == int((st["it"] - its[0]).sum()) > 0


SIZES = {"batch": 2, "block_batches": 2, "check_blocks": 1,
         "trace_blocks": 1}


def _run(capsys, sizes=None, prepare=None, seed=SEED):
    rc = run.main(["--workload", CELL, "--seed", str(seed), "--seconds",
                   "0.01", "--trace", "0"], device="cpu",
                  sizes={**SIZES, **(sizes or {})}, prepare=prepare)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_streamed_run_is_correct(capsys):
    from ldpc_tpu_torch.harness import experiment
    refills = experiment.COUNTS["reads.refill"]
    out = _run(capsys)
    assert experiment.COUNTS["reads.refill"] > refills      # it streamed
    assert out["correct"] is True, out["check"]
    assert out["failed"] == 0 and out["attempted"] == 4
    assert all(v["value"] == 0 for v in out["check"].values()), out["check"]


def test_an_altered_trial_is_not_correct(capsys):
    """One bit of the word in the stream's first slot flipped at every
    finish: the trials that slot decodes read as differing lanes."""
    def flip_slot_zero(dec):
        finish = dec.stream_finish

        def altered(st):
            res = finish(st)
            res.bits[0, 0] ^= 1
            return res
        dec.stream_finish = altered
    out = _run(capsys, prepare=flip_slot_zero)
    assert out["correct"] is False
    assert out["check"]["lanes_differ"]["value"] > 0, out["check"]


def test_a_trial_recorded_twice_is_not_correct(capsys, monkeypatch):
    monkeypatch.setattr(record.Recorder, "_write",
                        _twice(record.Recorder._write))
    assert _run(capsys)["correct"] is False


def test_control_is_not_correct():
    """The reference one precision step lower in the program's place, on
    three seeds: not correct on any of them."""
    limits = Cell(CELL).spec["limits"]
    readings = calibrate.control_readings(
        CELL, [2**31 + 73, 2**31 + 74, 2**31 + 75], device="cpu",
        sizes={"batch": 2, "block_batches": 2, "check_blocks": 1})
    assert all(not verdict(r, limits)[0] for r in readings), readings
