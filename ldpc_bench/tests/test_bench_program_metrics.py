"""The readers of the program's own spans and counters
(``metrics/_program.py`` and the five readers that use it): on hand-made
summaries and counter deltas, on a program that has neither (the commit
before them), and in a traced run of each cell on the CPU, where the
counters read and the idle shares, which need a device trace, do not."""
import json

import pytest
import torch

from ldpc_bench import run
from ldpc_bench.cell import Cell
from ldpc_bench.metrics import _program
from ldpc_bench.trace import Context
from ldpc_tpu_torch.decoders import alp
from ldpc_tpu_torch.harness import experiment  # noqa: F401 (see below)
from ldpc_tpu_torch.utils import profiling

COUNTERS = ("alp.solve_lane_share", "alp.sync_reads_per_batch",
            "pdhg_chunk.active_lanes_per_launch")
IDLE = ("harness.idle_share", "decoder.idle_share")


def _reader(name):
    return Cell("alp-optimalH-m3db").metric(name)


def _ctx():
    return Context(None, {}, torch.device("cpu"), None)


def _summary(busy_us=400.0):
    return {"window_us": 1000.0, "busy_us": busy_us, "idle_by_host": [
        ("harness.block > python", 100.0), ("harness.sync > aten::item", 20.0),
        ("alp.round > python", 200.0), ("lp.poll > aten::item", 50.0),
        ("agc.gauss > aten::where", 10.0), ("bp.decode > aten::empty", 5.0),
        ("bench.decode > python", 30.0), ("no span > python", 40.0)]}


def test_idle_shares_split_the_gaps_by_the_innermost_program_span():
    ctx = _ctx()
    for name in IDLE:
        _reader(name + ".alp").install(ctx)
    assert profiling.SPANS <= ctx.spans
    assert _reader("harness.idle_share.bp").read(ctx, _summary()) == \
        pytest.approx(0.12)
    assert _reader("decoder.idle_share.alp").read(ctx, _summary()) == \
        pytest.approx(0.265)


@pytest.mark.parametrize("name", IDLE)
def test_idle_shares_read_nothing_without_a_device_trace(name):
    assert _reader(name + ".bp").read(_ctx(), _summary(busy_us=0.0)) is None


def _counted(monkeypatch, start, now):
    ctx = _ctx()
    monkeypatch.setattr(_program, "counts", lambda: start)
    for name in COUNTERS:
        _reader(name).install(ctx)
    monkeypatch.setattr(_program, "counts", lambda: now)
    return ctx


def _counts(alp_, lp, harness, launches):
    return {"alp": alp_, "lp": lp, "harness": harness,
            "pdhg_kernel": {"launches": launches}}


def test_counter_readers_take_differences_over_the_slice(monkeypatch):
    start = _counts({"lanes": 512, "solve_lanes": 100, "reads.tier": 9},
                    {"reads.poll": 5}, {"batches": 2}, 7)
    now = _counts({"lanes": 512 + 2560, "solve_lanes": 100 + 1024,
                   "reads.tier": 9 + 20, "reads.append": 20,
                   "reads.done": 22},
                  {"reads.poll": 5 + 40, "reads.guard": 1, "chunks": 40,
                   "lanes": 4096},
                  {"batches": 2 + 2, "reads.result": 1}, 7 + 40)
    ctx = _counted(monkeypatch, start, now)
    assert _reader("alp.solve_lane_share").read(ctx, {}) == \
        pytest.approx(1024 / 2560)
    assert _reader("alp.sync_reads_per_batch").read(ctx, {}) == \
        pytest.approx((20 + 20 + 22 + 40 + 1 + 1) / 2)
    sites = ctx.notes["alp.sync_reads_per_batch"]["per_batch"]
    assert sites["lp.reads.poll"] == 20 and sites["alp.reads.tier"] == 10
    assert "lp.chunks" not in sites and "alp.lanes" not in sites
    assert _reader("pdhg_chunk.active_lanes_per_launch").read(ctx, {}) == \
        pytest.approx(4096 / 40)
    note = ctx.notes["pdhg_chunk.active_lanes_per_launch"]
    assert note["kernel_launches"] == note["calls"] == 40


def test_nothing_to_read_from_a_program_without_spans_or_counters(
        monkeypatch):
    # the readers' modules are all imported above, before ``SPANS`` goes
    monkeypatch.delattr(profiling, "SPANS")
    monkeypatch.delattr(alp, "COUNTS")
    ctx = _ctx()
    before = set(ctx.spans)
    for name in (*COUNTERS, *(n + ".alp" for n in IDLE)):
        mod = _reader(name)
        mod.install(ctx)
        assert mod.read(ctx, _summary()) is None, name
    assert ctx.spans == before


def _traced(cell, batch, capsys):
    def prepare(dec):
        if hasattr(dec, "lp_backend"):
            dec.lp_backend = "kernel"
    rc = run.main(["--workload", cell, "--seed", str(2**31 + 29),
                   "--seconds", "0.01", "--trace", "1"], device="cpu",
                  sizes={"batch": batch, "block_batches": 2,
                         "check_blocks": 1, "trace_blocks": 1},
                  prepare=prepare)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("cell,batch", [("alp-optimalH-m3db", 3),
                                        ("alp-optimalH-0db", 16)])
def test_a_traced_alp_cell_reports_the_counter_metrics(cell, batch, capsys):
    out = _traced(cell, batch, capsys)
    metrics = {k: v["value"] for k, v in out["metrics"].items()}
    assert out["correct"] is True
    assert set(COUNTERS) <= set(metrics)
    assert 0 < metrics["alp.solve_lane_share"] <= 1
    assert 0 < metrics["pdhg_chunk.active_lanes_per_launch"] <= batch
    # per round three reads, and the solver's polls
    assert metrics["alp.sync_reads_per_batch"] > 3
    assert not any(k.endswith("idle_share.alp") for k in metrics)
    assert any(label.split(" > ")[0] in profiling.SPANS
               for label, _ in out["breakdown"]["idle_gaps"])


def test_a_traced_bp_cell_reads_no_idle_share_on_the_cpu(capsys):
    out = _traced("bp100-optimalH-m3db", 64, capsys)
    assert out["correct"] is True
    assert not any("idle_share" in k for k in out["metrics"])
