"""The reader of ``harness.channel_kernel_share.*``: the channel kernel's
launches per batch over the slice, from the program's counters; nothing to
read from a program without the kernel (the commit before it)."""
import json
import sys

import pytest
import torch

from ldpc_bench import run
from ldpc_bench.cell import Cell
from ldpc_bench.trace import Context
from ldpc_tpu_torch import ops
from ldpc_tpu_torch.harness import experiment
from ldpc_tpu_torch.ops import channel_kernel

NAMES = ("harness.channel_kernel_share.bp",
         "harness.channel_kernel_share.alp")
CELLS = {NAMES[0]: "bp100-optimalH-m3db", NAMES[1]: "alp-optimalH-m3db"}


def _ctx():
    return Context(None, {}, torch.device("cpu"), None)


@pytest.mark.parametrize("name", NAMES)
def test_launches_over_batches(name, monkeypatch):
    reader = Cell(CELLS[name]).metric(name)
    monkeypatch.setattr(channel_kernel, "LAUNCHES", 40)
    monkeypatch.setitem(experiment.COUNTS, "batches", 12)
    ctx = _ctx()
    reader.install(ctx)
    reader.install(ctx)                 # a second install keeps the first
    monkeypatch.setattr(channel_kernel, "LAUNCHES", 40 + 24)
    monkeypatch.setitem(experiment.COUNTS, "batches", 12 + 32)
    assert reader.read(ctx, {}) == pytest.approx(24 / 32)
    monkeypatch.setattr(channel_kernel, "LAUNCHES", 40 + 32)
    assert reader.read(ctx, {}) == 1.0


def test_no_batches_no_share(monkeypatch):
    reader = Cell(CELLS[NAMES[0]]).metric(NAMES[0])
    ctx = _ctx()
    reader.install(ctx)
    assert reader.read(ctx, {}) is None


@pytest.mark.parametrize("name", NAMES)
def test_nothing_to_read_without_the_kernel(name, monkeypatch):
    monkeypatch.delattr(ops, "channel_kernel")
    monkeypatch.setitem(sys.modules, "ldpc_tpu_torch.ops.channel_kernel",
                        None)
    reader = Cell(CELLS[name]).metric(name)
    ctx = _ctx()
    reader.install(ctx)
    monkeypatch.setitem(experiment.COUNTS, "batches",
                        experiment.COUNTS["batches"] + 8)
    assert reader.read(ctx, {}) is None


def test_a_traced_bp_cell_on_the_cpu_reads_no_launch(capsys):
    """On the CPU the channel runs as its plain twin: 0 launches a
    batch."""
    rc = run.main(["--workload", "bp100-optimalH-m3db", "--seed",
                   str(2**31 + 29), "--seconds", "0.01", "--trace", "1"],
                  device="cpu", sizes={"batch": 32, "block_batches": 2,
                                       "check_blocks": 1,
                                       "trace_blocks": 1})
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["correct"] is True
    assert out["metrics"][NAMES[0]] == {"value": 0.0, "unit": "share"}
