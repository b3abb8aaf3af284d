"""The port's plots app (``ldpc_tpu_torch/apps/plots.py``) and profiling
helpers (``ldpc_tpu_torch/utils/profiling.py``).

``read_report`` must give what the JAX package's gives on every committed
report (exactly: the same parse of the same text), ``main`` must write the
same files, ``Timer`` must accumulate and ``trace`` must write a Chrome
trace on the CPU, with the program's spans in it."""
import glob
import json
import math
import os
import time

import pytest
import torch

from ldpc_tpu_torch.apps import plots
from ldpc_tpu_torch.codes.io import read_pcm
from ldpc_tpu_torch.decoders.bp import BPDecoder
from ldpc_tpu_torch.harness.experiment import run_experiment
from ldpc_tpu_torch.utils.profiling import Timer, trace

try:  # the card's host has no JAX
    from ldpc_tpu.apps import plots as jplots
except ImportError:
    jplots = None

REPORTS = sorted(glob.glob(os.path.join(os.path.dirname(__file__), "..",
                                        "reports", "*.csv")))


def _same(a, b):
    """Equal values, NaN equal to NaN."""
    if isinstance(a, float) and isinstance(b, float):
        return a == b or (math.isnan(a) and math.isnan(b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(map(_same, a, b))
    return a == b


def _read(mod, path):
    try:
        return mod.read_report(path)
    except Exception as exc:          # a CSV that is not a report
        return type(exc).__name__


@pytest.mark.parametrize("path", REPORTS, ids=os.path.basename)
def test_read_report_equals_jax(path):
    got, want = _read(plots, path), _read(jplots, path)
    assert _same(got, want)


def test_main_writes_the_same_files(tmp_path):
    rep = [p for p in REPORTS if p.endswith("report_tpu_opt.csv")][0]
    cmp_ = [p for p in REPORTS if p.endswith("report_tpu_H05.csv")][0]
    grid = [p for p in REPORTS if p.endswith("qpadmm_grid_1k.csv")][0]
    names = {}
    for label, mod in (("torch", plots), ("jax", jplots)):
        out = str(tmp_path / label)
        mod.main([rep, "--compare", cmp_, "--grid", grid, "--out", out])
        names[label] = sorted(os.listdir(out))
        for name in names[label]:
            assert os.path.getsize(os.path.join(out, name)) > 0, name
    assert names["torch"] == names["jax"]
    assert names["torch"] == sorted(["fer.png", "time.png", "hamming.png",
                                     "fer_compare.png", "qpadmm_grid.png"])


def test_timer_accumulates():
    t = Timer()
    for _ in range(3):
        with t:
            time.sleep(0.01)
    assert 0.03 <= t.total < 1.0
    t.start()
    before = t.total
    assert t.stop(torch.ones(2)) > before      # CPU tensors: no sync


def test_trace_writes_a_chrome_trace(tmp_path):
    """The operator's use: a harness call under ``trace`` leaves the
    program's spans in the exported trace."""
    h = read_pcm(os.path.join(os.path.dirname(__file__), "..", "data",
                              "H.txt"))
    cw = torch.zeros((4, h.shape[1]), dtype=torch.uint8)
    out = str(tmp_path / "trace")
    with trace(out):
        torch.ones(64, 64).matmul(torch.ones(64, 64)).sum()
        run_experiment(BPDecoder(h, max_iter=5, device="cpu"), h, cw, 1.0, 3,
                       batch_size=4, device="cpu", warmup=False)
    files = os.listdir(out)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(os.path.join(out, files[0])) as f:
        events = json.load(f)["traceEvents"]
    names = {str(e.get("name", "")) for e in events}
    assert any("matmul" in name for name in names)
    assert {"harness.block", "harness.channel", "bp.decode"} <= names
    with trace(None):                # no directory: nothing recorded
        torch.ones(2).sum()
