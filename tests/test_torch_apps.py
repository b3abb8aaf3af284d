"""Config, report writer and sweep app of the PyTorch port against the JAX
package: the same command lines parse to the same values, the same counters
write the same CSV bytes, and the sweep runs BP and ALP on the CPU."""
import csv
import dataclasses
import inspect
import os

import pytest
import torch

from ldpc_tpu import config as jconfig
from ldpc_tpu.decoders import DEFAULT_BATCH as JDEFAULT_BATCH
from ldpc_tpu.harness.experiment import ExperimentResult as JResult
from ldpc_tpu.harness.report import ReportWriter as JReportWriter
from ldpc_tpu_torch import config
from ldpc_tpu_torch.apps import benchmark
from ldpc_tpu_torch.decoders import (DECODER_NAMES, DEFAULT_BATCH,
                                     default_batch, make_decoder)
from ldpc_tpu_torch.decoders.agc_alp import AGCALPDecoder
from ldpc_tpu_torch.decoders.alp import ALPDecoder, _AdaptiveLPBase
from ldpc_tpu_torch.decoders.bp import BPDecoder
from ldpc_tpu_torch.harness import report
from ldpc_tpu_torch.harness.experiment import ExperimentResult, run_experiment
from ldpc_tpu_torch.ops import pdhg_kernel

ROOT = os.path.join(os.path.dirname(__file__), "..")
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small tensors: one intra-op thread, so parallel test workers do not
    oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _parse(mod, argv):
    import argparse
    cfg = mod.SweepConfig()
    p = argparse.ArgumentParser()
    mod.add_dataclass_args(p, cfg)
    return dataclasses.asdict(mod.apply_args(cfg, p.parse_args(argv)))


@pytest.mark.parametrize("argv", [
    [],
    ["--decoders", "bp", "alp", "--snrs=-3.0", "--trials", "2048"],
    ["--decoders", "alp,agc-alp", "--snrs=-1.0,0.5", "--trials", "9",
     "--batch-size", "128", "--shard", "false", "--resume", "yes",
     "--lp-iters", "32", "--lp-int-tol", "0.05", "--bp-layout", "edge",
     "--generator", "g.txt", "--extended-report", "ext.csv"],
])
def test_config_parses_like_jax(argv):
    assert _parse(config, argv) == _parse(jconfig, argv)


def test_config_defaults_match_jax():
    assert dataclasses.asdict(config.SweepConfig()) == \
        dataclasses.asdict(jconfig.SweepConfig())
    assert config.DEFAULT_SNRS == jconfig.DEFAULT_SNRS
    assert DEFAULT_BATCH == JDEFAULT_BATCH
    assert DECODER_NAMES == ("bp", "qp-admm", "full-lp", "alp", "agc-alp")
    assert default_batch("ALP") == 256 and default_batch("other") == 256


@pytest.mark.parametrize("extended", [False, True])
def test_report_writer_bytes_match_jax(tmp_path, extended):
    counters = [dict(total=2048, correct=70, pseudo=3, sum_hamming=51234,
                     sum_hamming_ok=1700, sum_hamming_wrong=49534,
                     time_sec=1.6180339, sum_iterations=23117,
                     sum_dropped=5),
                dict(total=64, correct=64, pseudo=0, sum_hamming=300,
                     sum_hamming_ok=300, sum_hamming_wrong=0, time_sec=0.02,
                     sum_iterations=64, sum_dropped=0)]
    paths = {}
    for tag, writer, result in (("jax", JReportWriter, JResult),
                                ("port", report.ReportWriter,
                                 ExperimentResult)):
        path = str(tmp_path / f"{tag}.csv")
        with writer(path, extended=extended) as rep:
            rep.write_row("ALP", -3.0, result(**counters[0]))
            rep.write_row("BP", 0.5, result(**counters[1]))
        # resume: re-running a point replaces its row
        with writer(path, extended=extended, resume=True) as rep:
            rep.write_row("ALP", -3.0, result(**counters[1]))
        paths[tag] = path
    with open(paths["jax"], "rb") as f:
        want = f.read()
    with open(paths["port"], "rb") as f:
        got = f.read()
    assert got == want
    header = report.EXTENDED_HEADER if extended else report.REFERENCE_HEADER
    assert got.decode().splitlines()[0] == header
    assert len(got.decode().splitlines()) == 3


def test_sweep_runs_bp_and_alp_on_cpu(tmp_path, capsys):
    rep, ext = tmp_path / "r.csv", tmp_path / "re.csv"
    before = pdhg_kernel.LAUNCHES
    rows = benchmark.main([
        "--matrix", os.path.join(ROOT, "data", "H.txt"),
        "--decoders", "bp", "alp", "--snrs=-1.0", "--trials", "64",
        "--report", str(rep), "--extended-report", str(ext),
        "--bp-max-iter", "20", "--device", "cpu"])
    assert [(name, snr) for name, snr, _ in rows] == [("BP", -1.0),
                                                      ("ALP", -1.0)]
    assert pdhg_kernel.LAUNCHES == before
    with open(rep) as f:
        recs = list(csv.DictReader(f))
    assert [r["Method"] for r in recs] == ["BP", "ALP"]
    with open(ext) as f:
        ext_recs = list(csv.DictReader(f))
    for (_, _, res), rec in zip(rows, ext_recs):
        assert res.total == int(rec["Trials"]) == 64
        assert 0.0 <= res.fer <= 1.0 and res.throughput > 0
    alp = rows[1][2]
    assert alp.sum_iterations >= 64 and int(ext_recs[1]["Dropped"]) == 0
    assert "Algo: ALP" in capsys.readouterr().out


def test_make_decoder_and_unported_names(small_h):
    cfg = config.DecoderConfig(bp_max_iter=7, lp_iters=32)
    bp = make_decoder("BP", small_h, cfg, device=CPU)
    assert isinstance(bp, BPDecoder) and bp.max_iter == 7
    alp = make_decoder("alp", small_h, cfg, device=CPU)
    assert isinstance(alp, ALPDecoder) and alp.lp_iters == 32
    assert alp.lp_backend == "xla" and alp.lp_max_iters == 2048
    for kind in ("agc-alp", "agc"):
        agc = make_decoder(kind, small_h, cfg, device=CPU)
        assert isinstance(agc, AGCALPDecoder) and agc.lp_iters == 32
        assert agc.lp_backend == "ipm" and agc.max_rows == 1000
    for kind, item in (("qp-admm", "item 8"), ("admm", "item 8"),
                       ("full-lp", "item 10")):
        with pytest.raises(NotImplementedError, match=item):
            make_decoder(kind, small_h, device=CPU)
    with pytest.raises(ValueError, match="unknown decoder"):
        make_decoder("nope", small_h, device=CPU)


def test_sweep_raises_on_unported_decoder(tmp_path):
    cfg = config.SweepConfig(matrix=os.path.join(ROOT, "data", "H.txt"),
                             decoders=("qp-admm",), snrs=(0.0,), trials=8,
                             report=str(tmp_path / "r.csv"),
                             extended_report=None)
    with pytest.raises(NotImplementedError, match="QP-ADMM"):
        benchmark.run_sweep(cfg, device="cpu", log=lambda *a, **k: None)


ENTRY_POINTS = {"BPDecoder": BPDecoder, "ALPDecoder": ALPDecoder,
                "AGCALPDecoder": AGCALPDecoder,
                "_AdaptiveLPBase": _AdaptiveLPBase,
                "make_decoder": make_decoder,
                "run_experiment": run_experiment}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_default_to_the_card(name):
    """The library's entry points run on the card unless the caller asks
    for the CPU, as the JAX package runs on its default accelerator."""
    param = inspect.signature(ENTRY_POINTS[name]).parameters["device"]
    assert param.default == "cuda"


@pytest.mark.parametrize("name", ["BPDecoder", "ALPDecoder", "AGCALPDecoder",
                                  "make_decoder", "run_experiment"])
def test_default_device_fails_loudly_without_a_card(name, small_h,
                                                    monkeypatch):
    """With no card visible the default does not carry on on the CPU."""
    cpu_dec = BPDecoder(small_h, max_iter=5, device=CPU)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = {"BPDecoder": lambda: BPDecoder(small_h),
             "ALPDecoder": lambda: ALPDecoder(small_h),
             "AGCALPDecoder": lambda: AGCALPDecoder(small_h),
             "make_decoder": lambda: make_decoder("bp", small_h),
             "run_experiment": lambda: run_experiment(
                 cpu_dec, small_h, torch.zeros((4, cpu_dec.n)), 1.0, 1)}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[name]()
