"""Config, report writer, reference data and apps of the PyTorch port
against the JAX package: the same command lines parse to the same values,
the same counters write the same CSV bytes, the golden tables are equal, the
sweep runs BP and ALP and the default decoder list on the CPU, and the
(alpha, mu) grid and parity apps run on tiny budgets."""
import argparse
import csv
import dataclasses
import inspect
import json
import os

import pytest
import torch

from ldpc_tpu import config as jconfig
from ldpc_tpu.decoders import DEFAULT_BATCH as JDEFAULT_BATCH
from ldpc_tpu.harness import reference_data as jref
from ldpc_tpu.harness.experiment import ExperimentResult as JResult
from ldpc_tpu.harness.report import ReportWriter as JReportWriter
from ldpc_tpu_torch import config
from ldpc_tpu_torch.apps import (benchmark, qpadmm_grid, scaling_bench,
                                 validate)
from ldpc_tpu_torch.decoders import (DECODER_NAMES, DEFAULT_BATCH,
                                     default_batch, make_decoder)
from ldpc_tpu_torch.decoders.admm import QPADMMDecoder
from ldpc_tpu_torch.decoders.agc_alp import AGCALPDecoder
from ldpc_tpu_torch.decoders.alp import ALPDecoder, _AdaptiveLPBase
from ldpc_tpu_torch.decoders.bp import BPDecoder
from ldpc_tpu_torch.decoders.lp import FullLPDecoder
from ldpc_tpu_torch.harness import reference_data, report
from ldpc_tpu_torch.harness.experiment import (ExperimentResult,
                                               run_experiment,
                                               run_multi_snr_experiment,
                                               run_streaming_experiment)
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
    """Every JAX registry name and alias builds its decoder (none is left
    unported), with the config's fields."""
    cfg = config.DecoderConfig(bp_max_iter=7, lp_iters=32, admm_alpha=1.1,
                               admm_mu=0.6, admm_max_iter=321,
                               admm_eps_stop=1e-6, full_lp_iters=77,
                               lp_int_tol=0.05)
    bp = make_decoder("BP", small_h, cfg, device=CPU)
    assert isinstance(bp, BPDecoder) and bp.max_iter == 7
    alp = make_decoder("alp", small_h, cfg, device=CPU)
    assert isinstance(alp, ALPDecoder) and alp.lp_iters == 32
    assert alp.lp_backend == "xla" and alp.lp_max_iters == 2048
    for kind in ("agc-alp", "agc"):
        agc = make_decoder(kind, small_h, cfg, device=CPU)
        assert isinstance(agc, AGCALPDecoder) and agc.lp_iters == 32
        assert agc.lp_backend == "ipm" and agc.max_rows == 1000
    for kind in ("qp-admm", "qpadmm", "admm"):
        dec = make_decoder(kind, small_h, cfg, device=CPU)
        assert isinstance(dec, QPADMMDecoder)
        assert (dec.alpha, dec.mu, dec.max_iter, dec.eps_stop) == \
            (1.1, 0.6, 321, 1e-6)
    for kind in ("full-lp", "fulllp"):
        dec = make_decoder(kind, small_h, cfg, device=CPU)
        assert isinstance(dec, FullLPDecoder)
        assert (dec.iters, dec.int_tol) == (77, 0.05)
    with pytest.raises(ValueError, match="unknown decoder"):
        make_decoder("nope", small_h, device=CPU)


def test_sweep_runs_the_default_decoder_list(tmp_path, capsys):
    """``SweepConfig.decoders``' default (BP, QP-ADMM, ALP, AGC-ALP) runs
    to its end on the CPU and writes four rows; QP-ADMM (16 trials, batch
    8) and AGC-ALP stream, ALP does not."""
    assert config.SweepConfig().decoders == ("bp", "qp-admm", "alp",
                                             "agc-alp")
    rep, ext = tmp_path / "r.csv", tmp_path / "re.csv"
    rows = benchmark.main([
        "--matrix", os.path.join(ROOT, "data", "H.txt"), "--snrs=1.0",
        "--trials", "16", "--batch-size", "8", "--report", str(rep),
        "--extended-report", str(ext), "--admm-max-iter", "300",
        "--lp-max-rounds", "8", "--bp-max-iter", "20", "--device", "cpu"])
    names = ["BP", "QP-ADMM", "ALP", "AGC-ALP"]
    assert [(name, snr) for name, snr, _ in rows] == \
        [(n, 1.0) for n in names]
    with open(rep) as f:
        assert [r["Method"] for r in csv.DictReader(f)] == names
    with open(ext) as f:
        ext_recs = list(csv.DictReader(f))
    for (_, _, res), rec in zip(rows, ext_recs):
        assert res.total == int(rec["Trials"]) == 16
        assert 0.0 <= res.fer <= 1.0 and res.throughput > 0
    out = capsys.readouterr().out
    assert all(f"Algo: {n}" in out for n in names)


def test_reference_data_equals_jax():
    for name in ("REF_TRIALS", "Z_BOUND", "SNR_GRID", "REF_FER_OPT",
                 "REF_FER_H05", "REF_TABLES"):
        assert getattr(reference_data, name) == getattr(jref, name), name
    for matrix in ("optimalH", "H05"):
        for method in ("BP", "QP-ADMM", "ALP", "AGC-ALP"):
            for snr in jref.SNR_GRID:
                p = jref.ref_fer(matrix, method, snr)
                assert reference_data.ref_fer(matrix, method, snr) == p
                assert reference_data.suggested_trials(p) == \
                    jref.suggested_trials(p)
    assert reference_data.z_score(0.3, 2048, 0.2751) == \
        jref.z_score(0.3, 2048, 0.2751)


@pytest.mark.parametrize("argv", [
    [], ["--trials", "256", "--alpha-min", "1.1", "--alpha-max", "1.3",
         "--alpha-count", "3", "--mu-count", "5", "--batch-cells", "4",
         "--snr=-2.5", "--grid-out", "g.csv", "--admm-eps-stop", "1e-6"]])
def test_grid_config_parses_like_jax(argv):
    out = []
    for mod in (config, jconfig):
        cfg = mod.GridSearchConfig()
        p = argparse.ArgumentParser()
        mod.add_dataclass_args(p, cfg)
        out.append(dataclasses.asdict(mod.apply_args(cfg, p.parse_args(
            argv))))
    assert out[0] == out[1]


def test_qpadmm_grid_on_cpu(tmp_path):
    """A 3 x 3 grid on ``data/H.txt``, one cell infeasible: infeasible
    cells read FER 1.0 without a decode, each feasible cell's FER equals a
    ``QPADMMDecoder`` run at that cell on the same LLRs, and the CSV has
    JAX's header and one row per cell."""
    out = tmp_path / "grid.csv"
    argv = ["--matrix", os.path.join(ROOT, "data", "H.txt"), "--trials",
            "24", "--snr=1.0", "--alpha-min", "1.0", "--alpha-max", "4.2",
            "--alpha-count", "3", "--mu-min", "0.3", "--mu-max", "0.55",
            "--mu-count", "3", "--admm-max-iter", "200", "--batch-cells",
            "2", "--grid-out", str(out), "--device", "cpu"]
    logs = []
    cfg = config.GridSearchConfig()
    p = argparse.ArgumentParser()
    config.add_dataclass_args(p, cfg)
    p.add_argument("--device")
    config.apply_args(cfg, p.parse_args(argv))
    fers, best = qpadmm_grid.run_grid(cfg, device="cpu",
                                      log=lambda *a, **k: logs.append(a))
    assert len(fers) == 9
    h = benchmark.read_pcm(cfg.matrix)
    cw, llrs = qpadmm_grid.grid_channel(cfg, h, CPU)
    e_min = QPADMMDecoder(h, device=CPU).structure.e_min
    for (a, m), fer in fers.items():
        if not e_min * m > a:
            assert fer == 1.0
            continue
        res = QPADMMDecoder(h, alpha=a, mu=m, max_iter=200,
                            device=CPU).decode_batch(llrs)
        correct = res.success & (res.bits == cw).all(-1)
        assert fer == (1.0 - correct.to(torch.float32).mean()).item()
    assert min(fers.values()) == best[0] < 1.0
    assert ("Best parameters:",) in logs
    lines = out.read_text().splitlines()
    assert lines[0] == "Alpha,Mu,FER" and len(lines) == 10


def test_validate_on_cpu(tmp_path):
    """The parity app on a tiny budget: QP-ADMM at one SNR, trials capped
    by --max-trials, a report and a table written, verdict PASS."""
    rep, table = tmp_path / "v.csv", tmp_path / "v.md"
    rows = validate.validate(matrix="optimalH", decoders=("qp-admm",),
                             max_trials=48, snrs=(0.0,), report=str(rep),
                             table_out=str(table), device="cpu",
                             log=lambda *a, **k: None)
    assert len(rows) == 1 and rows[0]["n"] == 48
    assert rows[0]["method"] == "QP-ADMM" and rows[0]["verdict"] == "PASS"
    with open(rep) as f:
        assert [r["Method"] for r in csv.DictReader(f)] == ["QP-ADMM"]
    assert "| QP-ADMM | +0.0 |" in table.read_text()
    with pytest.raises(SystemExit):
        validate.validate(decoders=("full-lp",), device="cpu",
                          report=str(rep), log=lambda *a, **k: None)


ENTRY_POINTS = {"BPDecoder": BPDecoder, "ALPDecoder": ALPDecoder,
                "AGCALPDecoder": AGCALPDecoder,
                "_AdaptiveLPBase": _AdaptiveLPBase,
                "QPADMMDecoder": QPADMMDecoder,
                "FullLPDecoder": FullLPDecoder,
                "make_decoder": make_decoder,
                "run_experiment": run_experiment,
                "run_streaming_experiment": run_streaming_experiment,
                "run_multi_snr_experiment": run_multi_snr_experiment,
                "run_grid": qpadmm_grid.run_grid,
                "validate": validate.validate}


def test_scaling_bench_takes_jax_layout_flag(capsys):
    """JAX's command line, ``--layout`` included, runs the port's
    ``scaling_bench``: the flag is accepted and ignored, the keys are those
    of a run without it, and ``layout`` says what the port ran."""
    argv = ["--matrix", os.path.join(ROOT, "data", "H.txt"), "--trials",
            "256", "--batch-per-device", "64", "--device", "cpu"]
    outs = [scaling_bench.main(["--layout", "mxu", *argv]),
            scaling_bench.main(argv)]
    printed = capsys.readouterr().out.strip().splitlines()
    assert [json.loads(line) for line in printed] == outs
    assert set(outs[0]) == set(outs[1])
    assert {"devices", "processes", "layout", "throughput_1dev"} <= \
        set(outs[0])
    assert outs[0]["layout"] == "torch-ref"
    assert outs[0]["counters_1dev"] == outs[1]["counters_1dev"]
    assert outs[0]["counters_1dev"]["total"] == 256


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_default_to_the_card(name):
    """The library's entry points run on the card unless the caller asks
    for the CPU, as the JAX package runs on its default accelerator."""
    param = inspect.signature(ENTRY_POINTS[name]).parameters["device"]
    assert param.default == "cuda"


@pytest.mark.parametrize("name", ["BPDecoder", "ALPDecoder", "AGCALPDecoder",
                                  "QPADMMDecoder", "FullLPDecoder",
                                  "make_decoder", "run_experiment",
                                  "run_streaming_experiment",
                                  "run_multi_snr_experiment"])
def test_default_device_fails_loudly_without_a_card(name, small_h,
                                                    monkeypatch):
    """With no card visible the default does not carry on on the CPU."""
    cpu_dec = BPDecoder(small_h, max_iter=5, device=CPU)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = {"BPDecoder": lambda: BPDecoder(small_h),
             "ALPDecoder": lambda: ALPDecoder(small_h),
             "AGCALPDecoder": lambda: AGCALPDecoder(small_h),
             "make_decoder": lambda: make_decoder("bp", small_h),
             "QPADMMDecoder": lambda: QPADMMDecoder(small_h),
             "FullLPDecoder": lambda: FullLPDecoder(small_h),
             "run_experiment": lambda: run_experiment(
                 cpu_dec, small_h, torch.zeros((4, cpu_dec.n)), 1.0, 1),
             "run_streaming_experiment": lambda: run_streaming_experiment(
                 cpu_dec, small_h, torch.zeros((4, cpu_dec.n)), 1.0, 1),
             "run_multi_snr_experiment": lambda: run_multi_snr_experiment(
                 cpu_dec, small_h, torch.zeros((4, cpu_dec.n)), [1.0], 1)}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[name]()
