"""``scripts/torch_opt_before_after.py``, the port's counterpart of the JAX
package's ``scripts/opt_before_after.py``, on the CPU at a small budget
(a few trials, QP-ADMM cut to a few iterations): it reads the JAX run's
state and best matrix (the state format is shared), writes the JAX
artifact's keys, and its FERs are the port's ``PopulationEvaluator``'s on
the four matrices. The FERs at the full budget are held to the JAX run's
on the card (``chip_smoke.py``).
"""
import json
import os

import numpy as np
import pytest
import torch

from ldpc_tpu_torch.apps.optimize_h import PopulationEvaluator
from ldpc_tpu_torch.codes.io import read_pcm
from ldpc_tpu_torch.codes.qc import QCMatrix
from ldpc_tpu_torch.config import OptimizeConfig
from scripts import torch_opt_before_after as tool

ROOT = os.path.join(os.path.dirname(__file__), "..")
STATE = os.path.join(ROOT, "data", "optimize_state.json")
OPTIMIZED = os.path.join(ROOT, "data", "optimalH_tpu.txt")
TRIALS, ITERS = 16, 100


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _fers(init, cfg):
    """The four matrices' FERs by one evaluator call, as the tool scores
    them."""
    mats = [init, read_pcm(OPTIMIZED),
            read_pcm(os.path.join(ROOT, "data", "optimalH.txt")),
            read_pcm(os.path.join(ROOT, "data", "H05.txt"))]
    ev = PopulationEvaluator(cfg, cfg.block_cols * cfg.block_size,
                             device="cpu")
    return ev.evaluate(mats, OptimizeConfig().seed, TRIALS, max_iter=ITERS)


def test_before_after_on_the_jax_run():
    """JAX's keys, the state's generation and each config; every FER is
    the evaluator's on (initial, optimized, optimalH, H05), and the
    improvement is initial minus optimized."""
    out = tool.before_after(STATE, OPTIMIZED, TRIALS, device="cpu",
                            max_iter=ITERS)
    with open(os.path.join(ROOT, "reports",
                           "optimize_before_after.json")) as f:
        jax_out = json.load(f)
    assert set(out) == set(jax_out)
    assert set(out["objective_config"]) == set(jax_out["objective_config"])
    assert set(out["report_config"]) == set(jax_out["report_config"])
    with open(STATE) as f:
        st = json.load(f)
    assert out["proposals_evaluated"] == st["generation"]
    assert (out["trials"], out["snr"]) == (TRIALS, -3.0)
    assert out["objective_config"] == dict(alpha=1.95, mu=0.5,
                                           admm_iters=ITERS)
    assert out["report_config"] == dict(alpha=1.2, mu=0.55,
                                        admm_iters=ITERS)
    cfg = OptimizeConfig()
    init = QCMatrix(cfg.block_size, np.array(st["initial"]["present"], bool),
                    np.array(st["initial"]["shifts"], np.int64)).to_dense()
    names = ("initial", "optimized", "reference_optimalH", "H05")
    for prefix, c in (("fer_", cfg),
                      ("report_fer_", OptimizeConfig(**tool.REPORT))):
        want = _fers(init, c)
        assert [out[prefix + k] for k in names] == want.tolist(), prefix
    assert out["improvement"] == out["fer_initial"] - out["fer_optimized"]


def test_seed_init_rederives_the_initial_matrix(capsys):
    """``--seed-init`` takes the initial matrix from OptimizeConfig's seed
    (``QCMatrix.random``), with a warning, as the JAX script does."""
    out = tool.before_after(STATE, OPTIMIZED, TRIALS, seed_init=True,
                            device="cpu", max_iter=ITERS)
    assert "WARNING" in capsys.readouterr().err
    cfg = OptimizeConfig()
    init = QCMatrix.random(np.random.default_rng(cfg.seed), cfg.block_size,
                           cfg.block_rows, cfg.block_cols).to_dense()
    assert out["fer_initial"] == float(_fers(init, cfg)[0])


@pytest.mark.parametrize("flag", ["--state", "--optimized"])
def test_missing_file_names_its_flag(flag, tmp_path):
    """A missing state or optimized matrix raises, naming the flag that
    takes another run's file."""
    paths = {"--state": STATE, "--optimized": OPTIMIZED}
    paths[flag] = str(tmp_path / "absent")
    with pytest.raises(FileNotFoundError, match=flag):
        tool.before_after(paths["--state"], paths["--optimized"], TRIALS,
                          device="cpu", max_iter=ITERS)


def test_missing_default_state_names_the_flag(tmp_path, monkeypatch):
    """Run with no flags where the port's own run left no state: the
    error names ``--state`` (and JAX's state file for it)."""
    monkeypatch.setattr(tool, "DATA", tmp_path)
    with pytest.raises(FileNotFoundError,
                       match="--state data/optimize_state.json"):
        tool.main(["4", "--device", "cpu"])
