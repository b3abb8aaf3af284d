"""Experiment harness of the PyTorch port: the whole slice against the JAX
package's ``make_experiment_step`` (exact counters on the same received
symbols), batching determinism, FER parity, and the port's isolation from
JAX."""
import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_tpu.channel.awgn import bpsk as jbpsk
from ldpc_tpu.channel.awgn import llr_variance as jllr_variance
from ldpc_tpu.decoders.bp import BPDecoder as JBPDecoder
from ldpc_tpu.harness.experiment import make_experiment_step as jmake_step
from ldpc_tpu.harness.experiment import run_experiment as jrun_experiment
from ldpc_tpu_torch.codes.gf2 import gf2_nullspace
from ldpc_tpu_torch.codes.io import read_pcm
from ldpc_tpu_torch.decoders.bp import BPDecoder
from ldpc_tpu_torch.harness.experiment import (COUNTERS, ExperimentResult,
                                               channel_step, count_step,
                                               make_experiment_step,
                                               run_experiment)
from ldpc_tpu_torch.harness.reference_data import Z_BOUND, z_score
from ldpc_tpu_torch.ops import _build, bp_kernel

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


def _codewords(h, num, seed):
    g, _ = gf2_nullspace(h)
    rng = np.random.default_rng(seed)
    return ((rng.integers(0, 2, (num, g.shape[0])) @ g) % 2).astype(np.uint8)


def _counters(res: ExperimentResult):
    return tuple(getattr(res, k) for k in COUNTERS)


@pytest.mark.parametrize("name,snr,lanes", [("H", 1.0, 256),
                                            ("optimalH", -3.0, 256),
                                            ("optimalH", -1.0, 128)])
def test_whole_slice_counters_match_jax(name, snr, lanes):
    """Received symbols made as ``ldpc_tpu/harness/experiment.py:108-111``
    does go through the port's counting step (CPU decoder); all eight
    counters equal JAX's step on the same codewords and trial indices."""
    h = read_pcm(os.path.join(ROOT, "data", f"{name}.txt"))
    cw = _codewords(h, lanes, seed=lanes + int(snr))
    idx = np.arange(1000, 1000 + lanes, dtype=np.int32)
    key = jax.random.PRNGKey(17)
    jdec = JBPDecoder(h, max_iter=30, layout="edge")
    want = jmake_step(jdec, h, snr, key)(jnp.asarray(cw), jnp.asarray(idx))

    sigma = float(np.sqrt(float(jllr_variance(snr))))

    @jax.jit
    def received(codewords, trial_idx):
        keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(trial_idx)
        noise = jax.vmap(
            lambda k: jax.random.normal(k, (h.shape[1],), jnp.float32))(keys)
        return jbpsk(codewords) + sigma * noise

    y = np.array(received(jnp.asarray(cw), jnp.asarray(idx)))
    got = count_step(BPDecoder(h, max_iter=30, device=CPU),
                     torch.from_numpy(h), torch.from_numpy(cw),
                     torch.from_numpy(y), snr)
    assert got.dtype == torch.int64
    assert dict(zip(COUNTERS, got.tolist())) == \
        {k: int(v) for k, v in want.items()}


def test_determinism_across_batch_sizes(small_h):
    cw = _codewords(small_h, 64, seed=1)
    dec = BPDecoder(small_h, max_iter=15, device=CPU)
    r1 = run_experiment(dec, small_h, cw, snr=1.0, seed=1, batch_size=64,
                        device=CPU)
    r2 = run_experiment(dec, small_h, cw, snr=1.0, seed=1, batch_size=16,
                        device=CPU)
    assert _counters(r1) == _counters(r2)
    assert r1.total == 64 and r1.time_sec > 0


def test_remainder_batch(small_h):
    cw = _codewords(small_h, 50, seed=3)          # not divisible by 32
    dec = BPDecoder(small_h, max_iter=10, device=CPU)
    res = run_experiment(dec, small_h, cw, snr=2.0, seed=3, batch_size=32,
                         device=CPU)
    whole = run_experiment(dec, small_h, cw, snr=2.0, seed=3, batch_size=50,
                           warmup=False, device=CPU)
    assert res.total == 50
    assert _counters(res) == _counters(whole)
    assert res.correct + res.pseudo <= res.total
    assert res.sum_hamming == res.sum_hamming_ok + res.sum_hamming_wrong
    assert res.fer == (50 - res.correct) / 50


def test_step_is_channel_then_count(small_h):
    cw = torch.from_numpy(_codewords(small_h, 32, seed=4))
    idx = torch.arange(32)
    dec = BPDecoder(small_h, max_iter=10, device=CPU)
    out = make_experiment_step(dec, small_h, 0.5, 8, "cpu")(cw, idx)
    y = channel_step(cw, idx, 0.5, 8)
    assert torch.equal(out, count_step(dec, torch.from_numpy(small_h), cw, y,
                                       0.5))
    assert out.shape == (len(COUNTERS),) and out[0] == 32


def test_fer_matches_jax_run(small_h):
    """Different noise streams, same code, decoder and SNR: the two FERs
    agree under the two-proportion z-test."""
    trials, snr = 1024, -1.0
    cw = _codewords(small_h, trials, seed=9)
    ref = jrun_experiment(JBPDecoder(small_h, max_iter=20, layout="edge"),
                          small_h, cw, snr, jax.random.PRNGKey(9),
                          batch_size=256)
    res = run_experiment(BPDecoder(small_h, max_iter=20, device=CPU),
                         small_h, cw, snr, seed=9, batch_size=256,
                         device=CPU)
    assert 0.05 < ref.fer < 0.95
    assert abs(z_score(res.fer, trials, ref.fer, trials)) < Z_BOUND
    assert abs(res.sum_iterations / trials - ref.sum_iterations / trials) \
        < 0.15 * ref.sum_iterations / trials


def test_bench_runs_on_cpu(capsys):
    from ldpc_tpu_torch import bench
    out = bench.main(trials=96, batch_size=64, device="cpu")
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out
    extra = out["extra"]
    assert extra["trials"] == 96 and extra["device"] == "cpu"
    assert extra["layout"] == "torch-ref" and extra["bp_kernel_launches"] == 0
    assert 0.0 < extra["fer_100it"] < 1.0 and out["value"] > 0
    assert bench.FER_REF_100IT == 0.4860


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys, torch\n"
        "import ldpc_tpu_torch\n"
        "for m in pkgutil.walk_packages(ldpc_tpu_torch.__path__,\n"
        "                               'ldpc_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from ldpc_tpu_torch.codes.io import read_pcm\n"
        "from ldpc_tpu_torch.decoders.bp import BPDecoder\n"
        "h = read_pcm('data/H.txt')\n"
        "res = BPDecoder(h, max_iter=5, device='cpu').decode_batch(\n"
        "    torch.ones(4, 128))\n"
        "assert bool(res.success.all())\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax',"
        " 'jaxlib', 'ldpc_tpu')]\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr


def test_kernel_wrapper_raises_on_cpu_tensor(small_h):
    dec = BPDecoder(small_h, device=CPU)
    before = bp_kernel.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        bp_kernel.bp_decode(torch.zeros(4, dec.n), dec.row_col,
                            dec.col_from_row, 10)
    assert bp_kernel.LAUNCHES == before


def test_build_raises_without_nvcc(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()


def test_experiment_result_properties():
    res = ExperimentResult(total=100, correct=80, pseudo=2, sum_hamming=500,
                           sum_hamming_ok=300, sum_hamming_wrong=200,
                           time_sec=2.0, sum_iterations=1000)
    assert res.fer == 0.2 and res.throughput == 50.0
    assert res.avg_time == 0.02 and res.mean_hamming == 5.0
    assert res.mean_hamming_ok == 300 / 80 and res.mean_hamming_wrong == 10.0
    assert math.isinf(ExperimentResult().throughput)
