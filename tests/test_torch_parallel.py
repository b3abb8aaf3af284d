"""Multi-process trial sharding of the PyTorch port
(``ldpc_tpu_torch/parallel``, the runners' ``sharding``, the sweep's
``--shard``, the optimizer's population sharding and ``scaling_bench``)
against the unsharded port and the JAX package.

One module-scoped fixture spawns worlds of 1, 2 and 4 processes on the CPU
at once, joined over ``gloo`` through a file store, plus one lonely rank of
a world of 2. Each rank runs every check on ``data/H.txt`` and returns its
results; the world of 1 runs unsharded. The tests then hold:

* worlds 2 and 4 to world 1 exactly, in all eight counters, on every rank:
  BP batched with a remainder batch (300 trials in batches of 32, so the
  ranks hold different batch counts), the multi-SNR runner (a rank of the
  world of 4 holds no batch), ALP batched and QP-ADMM streamed;
* AGC-ALP streamed in a world of 2 against one stream, trial by trial:
  bits and success equal, rounds and cut counts differing only on trials
  whose solves stop with other lanes (the coupled stop test);
* the sweep app with ``--shard`` in a world of 2: one CSV, from rank 0, with
  world 1's counters; the optimizer (population 2, 2 generations) in a
  world of 2: world 1's state file and log lines, rank 1 silent;
* ``scaling_bench.main``: JAX's keys (``throughput_ndev`` and
  ``scaling_efficiency`` in the world of 2 only);
* the port's sharded BP FER against JAX's sharded run on the conftest's 8
  virtual devices, by the two-proportion z-test (the noise streams differ);
* a lonely rank raises instead of running as a world of 1.

The ``gpu`` case runs ``scaling_bench`` through ``torchrun`` on the card, as
a world of 1 over NCCL and of 2 over gloo
(``python -m pytest tests/test_torch_parallel.py -m gpu --noconftest``).
"""
import contextlib
import io
import json
import multiprocessing as mp
import os
import queue
import re
import subprocess
import sys
import time
import traceback
from datetime import timedelta

import numpy as np
import pytest
import torch
import torch.distributed as dist

from ldpc_tpu_torch.apps import benchmark, optimize_h, scaling_bench
from ldpc_tpu_torch.channel.awgn import noise_scales
from ldpc_tpu_torch.codes.gf2 import gf2_nullspace
from ldpc_tpu_torch.codes.io import read_pcm
from ldpc_tpu_torch.config import OptimizeConfig
from ldpc_tpu_torch.decoders.admm import QPADMMDecoder
from ldpc_tpu_torch.decoders.agc_alp import AGCALPDecoder
from ldpc_tpu_torch.decoders.alp import ALPDecoder
from ldpc_tpu_torch.decoders.bp import BPDecoder
from ldpc_tpu_torch.harness.experiment import (COUNTERS, channel_step,
                                               run_experiment,
                                               run_multi_snr_experiment,
                                               run_streaming_experiment)
from ldpc_tpu_torch.harness.reference_data import Z_BOUND, z_score
from ldpc_tpu_torch.parallel import distributed
from ldpc_tpu_torch.parallel.distributed import (initialize_distributed,
                                                 process_count,
                                                 process_index, shutdown)
from ldpc_tpu_torch.parallel.mesh import TrialSharding, make_trial_mesh

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
H_PATH = os.path.join(ROOT, "data", "H.txt")
CPU = torch.device("cpu")
WORLDS = (1, 2, 4)
JOIN_S = 120                  # every rank's deadline, then it is killed
EXACT = ("bp", "multi_snr", "alp", "qpadmm_streamed")
JAX_TRIALS, JAX_SNR, JAX_ITERS, JAX_SEED = 512, -1.0, 20, 11
SCALING_ARGS = ["--matrix", H_PATH, "--trials", "256", "--batch-per-device",
                "64", "--bp-iters", "10", "--device", "cpu"]
JAX_SCALING_KEYS = {"devices", "processes", "layout", "throughput_1dev"}


def _codewords(h, num, seed):
    g, _ = gf2_nullspace(h)
    rng = np.random.default_rng(seed)
    return ((rng.integers(0, 2, (num, g.shape[0])) @ g) % 2).astype(np.uint8)


def _counts(res):
    return [getattr(res, k) for k in COUNTERS]


class _TrialLog(AGCALPDecoder):
    """AGC-ALP that records each trial's outcome in the chunk where its lane
    finishes, the trial recognised by its lane's objective row ``c``
    (``tests/test_torch_streaming.py`` does the same)."""

    def __init__(self, h, llr_table):
        super().__init__(h, device=CPU)
        self.c_table = self._init_state(llr_table)["c"]
        self.log = {}

    def stream_chunk(self, st):
        before = st["done"].clone()
        st = super().stream_chunk(st)
        res = self._finish(st)
        for i in torch.nonzero(st["done"] & ~before).flatten().tolist():
            t = int(torch.nonzero((self.c_table == st["c"][i]).all(-1))[0])
            self.log[t] = (res.bits[i].tolist(), bool(res.success[i]),
                           *(int(st[k][i]) for k in ("rounds", "cum_h",
                                                     "cum_g", "dropped")))
        return st


def _quiet_log():
    lines = []

    def log(*args, **kwargs):
        if "file" not in kwargs:          # stdout lines, seconds masked
            lines.append(re.sub(r"\(\d+\.\d+s,", "(<s>,",
                                " ".join(str(a) for a in args)))
    return lines, log


def _checks(rank, world, tmp):
    """Every check of one rank; world 1 runs unsharded."""
    sh = make_trial_mesh(device="cpu") if world > 1 else None
    h = read_pcm(H_PATH)
    out = {"process": (process_index(), process_count())}

    cw = _codewords(h, 300, seed=7)
    res = run_experiment(BPDecoder(h, max_iter=20, device=CPU), h, cw, 1.0,
                         7, batch_size=32, device=CPU, sharding=sh)
    out["bp"], out["bp_time"] = _counts(res), res.time_sec

    multi = run_multi_snr_experiment(
        BPDecoder(h, max_iter=12, device=CPU), h, cw[:50], [0.0, 2.0], 5,
        batch_size=36, device=CPU, sharding=sh)
    out["multi_snr"] = [_counts(r) for r in multi]

    res = run_experiment(ALPDecoder(h, max_rounds=12, device=CPU), h,
                         cw[:48], 2.0, 5, batch_size=16, device=CPU,
                         sharding=sh)
    out["alp"] = _counts(res)

    res = run_streaming_experiment(
        QPADMMDecoder(h, max_iter=300, device=CPU), h, cw[:64], 0.0, 4,
        batch_size=16, device=CPU, sharding=sh)
    out["qpadmm_streamed"] = _counts(res)

    cw_jax = _codewords(h, JAX_TRIALS, seed=JAX_SEED)
    res = run_experiment(BPDecoder(h, max_iter=JAX_ITERS, device=CPU), h,
                         cw_jax, JAX_SNR, JAX_SEED, batch_size=64,
                         device=CPU, sharding=sh)
    out["jax_bp"] = _counts(res)

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out["scaling"] = scaling_bench.main(SCALING_ARGS)
    out["scaling_printed"] = buf.getvalue()

    if world > 2:
        return out

    cw16 = _codewords(h, 16, seed=6)
    y = channel_step(torch.from_numpy(cw16), torch.arange(16), 0.0, 6)
    dec = _TrialLog(h, noise_scales(0.0)[1] * y)
    res = run_streaming_experiment(dec, h, cw16, 0.0, 6, batch_size=8,
                                   device=CPU, warmup=False, sharding=sh)
    out["agc"] = _counts(res)
    out["agc_log"] = dec.log

    report = os.path.join(tmp, f"report_w{world}_r{rank}.csv")
    rows = benchmark.main(["--matrix", H_PATH, "--decoders", "bp",
                           "--snrs=-1.0,0.0", "--trials", "100",
                           "--batch-size", "16", "--report", report,
                           "--extended-report", "", "--device", "cpu"])
    out["sweep"] = [(name, snr, _counts(r)) for name, snr, r in rows]
    out["sweep_csv"] = (open(report).read() if os.path.exists(report)
                        else None)

    cfg = OptimizeConfig(
        block_size=4, block_rows=2, block_cols=4, trials=32, final_trials=32,
        snr=0.0, admm_max_iter=100, generations=4, population=2,
        save_path=os.path.join(tmp, f"opt_w{world}_r{rank}.txt"),
        state_path=os.path.join(tmp, f"opt_w{world}_r{rank}.json"))
    lines, log = _quiet_log()
    qc, final = optimize_h.optimize(cfg, log=log, device="cpu")
    out["opt_lines"] = lines
    out["opt_final"] = final
    out["opt_state"] = (open(cfg.state_path).read()
                        if os.path.exists(cfg.state_path) else None)
    return out


def _run_rank(rank, world, init_file, tmp, results):
    """Process target: join the world, run the checks, send the results."""
    torch.set_num_threads(1)
    try:
        if world == "lonely":                 # rank 0 of 2; rank 1 never
            try:
                initialize_distributed(init_method=f"file://{init_file}",
                                       world_size=2, rank=0, device="cpu",
                                       timeout=timedelta(seconds=3))
                out = {"raised": None}
            except Exception as err:          # what the test looks at
                out = {"raised": type(err).__name__,
                       "initialized": dist.is_initialized()}
        else:
            if world > 1:
                initialize_distributed(init_method=f"file://{init_file}",
                                       world_size=world, rank=rank,
                                       device="cpu")
            out = _checks(rank, world, tmp)
    except Exception:
        out = {"error": traceback.format_exc()}
    finally:
        shutdown()
    results.put((world, rank, out))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{(world, rank): that rank's results}, every world run at once."""
    tmp = tmp_path_factory.mktemp("worlds")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = []
    for world in (*WORLDS, "lonely"):
        size = 1 if world == "lonely" else world
        for rank in range(size):
            p = ctx.Process(target=_run_rank, daemon=True, args=(
                rank, world, str(tmp / f"store_{world}"), str(tmp), results))
            p.start()
            procs.append(p)
    deadline = time.monotonic() + JOIN_S
    found = {}
    try:
        while len(found) < len(procs):      # drain before joining
            left = max(deadline - time.monotonic(), 0.1)
            world, rank, out = results.get(timeout=left)
            found[(world, rank)] = out
    except queue.Empty:
        pass
    finally:
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
            if p.is_alive():
                p.kill()
                p.join(5)
    missing = [(p.pid, p.exitcode) for p in procs if p.exitcode != 0]
    assert len(found) == len(procs), (sorted(found), missing)
    errors = {k: v["error"] for k, v in found.items() if "error" in v}
    assert not errors, errors
    return found


def _ranks(worlds, world):
    return [worlds[(world, r)] for r in range(world)]


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("check", EXACT)
def test_sharded_counters_equal_world_one(worlds, world, check):
    want = worlds[(1, 0)][check]
    for rank, got in enumerate(_ranks(worlds, world)):
        assert got["process"] == (rank, world)
        assert got[check] == want, (check, rank)
    if check == "bp":
        assert want[0] == 300


@pytest.mark.parametrize("world", [2, 4])
def test_every_rank_reports_the_slowest_window(worlds, world):
    times = {r["bp_time"] for r in _ranks(worlds, world)}
    assert len(times) == 1 and times.pop() > 0


def test_agc_alp_sharded_stream_differs_only_on_coupled_trials(worlds):
    """Bits and success of every trial equal one stream's; a trial whose
    rounds or cut counts differ certifies in both runs with no cut dropped.
    The count of such trials is what ROADMAP's Known differences gives."""
    ref = worlds[(1, 0)]["agc_log"]
    got = {}
    for r in _ranks(worlds, 2):
        assert not set(got) & set(r["agc_log"])
        got.update(r["agc_log"])
    assert sorted(got) == sorted(ref) == list(range(16))
    differ = []
    for t in range(16):
        bits, ok, *counts = got[t]
        assert (bits, ok) == tuple(ref[t][:2]), t
        if counts != list(ref[t][2:]):
            differ.append(t)
            assert ok and counts[3] == ref[t][5] == 0, t
    assert len(differ) <= 3, differ
    counts = worlds[(2, 0)]["agc"]
    assert counts[:6] == worlds[(1, 0)]["agc"][:6]
    assert counts == worlds[(2, 1)]["agc"]


def test_sweep_shard_writes_one_csv_from_rank_zero(worlds):
    one, (r0, r1) = worlds[(1, 0)], _ranks(worlds, 2)
    assert r0["sweep"] == r1["sweep"] == one["sweep"]
    assert [row[1] for row in one["sweep"]] == [-1.0, 0.0]
    assert 0 < one["sweep"][0][2][1] < 100          # some frames fail
    assert r1["sweep_csv"] is None

    def counts_of(text):                 # AvgTime (column 5) is a time
        rows = [line.split(",") for line in text.strip().splitlines()]
        return [row[:4] + row[5:] for row in rows]

    assert counts_of(r0["sweep_csv"]) == counts_of(one["sweep_csv"])
    assert len(r0["sweep_csv"].strip().splitlines()) == 3


def test_optimizer_sharded_gives_world_one_state_and_log(worlds):
    one, (r0, r1) = worlds[(1, 0)], _ranks(worlds, 2)
    assert r0["opt_state"] == one["opt_state"] is not None
    assert json.loads(r0["opt_state"])["generation"] == 4
    assert r0["opt_lines"] == one["opt_lines"] and len(one["opt_lines"]) >= 3
    assert r0["opt_final"] == r1["opt_final"] == one["opt_final"]
    assert r1["opt_lines"] == [] and r1["opt_state"] is None


@pytest.mark.parametrize("world", [1, 2])
def test_scaling_bench_prints_jax_keys(worlds, world):
    ranks = _ranks(worlds, world)
    out = ranks[0]["scaling"]
    assert json.loads(ranks[0]["scaling_printed"]) == out
    assert all(r["scaling_printed"] == "" for r in ranks[1:])
    assert JAX_SCALING_KEYS <= set(out)
    assert out["devices"] == out["processes"] == world
    assert out["layout"] == "torch-ref" and out["throughput_1dev"] > 0
    assert out["bp_decode_launches"] == [0] * world
    assert out["counters_1dev"]["total"] == 256
    if world == 1:
        assert out["backend"] is None
        assert not {"throughput_ndev", "scaling_efficiency"} & set(out)
    else:
        assert out["backend"] == "gloo"
        assert out["throughput_ndev"] > 0 and out["scaling_efficiency"] > 0
        assert out["counters_ndev"] == out["counters_1dev"]


def test_lonely_rank_raises(worlds):
    out = worlds[("lonely", 0)]
    assert out["raised"] is not None and not out["initialized"]


def test_sharded_fer_agrees_with_jax(worlds):
    """The same codewords through JAX's ``run_experiment`` sharded over the
    conftest's 8 virtual devices and through the port's world of 2."""
    import jax
    from ldpc_tpu.decoders.bp import BPDecoder as JBPDecoder
    from ldpc_tpu.harness.experiment import run_experiment as jrun
    from ldpc_tpu.parallel.mesh import make_trial_mesh as jmesh

    h = read_pcm(H_PATH)
    cw = _codewords(h, JAX_TRIALS, seed=JAX_SEED)
    mesh = jmesh()
    assert mesh.num_devices == 8
    ref = jrun(JBPDecoder(h, max_iter=JAX_ITERS, layout="edge"), h, cw,
               JAX_SNR,
               jax.random.PRNGKey(JAX_SEED), batch_size=64, sharding=mesh)
    total, correct = worlds[(2, 0)]["jax_bp"][:2]
    assert total == ref.total == JAX_TRIALS
    fer = 1 - correct / total
    assert 0.05 < ref.fer < 0.95
    assert abs(z_score(fer, total, ref.fer, ref.total)) < Z_BOUND


def test_initialize_without_a_world_is_a_noop(monkeypatch, tmp_path):
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    initialize_distributed()
    initialize_distributed(init_method=f"file://{tmp_path}/s", world_size=1,
                           rank=0, device="cpu")
    assert not dist.is_initialized() and not os.path.exists(tmp_path / "s")
    assert process_count() == 1 and process_index() == 0
    assert not distributed.is_multi_host()
    mesh = make_trial_mesh(device="cpu")
    assert (mesh.rank, mesh.num_devices, mesh.group, mesh.device) == (
        0, 1, None, CPU)
    assert make_trial_mesh(group=[0], device="cpu") == mesh
    counters = torch.arange(8)
    assert mesh.all_sum(counters) is counters
    assert torch.equal(counters, torch.arange(8))
    assert mesh.all_max(2.5) == 2.5
    mesh.barrier()


def test_rank_without_a_card_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        initialize_distributed(init_method=f"file://{tmp_path}/s",
                               world_size=2, rank=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_trial_mesh()
    assert not dist.is_initialized()


def test_explicit_init_needs_world_size_and_rank(tmp_path):
    with pytest.raises(ValueError, match="world_size and rank"):
        initialize_distributed(init_method=f"file://{tmp_path}/s", rank=0,
                               device="cpu")
    assert not dist.is_initialized()


@pytest.mark.parametrize("count,world", [(10, 4), (3, 4), (64, 2), (0, 3),
                                         (7, 1)])
def test_work_splits_cover_every_unit_once(count, world):
    shards = [TrialSharding(r, world, CPU) for r in range(world)]
    spans = [s.span(count) for s in shards]
    assert spans[0][0] == 0 and spans[-1][1] == count
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    assert max(b - a for a, b in spans) - min(b - a for a, b in spans) <= 1
    items = list(range(count))
    strided = [s.strided(items) for s in shards]
    assert sorted(sum(strided, [])) == items
    assert all(x % world == r for r, part in enumerate(strided)
               for x in part)


def test_streaming_refuses_a_batch_that_does_not_divide(small_h):
    sh = TrialSharding(0, 3, CPU)
    with pytest.raises(ValueError, match="does not divide"):
        run_streaming_experiment(QPADMMDecoder(small_h, device=CPU), small_h,
                                 _codewords(small_h, 8, 1), 0.0, 1,
                                 batch_size=16, device=CPU, sharding=sh)


def test_auto_streaming_runs_batched_under_a_sharding(small_h, monkeypatch):
    """As JAX (``experiment.py:329``): a sharded run never auto-streams."""
    from ldpc_tpu_torch.harness import experiment
    monkeypatch.setattr(experiment, "run_streaming_experiment",
                        lambda *a, **k: pytest.fail("streamed"))
    dec = QPADMMDecoder(small_h, max_iter=50, device=CPU)
    cw = _codewords(small_h, 32, 2)
    sharded = run_experiment(dec, small_h, cw, 1.0, 2, batch_size=8,
                             device=CPU,
                             sharding=make_trial_mesh(device="cpu"))
    batched = run_experiment(dec, small_h, cw, 1.0, 2, batch_size=8,
                             device=CPU, streaming=False)
    assert _counts(sharded) == _counts(batched)


@pytest.mark.gpu
def test_torchrun_worlds_on_the_card(tmp_path):
    """``scaling_bench`` through ``torchrun`` at a small size: a world of 1
    over NCCL and a world of 2 on the one card over gloo, counters equal to
    the unsharded run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args = ["--trials", "16384", "--batch-per-device", "2048"]

    def world(n, *extra):
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             f"--nproc-per-node={n}", "-m",
             "ldpc_tpu_torch.apps.scaling_bench", *args, *extra],
            cwd=ROOT, capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-4000:]
        return json.loads(proc.stdout.strip().splitlines()[-1])

    one = world(1)
    assert one["backend"] == "nccl" and one["layout"] == "kernel"
    assert one["bp_decode_launches"][0] > 0
    two = world(2, "--backend", "gloo")
    assert two["backend"] == "gloo" and min(two["bp_decode_launches"]) > 0
    assert two["counters_ndev"] == two["counters_1dev"] == one[
        "counters_1dev"]
