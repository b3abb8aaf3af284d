"""The port's matrix optimizer (``ldpc_tpu_torch/apps/optimize_h.py``) and
its population QP-ADMM decode against the JAX package.

* ``_caps_for`` equals JAX's; the population decode equals
  ``jax.vmap(decode_qp_admm)`` over JAX's stacked tables and P single
  port decodes exactly, in bits, success and iterations (integers; the
  slot sums run in JAX's order), and a candidate that fails the
  precondition fails alone.
* The evaluator scores a singular candidate 1.0, maps the best slot back
  through the live set, and gives each candidate the FER that a
  ``QPADMMDecoder`` gives on the same codewords and LLRs.
* ``optimize`` in both packages, each with one deterministic fake
  evaluator put in place by the test, gives identical log lines (the
  seconds of a generation masked), saved matrix and state JSON; either
  package resumes the other's state, and the JAX-written
  ``data/optimize_state.json`` resumes in the port.
* The JAX package's three optimizer tests (``tests/test_apps.py``), on the
  CPU; ``OptimizeConfig`` has JAX's fields, defaults (but the two output
  paths) and flags.

The card is checked against the CPU in a ``gpu`` case
(``python -m pytest tests/test_torch_optimize.py -m gpu --noconftest``).
"""
import argparse
import dataclasses
import hashlib
import json
import os
import re
import shutil

import numpy as np
import pytest
import torch

from ldpc_tpu_torch import config as tconfig
from ldpc_tpu_torch.apps import optimize_h
from ldpc_tpu_torch.channel.awgn import (gen_random_codewords, llr_variance,
                                         noise_scales, transmit)
from ldpc_tpu_torch.codes.gf2 import gf2_nullspace
from ldpc_tpu_torch.codes.io import read_pcm
from ldpc_tpu_torch.codes.qc import QCMatrix
from ldpc_tpu_torch.config import OptimizeConfig
from ldpc_tpu_torch.decoders.admm import (ADMMStructure, QPADMMDecoder,
                                          decode_qp_admm,
                                          decode_qp_admm_population)
from ldpc_tpu_torch.parallel.mesh import TrialSharding

try:  # the card's host has no JAX; only the gpu case runs there
    import jax
    import jax.numpy as jnp
    from ldpc_tpu import config as jconfig
    from ldpc_tpu.apps import optimize_h as joptimize_h
    from ldpc_tpu.decoders import admm as jadmm
except ImportError:
    jax = None

DATA = os.path.join(os.path.dirname(__file__), "..", "data")
CPU = torch.device("cpu")
TABLES = optimize_h.TABLES
ALPHA, MU, ITERS = 1.95, 0.5, 200


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small tensors: one intra-op thread, so parallel test workers do not
    oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _opt_qc():
    return QCMatrix.from_dense(read_pcm(os.path.join(DATA, "optimalH.txt")),
                               20)


def _mutations(count, seed=11):
    """``count`` non-singular one-block mutations of optimalH."""
    rng = np.random.default_rng(seed)
    base, out = _opt_qc(), []
    while len(out) < count:
        h = base.random_mutation(rng).to_dense()
        if gf2_nullspace(h)[1]:
            out.append(h)
    return out


def _infeasible(h):
    """``h`` with variable 0 in one degree-1 check only: e_min 1, so
    e_min * mu > alpha fails at (1.95, 0.5)."""
    h = h.copy()
    h[:, 0] = 0
    h[0] = 0
    h[0, 0] = 1
    return h


def _population_llrs(hs, lanes, snr, seed):
    """(P, lanes, n) float32 LLRs of codewords of each candidate, made with
    numpy from a seed (a candidate without a generator sends zeros)."""
    rng = np.random.default_rng(seed)
    var = llr_variance(snr)
    out = []
    for h in hs:
        g, ok = gf2_nullspace(h)
        cw = ((rng.integers(0, 2, (lanes, g.shape[0])) @ g) % 2 if ok
              else np.zeros((lanes, h.shape[1]), np.int64))
        y = 1.0 - 2.0 * cw + np.sqrt(var) * rng.standard_normal(cw.shape)
        out.append(2.0 * y / var)
    return np.stack(out).astype(np.float32)


def _stacked(hs, caps, to):
    structs = [ADMMStructure.from_h(h, **caps) for h in hs]
    return {k: to(np.stack([getattr(s, k) for s in structs]))
            for k in TABLES}


_JAX_FNS = {}


def _jax_population(tables, n, llrs, max_iter):
    """``jax.vmap(decode_qp_admm)`` over stacked tables, as the JAX
    optimizer runs it (``apps/optimize_h.py:90-99``)."""
    key = (n, max_iter)
    if key not in _JAX_FNS:
        _JAX_FNS[key] = jax.jit(jax.vmap(
            lambda t, l: jadmm.decode_qp_admm(t, n, l, ALPHA, MU, max_iter,
                                              1e-5)))
    return _JAX_FNS[key](tables, llrs)


def _same(got, want, what):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                  err_msg=what)


def test_caps_equal_jax():
    rng = np.random.default_rng(3)
    cands = _mutations(4) + [QCMatrix.random(rng, 20, 8, 14).to_dense(),
                             _infeasible(_mutations(1)[0])]
    for k in range(1, len(cands) + 1):
        assert optimize_h._caps_for(cands[:k]) == \
            joptimize_h._caps_for(cands[:k])
    assert optimize_h._bucket(700, 256) == 768


@pytest.mark.parametrize("snr", [-3.0, 1.0])
def test_population_decode_equals_jax_vmap_and_single_decodes(snr):
    """3 mutations of optimalH, 8 lanes each, 200 iterations."""
    hs = _mutations(3)
    caps = optimize_h._caps_for(hs)
    llrs = _population_llrs(hs, 8, snr, seed=21)
    n = hs[0].shape[1]
    got = decode_qp_admm_population(
        _stacked(hs, caps, torch.from_numpy), n, torch.from_numpy(llrs),
        ALPHA, MU, ITERS, 1e-5)
    assert got.bits.shape == (3, 8, n) and got.success.shape == (3, 8)
    want = _jax_population(_stacked(hs, caps, jnp.asarray), n,
                           jnp.asarray(llrs), ITERS)
    _same(got.bits, want.bits, "bits")
    _same(got.success, want.success, "success")
    _same(got.iterations, want.iterations, "iterations")
    for p, h in enumerate(hs):
        s = ADMMStructure.from_h(h, **caps)
        one = decode_qp_admm({k: torch.from_numpy(getattr(s, k))
                              for k in TABLES}, n,
                             torch.from_numpy(llrs[p]), ALPHA, MU, ITERS,
                             1e-5)
        assert torch.equal(one.bits, got.bits[p]), p
        assert torch.equal(one.success, got.success[p]), p
        assert torch.equal(one.iterations, got.iterations[p]), p
    assert bool(got.success.all())     # every candidate meets the bound


def test_precondition_fails_per_candidate():
    """A candidate with e_min * mu <= alpha gets zero bits and no success
    on its own lanes only (min(e) is each candidate's, not the stack's)."""
    a, b = _mutations(2)
    bad = _infeasible(a)
    hs = [a, bad, b]
    caps = optimize_h._caps_for(hs)
    assert ADMMStructure.from_h(bad).e_min * MU <= ALPHA
    llrs = _population_llrs(hs, 8, 1.0, seed=5)
    n = a.shape[1]
    got = decode_qp_admm_population(
        _stacked(hs, caps, torch.from_numpy), n, torch.from_numpy(llrs),
        ALPHA, MU, ITERS, 1e-5)
    assert not bool(got.success[1].any()) and not bool(got.bits[1].any())
    assert bool(got.success[0].all()) and bool(got.success[2].all())
    want = _jax_population(_stacked(hs, caps, jnp.asarray), n,
                           jnp.asarray(llrs), ITERS)
    _same(got.bits, want.bits, "bits")
    _same(got.success, want.success, "success")
    _same(got.iterations, want.iterations, "iterations")


def _tiny_cfg(**kw):
    base = dict(block_size=4, block_rows=2, block_cols=4, trials=24,
                final_trials=24, snr=2.0, admm_max_iter=60, population=3,
                seed=1)
    base.update(kw)
    return OptimizeConfig(**base)


def _tiny_candidates():
    rng = np.random.default_rng(9)
    good = [QCMatrix.random(rng, 4, 2, 4).to_dense() for _ in range(2)]
    singular = good[0].copy()
    singular[4:] = 0                         # zero rows: no generator
    assert not gf2_nullspace(singular)[1]
    return good[0], singular, good[1]


def test_evaluator_scores_like_a_single_decoder():
    """A singular candidate scores 1.0; each live candidate's FER equals a
    QPADMMDecoder's on the same codewords (from ``seed``) and LLRs (noise
    from ``seed + 1``); the best slot maps back through the live set,
    including a pad slot's win."""
    cfg = _tiny_cfg()
    a, singular, b = _tiny_candidates()
    ev = optimize_h.PopulationEvaluator(cfg, a.shape[1], device=CPU)
    fers = ev.evaluate([a, singular, b], 5, cfg.trials, trial_batch=10)
    assert fers[1] == 1.0
    idx = torch.arange(cfg.trials)
    for i, h in ((0, a), (2, b)):
        cw = gen_random_codewords(gf2_nullspace(h)[0], cfg.trials,
                                  torch.Generator().manual_seed(5), CPU)
        llr = noise_scales(cfg.snr)[1] * transmit(cw, cfg.snr, 6, idx)
        res = QPADMMDecoder(h, alpha=cfg.admm_alpha, mu=cfg.admm_mu,
                            max_iter=cfg.admm_max_iter,
                            device=CPU).decode_batch(llr)
        correct = int((res.success & (res.bits == cw).all(-1)).sum())
        assert fers[i] == 1.0 - correct / cfg.trials, i
    assert ev.last_best == (0 if fers[0] <= fers[2] else 2)
    assert all(t.total > 0 for t in ev.host_s.values())
    # the accept runs over the candidates with the singular one masked: a
    # win of the last index is the last live candidate (JAX pads the live
    # set [0, 2] to slots [0, 2, 2] and maps a pad slot's win back to it)
    ev._argbest = lambda c: (torch.tensor(len(c) - 1), c.max())
    ev.evaluate([a, singular, b], 5, cfg.trials)
    assert ev.last_best == 2
    assert (ev.evaluate([singular], 5, cfg.trials) == 1.0).all()


class _FakeEvaluator:
    """A deterministic stand-in for both packages' evaluators: FER from a
    hash of the matrix bytes, the trial count and the iteration cap."""

    def __init__(self, cfg, n, *args, **kwargs):
        self.cfg = cfg

    def evaluate(self, candidates, key, trials, trial_batch=512,
                 max_iter=None):
        out = []
        for h in candidates:
            tag = f"{trials},{max_iter}".encode()
            digest = hashlib.sha256(
                np.ascontiguousarray(h, np.uint8).tobytes() + tag).digest()
            out.append(int.from_bytes(digest[:4], "little")
                       % (trials + 1) / trials)
        self.last_best = int(np.argmin(out))
        return np.array(out)


def _run(mod, cfg, monkeypatch):
    """``mod.optimize(cfg)`` with the fake evaluator; returns the log lines
    (the seconds of a generation masked), the saved matrix and the state."""
    monkeypatch.setattr(mod, "PopulationEvaluator", _FakeEvaluator)
    lines = []

    def log(*args, **kwargs):
        lines.append(re.sub(r"\(\d+\.\d+s,", "(<s>,",
                            " ".join(str(a) for a in args)))

    kw = {"device": CPU} if mod is optimize_h else {}
    qc, final = mod.optimize(cfg, log=log, **kw)
    with open(cfg.save_path) as f:
        saved = f.read()
    with open(cfg.state_path) as f:
        state = json.load(f, parse_constant=_refuse)
    return lines, saved, state, (qc.present.tolist(), qc.shifts.tolist(),
                                 final)


def _refuse(token):
    raise ValueError(f"non-standard JSON token {token}")


def _fake_cfg(tmp_path, tag, generations, **kw):
    return dataclasses.replace(
        _tiny_cfg(population=4, kick_after=3, reseed_after=6,
                  generations=generations, trials=32, screen_trials=16),
        save_path=str(tmp_path / f"{tag}_best.txt"),
        state_path=str(tmp_path / f"{tag}_state.json"), **kw)


def test_optimize_equals_jax_with_one_fake_evaluator(tmp_path, monkeypatch):
    """~64 proposals, population 4, kicks after 3 rejections and reseeds
    after 6: identical logs, saved matrix, state and result."""
    got = _run(optimize_h, _fake_cfg(tmp_path, "torch", 64), monkeypatch)
    want = _run(joptimize_h, _fake_cfg(tmp_path, "jax", 64), monkeypatch)
    assert got[0] == want[0]
    assert got[1:] == want[1:]
    # a chain reseeds at 6 rejections, after kicked proposals at 3, 4, 5
    text = "\n".join(got[0])
    assert "reseeded (best+kick)" in text and "reseeded (random)" in text
    assert got[2]["generation"] == 64
    assert any(c["fer"] is None for c in got[2]["chains"])


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_either_package_resumes_the_others_state(writer, reader, tmp_path,
                                                 monkeypatch):
    """The writer runs 32 proposals; the reader resumes its state to 64,
    and gives what the writer gives resuming its own state."""
    mods = {"torch": optimize_h, "jax": joptimize_h}
    for tag in ("cross", "own"):
        _run(mods[writer], _fake_cfg(tmp_path, tag, 32), monkeypatch)
    cross = _run(mods[reader], _fake_cfg(tmp_path, "cross", 64),
                 monkeypatch)
    own = _run(mods[writer], _fake_cfg(tmp_path, "own", 64), monkeypatch)
    assert cross[0] == [line.replace("own_state", "cross_state")
                        for line in own[0]]
    assert cross[0][0].startswith("resumed from ")
    assert cross[1:] == own[1:]


def test_committed_jax_state_resumes_in_the_port(tmp_path):
    """``data/optimize_state.json`` (8 chains of 8 x 14 blocks of 20,
    generation 26,208, best FER 0.362, written by the JAX package) resumes
    for one round of 8 proposals (screens of 16 trials, 50 iterations)."""
    state = str(tmp_path / "state.json")
    shutil.copy(os.path.join(DATA, "optimize_state.json"), state)
    with open(state) as f:
        before = json.load(f)
    cfg = OptimizeConfig(trials=16, final_trials=16, screen_trials=16,
                         screen_iters=50, admm_max_iter=50,
                         generations=before["generation"] + 8,
                         save_path=str(tmp_path / "best.txt"),
                         state_path=state)
    lines = []
    qc, final = optimize_h.optimize(
        cfg, log=lambda *a, **k: lines.append(" ".join(map(str, a))),
        device=CPU)
    assert lines[0] == (f"resumed from {state} @ generation 26208, "
                        f"best FER=inf (8 chains)")
    with open(state) as f:
        after = json.load(f, parse_constant=_refuse)
    assert after["generation"] == 26216 and len(after["chains"]) == 8
    assert after["initial"] == before["initial"]
    assert after["fer"] <= before["fer"]
    if after["fer"] == before["fer"]:            # the persisted best kept
        assert after["present"] == before["present"]
        assert after["shifts"] == before["shifts"]
    assert 0.0 <= final <= 1.0 and qc.to_dense().shape == (160, 280)
    np.testing.assert_array_equal(read_pcm(cfg.save_path), qc.to_dense())


# the JAX package's optimizer tests (tests/test_apps.py), on the CPU

def test_optimizer_smoke(tmp_path):
    cfg = OptimizeConfig(block_size=4, block_rows=2, block_cols=4,
                         trials=48, final_trials=48, snr=2.0,
                         admm_max_iter=100, generations=4, population=2,
                         seed=1,
                         save_path=str(tmp_path / "best.txt"),
                         state_path=str(tmp_path / "state.json"))
    qc, final = optimize_h.optimize(cfg, log=lambda *a, **k: None,
                                    device=CPU)
    assert 0.0 <= final <= 1.0
    assert qc.to_dense().shape == (8, 16)


def test_optimizer_resume(tmp_path):
    kw = dict(block_size=4, block_rows=2, block_cols=4, trials=32,
              final_trials=32, snr=2.0, admm_max_iter=50, population=2,
              seed=2, save_path=str(tmp_path / "best.txt"),
              state_path=str(tmp_path / "state.json"))
    optimize_h.optimize(OptimizeConfig(generations=2, **kw),
                        log=lambda *a, **k: None, device=CPU)
    assert os.path.exists(kw["state_path"])
    optimize_h.optimize(OptimizeConfig(generations=4, **kw),
                        log=lambda *a, **k: None, device=CPU)
    with open(kw["state_path"]) as f:
        assert json.load(f)["generation"] == 4


def test_optimizer_resume_keeps_persisted_best(tmp_path):
    """A resumed run whose chains all carry fer=inf must seed the global
    best from the persisted top-level record, not recompute a worse one and
    overwrite the saved matrix."""
    kw = dict(block_size=4, block_rows=2, block_cols=4, trials=32,
              final_trials=32, snr=2.0, admm_max_iter=50, population=2,
              seed=3, save_path=str(tmp_path / "best.txt"),
              state_path=str(tmp_path / "state.json"))
    optimize_h.optimize(OptimizeConfig(generations=2, **kw),
                        log=lambda *a, **k: None, device=CPU)
    with open(kw["state_path"]) as f:
        st = json.load(f)
    st["fer"] = 0.0          # an unbeatable persisted best, all-inf chains
    for ch in st["chains"]:
        ch["fer"] = None
    with open(kw["state_path"], "w") as f:
        json.dump(st, f)
    optimize_h.optimize(OptimizeConfig(generations=4, **kw),
                        log=lambda *a, **k: None, device=CPU)
    with open(kw["state_path"]) as f:
        st2 = json.load(f, parse_constant=_refuse)   # strict JSON
    assert st2["fer"] == 0.0
    assert st2["present"] == st["present"]
    assert st2["shifts"] == st["shifts"]


def _flags(cfg):
    p = argparse.ArgumentParser()
    (tconfig if isinstance(cfg, OptimizeConfig) else jconfig
     ).add_dataclass_args(p, cfg)
    return {a.dest: (a.option_strings, a.default, a.type)
            for a in p._actions if a.dest != "help"}


def test_optimize_config_matches_jax():
    got, want = OptimizeConfig(), jconfig.OptimizeConfig()
    names = [f.name for f in dataclasses.fields(got)]
    assert names == [f.name for f in dataclasses.fields(want)]
    paths = {"save_path": "data/optimalH_torch.txt",
             "state_path": "data/optimize_state_torch.json"}
    for name in names:
        assert getattr(got, name) == paths.get(name, getattr(want, name)), \
            name
    assert getattr(want, "save_path") == "data/optimalH_tpu.txt"
    assert getattr(want, "state_path") == "data/optimize_state.json"
    g, w = _flags(got), _flags(want)
    assert g.keys() == w.keys()
    for dest in g:
        assert g[dest][0] == w[dest][0], dest
        assert g[dest][1] == paths.get(dest, w[dest][1]), dest
    assert "OptimizeConfig" in tconfig.__all__


def test_main_parses_the_flags(tmp_path, monkeypatch):
    seen = {}
    monkeypatch.setattr(optimize_h, "optimize",
                        lambda cfg, device: seen.update(cfg=cfg, dev=device))
    optimize_h.main(["--block-size", "4", "--population", "3",
                     "--snr=-2.5", "--state-path", str(tmp_path / "s.json"),
                     "--device", "cpu"])
    assert seen["dev"] == "cpu" and seen["cfg"].block_size == 4
    assert seen["cfg"].population == 3 and seen["cfg"].snr == -2.5
    optimize_h.main([])
    assert seen["dev"] == "cuda"


def test_entry_points_default_to_the_card(tmp_path, monkeypatch):
    """``optimize`` and the evaluator run on the card unless asked for the
    CPU, and do not carry on elsewhere without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _tiny_cfg(save_path=str(tmp_path / "b.txt"),
                    state_path=str(tmp_path / "s.json"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        optimize_h.optimize(cfg, log=lambda *a, **k: None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        optimize_h.PopulationEvaluator(cfg, 16)
    assert not os.path.exists(cfg.state_path)


@pytest.mark.parametrize("world", [1, 3])
def test_evaluator_takes_a_sharding(world):
    """A world-1 sharding gives the unsharded FERs and best candidate; so
    does a population the world does not divide (3 candidates over 3 ranks
    would split; 2 do not), which runs whole on every rank with no
    collective."""
    cfg = _tiny_cfg()
    a, singular, b = _tiny_candidates()
    plain = optimize_h.PopulationEvaluator(cfg, a.shape[1], device=CPU)
    want = plain.evaluate([a, b], 5, cfg.trials, trial_batch=10)
    sh = TrialSharding(0, world, CPU)
    ev = optimize_h.PopulationEvaluator(cfg, a.shape[1], device=CPU,
                                        sharding=sh)
    assert ev._share(2) == ((0, 2), world == 1)
    assert np.array_equal(ev.evaluate([a, b], 5, cfg.trials, trial_batch=10),
                          want)
    assert ev.last_best == plain.last_best
    assert ev._share(3) == ((0, 1 if world == 3 else 3), True)


@pytest.mark.gpu
def test_population_decode_card_equals_cpu():
    """3 mutations of optimalH and a candidate failing the precondition,
    32 lanes each at -3 dB, 200 iterations: bits, success and iterations
    on the card equal the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    hs = _mutations(3)
    hs.append(_infeasible(hs[0]))
    caps = optimize_h._caps_for(hs)
    llrs = torch.from_numpy(_population_llrs(hs, 32, -3.0, seed=8))
    n = hs[0].shape[1]
    tables = _stacked(hs, caps, torch.from_numpy)
    cpu = decode_qp_admm_population(tables, n, llrs, ALPHA, MU, ITERS, 1e-5)
    card = decode_qp_admm_population({k: t.to(dev) for k, t in
                                      tables.items()}, n, llrs.to(dev),
                                     ALPHA, MU, ITERS, 1e-5)
    for key in ("bits", "success", "iterations"):
        assert torch.equal(getattr(card, key).cpu(), getattr(cpu, key)), key
