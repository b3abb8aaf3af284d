"""The port's native host core (``ldpc_tpu_torch/_native``) against its
NumPy bodies and the JAX package, on the CPU.

* The library builds from the port's own ``ldpc_host.cpp`` into
  ``build/ldpc_tpu_torch/``; a broken source raises with g++'s message; a
  source newer than the library rebuilds it; four processes building at
  once leave one loadable library.
* ``gf2_nullspace`` (the core when n > m) equals ``_nullspace_numpy`` and
  JAX's ``gf2_nullspace`` in G and ok on the committed matrices and on
  seeded random ones (singular, n == m and n < m among them); the core's
  ``rank`` and ``gf2_matmul`` equal the NumPy ``gf2_rank`` and
  ``gf2_matmul``.
* ``ADMMStructure.from_h`` (the core when the caps cover the cascade)
  equals ``_from_h_numpy`` and JAX's ``from_h`` in every table, with no
  caps and at the optimizer's ``_caps_for`` caps over QC mutations drawn
  as ``optimize_h`` draws them; caps below the cascade raise.
* ``LDPC_TPU_NO_NATIVE`` selects the NumPy bodies; the package imports
  neither JAX nor the JAX package.
"""
import ast
import ctypes
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from ldpc_tpu_torch import _native
from ldpc_tpu_torch.apps import optimize_h
from ldpc_tpu_torch.codes import gf2
from ldpc_tpu_torch.codes.io import read_pcm
from ldpc_tpu_torch.codes.qc import QCMatrix
from ldpc_tpu_torch.config import OptimizeConfig
from ldpc_tpu_torch.decoders import admm
from ldpc_tpu_torch.decoders.admm import (TABLES, ADMMStructure,
                                          _structure_caps)

from ldpc_tpu.codes import gf2 as jgf2
from ldpc_tpu.decoders import admm as jadmm

ROOT = Path(__file__).resolve().parents[1]
DATA = ROOT / "data"
MATRICES = ("H", "optimalH", "H02", "H05")
TINY = np.array([[1, 1, 0, 1, 1, 0, 0],
                 [1, 0, 1, 1, 0, 1, 0],
                 [0, 1, 1, 1, 0, 0, 1]], dtype=np.uint8)
# (m, n, density, seed): words of 64 columns crossed, sparse rows that
# vanish, and the square and tall shapes that go to NumPy
RANDOM = [(9, 15, 0.5, 0), (12, 40, 0.3, 1), (30, 64, 0.08, 2),
          (64, 130, 0.05, 3), (40, 200, 0.1, 4), (20, 20, 0.5, 5),
          (25, 18, 0.5, 6), (5, 9, 0.0, 7)]
MUTATION_SEEDS = (0, 1)
MUTATIONS = 16          # two generations of the optimizer's 8 chains
SINGULAR_DRAW = (0, 200)  # (seed, count): two of the 200 are singular


@pytest.fixture(autouse=True)
def _native_on(monkeypatch):
    monkeypatch.delenv("LDPC_TPU_NO_NATIVE", raising=False)


def _matrix(name):
    return TINY if name == "tiny" else read_pcm(str(DATA / f"{name}.txt"))


def _random(m, n, density, seed):
    rng = np.random.default_rng(seed)
    return (rng.random((m, n)) < density).astype(np.uint8)


def _duplicate_row():
    h = _random(10, 30, 0.4, 8)
    h[7] = h[2]
    return h


def _mutations(seed, count=MUTATIONS):
    """QC mutations of the chain incumbents of ``data/optimize_state.json``,
    one per chain per generation, drawn as ``optimize_h`` draws them."""
    with open(DATA / "optimize_state.json") as f:
        st = json.load(f)
    qcs = [QCMatrix(OptimizeConfig().block_size,
                    np.array(c["present"], bool),
                    np.array(c["shifts"], np.int64)) for c in st["chains"]]
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < count:
        out += [qc.random_mutation(rng).to_dense() for qc in qcs]
    return out[:count]


def _same_nullspace(h):
    got = gf2.gf2_nullspace(h)
    for want in (gf2._nullspace_numpy(h), jgf2.gf2_nullspace(h)):
        assert got[1] == want[1]
        if got[1]:
            assert got[0].dtype == want[0].dtype == np.uint8
            np.testing.assert_array_equal(got[0], want[0])
        else:
            assert got[0] is None and want[0] is None
    return got[1]


def _same_structure(got, want):
    assert (got.n, got.n_var, got.n_con) == (want.n, want.n_var, want.n_con)
    for key in TABLES:
        g, w = getattr(got, key), getattr(want, key)
        assert g.dtype == w.dtype and g.shape == w.shape, key
        np.testing.assert_array_equal(g, w, err_msg=key)
    assert got.e_min == want.e_min


def test_library_builds_under_build_dir():
    assert _native.load() is not None
    assert _native.SRC == ROOT / "ldpc_tpu_torch" / "_native" / "ldpc_host.cpp"
    assert _native.LIB_PATH.parent == ROOT / "build" / "ldpc_tpu_torch"
    assert _native.LIB_PATH.is_file()
    assert _native.LIB_PATH.stat().st_mtime >= _native.SRC.stat().st_mtime


@pytest.mark.parametrize("name", ("tiny",) + MATRICES)
def test_nullspace_equals_numpy_and_jax(name):
    h = _matrix(name)
    g, ok = _native.nullspace(h)
    assert ok and _same_nullspace(h)
    np.testing.assert_array_equal(g, gf2._nullspace_numpy(h)[0])
    np.testing.assert_array_equal(gf2.gf2_matmul(h, g.T), 0)


@pytest.mark.parametrize("shape", RANDOM + ["duplicate_row"], ids=str)
def test_nullspace_random_equals_numpy_and_jax(shape):
    h = _duplicate_row() if shape == "duplicate_row" else _random(*shape)
    m, n = h.shape
    ok = _same_nullspace(h)
    if n <= m:
        assert _native.nullspace(h) is None       # NumPy's path
    if shape == "duplicate_row" or shape[2] == 0.0:
        assert not ok


def test_random_cases_include_singular_and_regular():
    oks = [gf2.gf2_nullspace(_random(*s))[1] for s in RANDOM]
    assert any(oks) and not all(oks)


def test_nullspace_on_qc_mutations():
    oks = [_same_nullspace(h) for h in _mutations(*SINGULAR_DRAW)]
    assert any(oks) and not all(oks)


@pytest.mark.parametrize("shape", RANDOM[:5], ids=str)
def test_rank_and_matmul_equal_numpy(shape):
    m, n, density, seed = shape
    h = _random(m, n, density, seed)
    assert _native.rank(h) == gf2.gf2_rank(h) == jgf2.gf2_rank(h)
    b = _random(n, m + 3, 0.5, seed + 100)
    np.testing.assert_array_equal(_native.gf2_matmul(h, b),
                                  gf2.gf2_matmul(h, b))


@pytest.mark.parametrize("name", ("tiny",) + MATRICES)
def test_from_h_equals_numpy_and_jax(name):
    h = _matrix(name)
    got = ADMMStructure.from_h(h)
    _same_structure(got, admm._from_h_numpy(h))
    _same_structure(got, jadmm.ADMMStructure.from_h(h))
    assert (got.n_var, got.n_con, got.var_con.shape[1]) == \
        _structure_caps(h)


@pytest.mark.parametrize("seed", MUTATION_SEEDS)
def test_from_h_at_optimizer_caps_equals_numpy_and_jax(seed):
    hs = _mutations(seed)
    caps = optimize_h._caps_for(hs)
    assert caps["n_var_cap"] > max(_structure_caps(h)[0] for h in hs)
    for h in hs:
        got = ADMMStructure.from_h(h, **caps)
        _same_structure(got, admm._from_h_numpy(h, **caps))
        _same_structure(got, jadmm.ADMMStructure.from_h(h, **caps))
        # capacity padding: slots past the cascade point at the caps
        nv, nc, _ = _structure_caps(h)
        assert (got.con_var[nc:] == caps["n_var_cap"]).all()
        assert (got.var_con[nv:] == caps["n_con_cap"]).all()
        assert (got.e[nv:] == 0).all() and (got.b[nc:] == 0).all()


@pytest.mark.parametrize("which", range(3))
def test_caps_below_cascade_raise(which):
    h = _matrix("H")
    caps = list(_structure_caps(h))
    caps[which] -= 1
    kw = dict(zip(("n_var_cap", "n_con_cap", "k_max_cap"), caps))
    with pytest.raises(ValueError, match="below the cascade"):
        ADMMStructure.from_h(h, **kw)
    with pytest.raises(ValueError, match="below the cascade"):
        admm._from_h_numpy(h, **kw)


def test_no_native_selects_numpy(monkeypatch):
    h = _matrix("optimalH")
    calls = []

    def spy(fn):
        def wrapped(*args, **kwargs):
            calls.append(fn.__name__)
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(gf2, "_nullspace_numpy", spy(gf2._nullspace_numpy))
    monkeypatch.setattr(admm, "_from_h_numpy", spy(admm._from_h_numpy))
    g, ok = gf2.gf2_nullspace(h)
    s = ADMMStructure.from_h(h)
    assert calls == []                       # the core ran both

    monkeypatch.setenv("LDPC_TPU_NO_NATIVE", "1")
    assert _native.disabled() and _native.load() is None
    assert _native.nullspace(h) is None and _native.rank(h) is None
    assert _native.gf2_matmul(h, h.T) is None
    assert _native.admm_build(h, *_structure_caps(h)) is None
    g2, ok2 = gf2.gf2_nullspace(h)
    s2 = ADMMStructure.from_h(h)
    assert calls == ["_nullspace_numpy", "_from_h_numpy"]
    assert ok == ok2
    np.testing.assert_array_equal(g, g2)
    _same_structure(s, s2)


def test_broken_source_raises_with_gxx_message(tmp_path):
    src = tmp_path / "ldpc_host.cpp"
    src.write_text(_native.SRC.read_text() + "\nint broken( {\n")
    lib = tmp_path / "out" / "libldpc_host.so"
    with pytest.raises(RuntimeError, match=r"g\+\+ failed") as err:
        _native.build(src=src, lib=lib)
    assert "error" in str(err.value) and str(src) in str(err.value)
    assert list(lib.parent.iterdir()) == []   # no library, no leftover


def test_newer_source_rebuilds(tmp_path):
    src = tmp_path / "ldpc_host.cpp"
    shutil.copy(_native.SRC, src)
    lib = tmp_path / "libldpc_host.so"
    _native.build(src=src, lib=lib)
    first = lib.stat().st_ino
    _native.build(src=src, lib=lib)
    assert lib.stat().st_ino == first         # current: not rebuilt
    t = lib.stat().st_mtime + 10
    os.utime(src, (t, t))
    _native.build(src=src, lib=lib)
    assert lib.stat().st_ino != first


def test_four_processes_build_one_library(tmp_path):
    lib = tmp_path / "out" / "libldpc_host.so"
    code = ("import sys; from ldpc_tpu_torch import _native; "
            "_native.build(force=True, lib=sys.argv[1])")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(lib)],
                              cwd=ROOT, env=env, stderr=subprocess.PIPE,
                              text=True) for _ in range(4)]
    errs = [p.communicate(timeout=300)[1] for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, errs
    assert [p.name for p in lib.parent.iterdir()] == [lib.name]
    h = _random(12, 70, 0.3, 9)
    rank = ctypes.CDLL(str(lib)).ldpc_gf2_rank
    rank.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    assert rank(h.ctypes.data, *h.shape) == gf2.gf2_rank(h)


def test_package_imports_neither_jax_nor_ldpc_tpu():
    pkg = ROOT / "ldpc_tpu_torch" / "_native"
    names = []
    for path in pkg.glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names += [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names.append(node.module)
    assert names and not [n for n in names if n.split(".")[0] in
                          ("jax", "jaxlib", "ldpc_tpu")]
    for path in (_native.SRC, _native.LIB_PATH):
        assert ROOT / "ldpc_tpu" not in path.parents
