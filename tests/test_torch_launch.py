"""The one launcher of the port's kernel wrappers (``ops/_launch.py``) on the
CPU: every wrapper module declares its launch counters, under the names
the benchmark and the tests read; a CUDA graph's record of what a capture
launched (``snapshot``, ``since``, ``restore``) and its replay
(``ipm_graph.replay``) add each declared counter's captured delta, driven
with fake launches; the device rule of every wrapper with a twin refuses
a ``meta`` tensor; the argument check raises ``TypeError`` for a dtype and
``ValueError`` for the rest, naming the function and the argument; and a
CUDA error code becomes ``RuntimeError`` with the library's message. This
file does not import JAX, and needs no card.
"""
import importlib
from collections import Counter

import pytest
import torch

from ldpc_tpu_torch.ops import _build, _launch, ipm_graph
from ldpc_tpu_torch.ops.admm_kernel import admm_iterate
from ldpc_tpu_torch.ops.chol_kernel import (chol_diag_inv, chol_factor,
                                            chol_solve)
from ldpc_tpu_torch.ops.gauss_kernel import gf2_eliminate
from ldpc_tpu_torch.ops.gemv_kernel import (batched_gemv, batched_gemv_t,
                                            normal_build)
from ldpc_tpu_torch.ops.ipm_kernel import (ipm_correct, ipm_predict, ipm_prep,
                                           newton_rhs)
from ldpc_tpu_torch.ops.ipm_ref import Terms
from ldpc_tpu_torch.ops.pdhg_kernel import pdhg_chunk

# each wrapper module's launch counters: int name -> the Counter that
# splits it (or None)
DECLARED = {
    "admm_kernel": {"ITERATE_LAUNCHES": None},
    "bp_kernel": {"LAUNCHES": None},
    "channel_kernel": {"LAUNCHES": None},
    "chol_kernel": {"LAUNCHES": None,
                    "FACTOR_LAUNCHES": "FACTOR_SHAPE_LAUNCHES",
                    "SOLVE_LAUNCHES": None},
    "gauss_kernel": {"LAUNCHES": None},
    "gemv_kernel": {"GEMV_LAUNCHES": "GEMV_TIER_LAUNCHES",
                    "GEMV_T_LAUNCHES": "GEMV_T_TIER_LAUNCHES",
                    "NORMAL_LAUNCHES": "NORMAL_TIER_LAUNCHES"},
    "ipm_kernel": {"PREP_LAUNCHES": None, "PREDICT_LAUNCHES": None,
                   "CORRECT_LAUNCHES": None},
    "pdhg_kernel": {"LAUNCHES": "TIER_LAUNCHES"},
}


class _NoGraph:
    def replay(self):
        pass


@pytest.mark.parametrize("name", sorted(DECLARED))
def test_every_launch_counter_is_declared_and_replayed(name):
    mod = importlib.import_module(f"ldpc_tpu_torch.ops.{name}")
    declared = [c for c in _launch.COUNTERS if c.module == mod.__name__]
    assert {c.name: c.by for c in declared} == DECLARED[name]
    assert len(declared) == len(DECLARED[name])
    counters = {k for k, v in vars(mod).items() if k.endswith("LAUNCHES")
                and isinstance(v, (int, Counter))}
    assert counters == {*DECLARED[name], *filter(None,
                                                  DECLARED[name].values())}
    snap = _launch.snapshot()
    tallies = (ipm_graph.REPLAYS, ipm_graph.CALLS, ipm_graph.NODES)
    try:
        # what a capture records: the launches made since the snapshot
        for k, count in enumerate(declared):
            for _ in range(k + 2):
                count(128 + k)
        delta = _launch.since(snap)
        assert [(c, n) for c, n, _ in delta] == [
            (c, k + 2) for k, c in enumerate(declared)]
        for k, (c, n, by) in enumerate(delta):
            assert by == (None if c.by is None else Counter({128 + k: n}))
        _launch.restore(snap)
        assert _launch.since(snap) == []
        # a replay adds it, twice for two replays
        part = ipm_graph.Captured(_NoGraph(), delta,
                                  sum(n for _, n, _ in delta), 0, [])
        ipm_graph.replay(part)
        ipm_graph.replay(part)
        assert _launch.since(snap) == [
            (c, 2 * n, None if by is None else by + by)
            for c, n, by in delta]
        assert ipm_graph.CALLS - tallies[1] == 2 * part.calls
    finally:
        _launch.restore(snap)
        ipm_graph.REPLAYS, ipm_graph.CALLS, ipm_graph.NODES = tallies


def _meta(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype, device="meta")


def _meta_state():
    """An IPM iterate (x, w, s, y, zl, zu, ax) of 2 lanes, T = 4, n = 6."""
    return tuple(_meta(2, 4 if i in (2, 3, 6) else 6) for i in range(7))


def _meta_terms():
    return Terms(*(_meta(2) if k == "mu" else
                   _meta(2, 4 if k in ("rp", "dy_s", "ry", "v") else 6)
                   for k in Terms._fields))


# every wrapper that runs its twin on a CPU tensor, called on meta tensors
I8, U8 = torch.int8, torch.uint8
TWIN_WRAPPERS = {
    "batched_gemv": lambda: batched_gemv(_meta(2, 4, 16, dtype=I8),
                                         _meta(2, 16)),
    "batched_gemv_t": lambda: batched_gemv_t(_meta(2, 4, 16, dtype=I8),
                                             _meta(2, 4), 16),
    "normal_build": lambda: normal_build(_meta(2, 4, 16, dtype=I8),
                                         _meta(2, 4), _meta(2, 16), 1e-6, 16),
    "chol_diag_inv": lambda: chol_diag_inv(_meta(2, 8, 8)),
    "chol_factor": lambda: chol_factor(_meta(2, 8, 8)),
    "chol_solve": lambda: chol_solve(_meta(2, 64, 64), _meta(1, 2, 64, 64),
                                     _meta(2, 8), 8),
    "gf2_eliminate": lambda: gf2_eliminate(_meta(2, 3, 6, dtype=U8),
                                           _meta(2, dtype=torch.bool)),
    "pdhg_chunk": lambda: pdhg_chunk(_meta(2, 6), _meta(2, 4, 6),
                                     _meta(2, 4), _meta(2, 6), _meta(2, 4),
                                     _meta(2, 6), _meta(2, 4), 8),
    "newton_rhs": lambda: newton_rhs(_meta(2, 4, 16, dtype=I8), _meta(2, 4),
                                     _meta(2, 16), _meta(2, 16), _meta(2, 16),
                                     16),
    "ipm_prep": lambda: ipm_prep(_meta_state(), _meta(2, 6), _meta(2, 6),
                                 _meta(2, 4), _meta()),
    "ipm_predict": lambda: ipm_predict(_meta_state(), _meta_terms(),
                                       _meta(2, 6), _meta(2, 4), _meta()),
    "ipm_correct": lambda: ipm_correct(_meta_state(), _meta_terms(),
                                       _meta(2, 6), _meta(2, 4)),
    "admm_iterate": lambda: admm_iterate(
        _meta(2, 6), _meta(2, 6), _meta(2, 3), _meta(2, 3),
        _meta(2, 1, dtype=torch.bool), _meta(2, 1, dtype=torch.int32), {},
        1.0, 0.5, 1e-5, 100, 10),
}


@pytest.mark.parametrize("fn", sorted(TWIN_WRAPPERS))
def test_the_device_rule_refuses_a_meta_tensor(fn):
    snap = _launch.snapshot()
    with pytest.raises(ValueError, match=f"{fn}: no implementation for meta"):
        TWIN_WRAPPERS[fn]()
    assert _launch.since(snap) == []


def test_the_device_rule_sends_a_cpu_tensor_to_the_twin():
    assert _launch.on_cpu("f", torch.zeros(1)) is True
    with pytest.raises(ValueError, match="f: x must be a CUDA tensor, got"):
        _launch.cuda_only("f", (("y", None), ("x", torch.zeros(1))))


CPU = torch.device("cpu")


@pytest.mark.parametrize("case,error,words", [
    ("device", ValueError, "f: x is on meta, not cpu"),
    ("dtype", TypeError, "f: x must be torch.float32, got torch.float64"),
    ("shape", ValueError, r"f: x must have shape \(2, 3\), got \(3, 2\)"),
    ("strided", ValueError, "f: x must be contiguous"),
])
def test_the_argument_check_names_function_and_argument(case, error, words):
    x = {"device": _meta(2, 3), "dtype": torch.zeros(2, 3).double(),
         "shape": torch.zeros(3, 2), "strided": torch.zeros(3, 2).t()}[case]
    with pytest.raises(error, match=words):
        _launch.expect("f", "x", x, torch.float32, (2, 3), CPU)
    _launch.expect("f", "x", torch.zeros(3, 2).t(), torch.float32, (2, 3),
                   CPU, contiguous=False)


def test_a_cuda_error_raises_with_the_librarys_message(monkeypatch):
    class _Lib:
        @staticmethod
        def ldpc_cuda_error_string(code):
            return f"error string {code}".encode()

    monkeypatch.setattr(_build, "_lib", _Lib())
    _launch.raise_for(0, "f launch")
    with pytest.raises(RuntimeError, match=r"^f launch failed: CUDA error 700 "
                       r"\(error string 700\)$"):
        _launch.raise_for(700, "f launch")
