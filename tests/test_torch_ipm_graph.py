"""The IPM step's two hand-written kernels (``csrc/ipm_step.cu``) and the
solve as CUDA graphs (``ops/ipm_graph.py``) in the PyTorch port.

On the CPU: the kernels' twins (``ops/ipm_ref.py``) equal the JAX package's
work bit for bit on numpy inputs from a seed: the step lengths against
``ldpc_tpu.ops.ipm_solver._pos_step`` composed as at ``:222-227``, the
masked update against ``:247-267`` written out in ``jax.numpy`` (the update
lives inside JAX's solver; each op runs on its own, as the port's eager ops
do, so no product is fused into an add). Cases: NaN and inf directions,
all-positive directions (step 1), ties, steps past the box (clamps and
floors). The wrappers run the twins on a CPU tensor, the eager solve
(``graphs=False``) is the default one there, and ``graphs=True`` on a CPU
tensor raises. The refactored eager solve's tolerances against JAX stay
``tests/test_torch_ipm.py``'s.

On the card (marked ``gpu``; ``python -m pytest tests/test_torch_ipm_graph.py
-m gpu --noconftest``): the kernels equal the twins bit for bit at
T = 128, 640 and 1408, B = 128, n = 280 with the same special lanes; the
graph solve equals the eager one bit for bit in x, y and err for cold,
warm and masked solves at those tiers, twice in a row; and the launch
counters after a graph solve equal the eager solve's.
"""
from collections import Counter

import numpy as np
import pytest
import torch

from ldpc_tpu_torch.decoders.agc_alp import AGCALPDecoder
from ldpc_tpu_torch.ops import ipm_graph, ipm_kernel
from ldpc_tpu_torch.ops.gemv_kernel import pack_rows
from ldpc_tpu_torch.ops.ipm_kernel import ipm_step_len, ipm_update
from ldpc_tpu_torch.ops.ipm_ref import ipm_step_len_ref, ipm_update_ref
from ldpc_tpu_torch.ops.ipm_solver import ipm_box_lp

try:  # the card's host has no JAX; only the gpu cases run there
    import jax.numpy as jnp

    from ldpc_tpu.ops.ipm_solver import _pos_step as jpos_step
except ImportError:
    jnp = None

CASES = ("random", "nan_dx", "nan_dy", "inf", "positive", "ties", "clamp")


def _special(case, v, d, rng):
    """Make lane 1 of the (B, T) / (B, n) arrays ``v`` (values, dict) and
    ``d`` (directions, dict) the case's lane; the other lanes stay random."""
    if case == "nan_dx":
        d["dx"][1, 3] = np.nan
    elif case == "nan_dy":
        d["dy"][1, -1] = np.nan
    elif case == "inf":
        d["ds"][1, 2] = -np.inf
        d["dzl"][1, 0] = np.inf
        d["dx"][1, 1] = -np.inf
        d["dy"][1, 0] = np.inf
    elif case == "positive":           # every ratio inf: both steps 1
        for k in ("ds", "dy", "dzl", "dzu"):
            d[k][1] = np.abs(d[k][1])
        d["dx"][1] = 0.0
    elif case == "ties":               # one ratio in many places
        for k in ("s", "y"):
            v[k][1, ::3] = 0.75
        for k in ("ds", "dy"):
            d[k][1, ::3] = -1.5
        v["x"][1, ::4], d["dx"][1, ::4] = 0.25, -0.5
        v["zl"][1, ::5], d["dzl"][1, ::5] = 1.0, -2.0
    elif case == "clamp":              # steps past the box and the floors
        d["dx"][1] = rng.choice([-4.0, 4.0], d["dx"].shape[1])
        d["ds"][1] = -10.0
        d["dy"][1] = -10.0
    return v, d


def _step_inputs(seed, bsz, t, n, case):
    """Interior values and Newton directions, float32 from a seed."""
    rng = np.random.default_rng(seed)

    def pos(w):
        return rng.uniform(1e-3, 5.0, (bsz, w)).astype(np.float32)

    def dirs(w):
        return rng.normal(0.0, 2.0, (bsz, w)).astype(np.float32)

    x = rng.uniform(1e-3, 1.0 - 1e-3, (bsz, n)).astype(np.float32)
    v = {"s": pos(t), "x": x, "y": pos(t), "zl": pos(n), "zu": pos(n)}
    d = {"ds": dirs(t), "dx": dirs(n), "dy": dirs(t), "dzl": dirs(n),
         "dzu": dirs(n), "adx": dirs(t)}
    # a lane whose steps all exceed 1 / 0.995 (clamped to 1)
    for k in d:
        d[k][2] *= np.float32(1e-5)
    v, d = _special(case, v, d, rng)
    v["w"] = (np.float32(1.0) - v["x"]).astype(np.float32)
    v["ax"] = rng.normal(0.0, 3.0, (bsz, t)).astype(np.float32)
    ap = rng.uniform(0.0, 1.2, bsz).astype(np.float32)
    ad = rng.uniform(0.0, 1.2, bsz).astype(np.float32)
    return v, d, ap, ad


def _step_args(v, d):
    return (v["s"], d["ds"], v["x"], d["dx"], v["w"], v["y"], d["dy"],
            v["zl"], d["dzl"], v["zu"], d["dzu"])


def _state(v):
    return tuple(v[k] for k in ("x", "w", "s", "y", "zl", "zu", "ax"))


def _dirs(d):
    return tuple(d[k] for k in ("dx", "dy", "ds", "dzl", "dzu", "adx"))


def _t(arrays, dev="cpu"):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for a in arrays)


def _bits(v):
    """The float32 bit patterns (NaN-safe equality)."""
    v = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)
    return v.astype(np.float32).view(np.int32)


def _jax_step_len(s, ds, x, dx, w, y, dy, zl, dzl, zu, dzu):
    """``ldpc_tpu/ops/ipm_solver.py:239-243``."""
    ap = jnp.minimum(jpos_step(s, ds),
                     jnp.minimum(jpos_step(x, dx), jpos_step(w, -dx)))
    ad = jnp.minimum(jpos_step(y, dy),
                     jnp.minimum(jpos_step(zl, dzl), jpos_step(zu, dzu)))
    return ap, ad


def _jax_update(state, dirs, ap, ad):
    """``ldpc_tpu/ops/ipm_solver.py:247-267``, written out."""
    x, w, s, y, zl, zu, ax = state
    dx, dy, ds, dzl, dzu, adx = dirs
    ok = (jnp.all(jnp.isfinite(dx), axis=-1)
          & jnp.all(jnp.isfinite(dy), axis=-1))[:, None]
    ax = jnp.where(ok, ax + ap[:, None] * adx, ax)
    x = jnp.where(ok, x + ap[:, None] * dx, x)
    w = 1.0 - x
    s = jnp.where(ok, s + ap[:, None] * ds, s)
    y = jnp.where(ok, y + ad[:, None] * dy, y)
    zl = jnp.where(ok, zl + ad[:, None] * dzl, zl)
    zu = jnp.where(ok, zu + ad[:, None] * dzu, zu)
    floor = np.float32(1e-12)
    x = jnp.clip(x, floor, 1.0 - floor)
    w = 1.0 - x
    s = jnp.maximum(s, floor)
    y = jnp.maximum(y, floor)
    zl = jnp.maximum(zl, floor)
    zu = jnp.maximum(zu, floor)
    return x, w, s, y, zl, zu, ax


@pytest.mark.parametrize("case", CASES)
def test_step_len_twin_equals_jax_bit_for_bit(case):
    v, d, _, _ = _step_inputs(3, 6, 40, 24, case)
    args = _step_args(v, d)
    got = ipm_step_len_ref(*_t(args))
    want = _jax_step_len(*(jnp.asarray(a) for a in args))
    for g, w in zip(got, want):
        assert np.array_equal(_bits(g), _bits(w))
    if case == "positive":
        assert float(got[0][1]) == 1.0 == float(got[1][1])
    assert float(got[0][2]) == 1.0 == float(got[1][2])


@pytest.mark.parametrize("case", CASES)
def test_update_twin_equals_jax_bit_for_bit(case):
    v, d, ap, ad = _step_inputs(5, 6, 40, 24, case)
    state, dirs = _state(v), _dirs(d)
    got = ipm_update_ref(_t(state), _t(dirs), *_t((ap, ad)))
    want = _jax_update(*((tuple(jnp.asarray(a) for a in group))
                         for group in (state, dirs)),
                       jnp.asarray(ap), jnp.asarray(ad))
    for g, w in zip(got, want):
        assert np.array_equal(_bits(g), _bits(w))
    if case in ("nan_dx", "nan_dy"):   # the lane keeps its iterate
        assert np.array_equal(_bits(got[0][1]), _bits(state[0][1]))
        assert np.array_equal(_bits(got[6][1]), _bits(state[6][1]))
    if case == "clamp":
        assert float(got[0].min()) > 0.0 and float(got[2].min()) > 0.0


def test_wrappers_run_the_twins_on_cpu():
    v, d, ap, ad = _step_inputs(9, 4, 16, 12, "random")
    before = (ipm_kernel.STEP_LEN_LAUNCHES, ipm_kernel.UPDATE_LAUNCHES)
    got = ipm_step_len(*_t(_step_args(v, d)))
    want = ipm_step_len_ref(*_t(_step_args(v, d)))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    st = ipm_update(_t(_state(v)), _t(_dirs(d)), *_t((ap, ad)))
    ref = ipm_update_ref(_t(_state(v)), _t(_dirs(d)), *_t((ap, ad)))
    assert all(torch.equal(g, w) for g, w in zip(st, ref))
    assert (ipm_kernel.STEP_LEN_LAUNCHES,
            ipm_kernel.UPDATE_LAUNCHES) == before


def _lp(seed, bsz, n, t, active_rows, dev="cpu"):
    """Signed +-1/0 cut rows with a feasible rhs (``tests/test_ipm.py``'s
    shape of LP), as a row slice of a deeper buffer."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    score = torch.rand((bsz, active_rows, n), generator=gen, device=dev)
    k = torch.randint(3, 9, (bsz, active_rows, 1), generator=gen,
                      device=dev)
    kth = score.sort(dim=-1).values.gather(-1, k - 1)
    sign = torch.where(torch.rand(score.shape, generator=gen, device=dev)
                       < 0.5, -1.0, 1.0)
    rows = torch.where(score <= kth, sign, 0.0)
    buf = torch.zeros((bsz, t + 32, n), device=dev)
    buf[:, :active_rows] = rows
    b = torch.zeros((bsz, t), device=dev)
    b[:, :active_rows] = (rows > 0).sum(dim=-1) - 1.0
    c = 4.0 * torch.randn((bsz, n), generator=gen, device=dev)
    return c, buf[:, :t], b


@pytest.mark.parametrize("backends", [("xla", "xla"), ("kernel", "blocked")])
def test_eager_solve_is_the_cpu_default(backends):
    c, a, b = _lp(1, 4, 40, 48, 30)
    kw = dict(iters=40, matvec_backend=backends[0],
              factor_backend=backends[1])
    got = ipm_box_lp(c, a, b, **kw)
    want = ipm_box_lp(c, a, b, graphs=False, **kw)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert bool((got[2] < 1e-2).all())


def test_graphs_on_cpu_raise():
    c, a, b = _lp(2, 2, 16, 16, 8)
    with pytest.raises(ValueError, match="graphs=True needs a CUDA tensor"):
        ipm_box_lp(c, a, b, graphs=True)
    h = np.array([[1, 1, 0, 1], [0, 1, 1, 1]], np.uint8)
    dec = AGCALPDecoder(h, device="cpu")
    assert dec.ipm_graphs is None
    dec.ipm_graphs = True                      # passed through to the solve
    with pytest.raises(ValueError, match="graphs=True"):
        dec.decode_batch(torch.tensor([[1.0, -0.5, 0.2, 0.1]] * 2))


def test_pack_rows_into_a_buffer():
    _, a, _ = _lp(4, 3, 21, 10, 7)
    want, ok = pack_rows(a)
    out = torch.zeros_like(want)
    got, ok2 = pack_rows(a, out=out)
    assert got is out and torch.equal(got, want) and bool(ok) and bool(ok2)
    with pytest.raises(ValueError, match="out must be"):
        pack_rows(a, out=torch.zeros((3, 10, 21), dtype=torch.int8))


def test_replay_adds_the_captured_counts():
    """What a replay adds to the counters (the capture's delta, ints and
    per-tier Counters alike) and to the replay tallies."""
    before = ipm_graph._snapshot()
    tallies = (ipm_graph.REPLAYS, ipm_graph.CALLS, ipm_graph.NODES)
    delta = [2 if not isinstance(v, Counter) else Counter({128: 3})
             for v in before]
    calls = sum(d for d in delta if not isinstance(d, Counter))

    class _Graph:
        replays = 0

        def replay(self):
            self.replays += 1

    part = ipm_graph.Captured(_Graph(), delta, calls, 40, [])
    try:
        ipm_graph.replay(part)
        ipm_graph.replay(part)
        after = ipm_graph._snapshot()
        for b, a, d in zip(before, after, delta):
            if isinstance(d, Counter):
                assert a[128] - b[128] == 6
            else:
                assert a - b == 4
        assert part.graph.replays == 2
        assert (ipm_graph.REPLAYS - tallies[0], ipm_graph.CALLS - tallies[1],
                ipm_graph.NODES - tallies[2]) == (2, 2 * calls, 80)
    finally:
        ipm_graph._restore(before)
        ipm_graph.REPLAYS, ipm_graph.CALLS, ipm_graph.NODES = tallies


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("t", [128, 640, 1408])
def test_kernels_equal_twins_on_card(cuda_device, t, case):
    v, d, ap, ad = _step_inputs(11, 128, t, 280, case)
    args = _t(_step_args(v, d), cuda_device)
    before = (ipm_kernel.STEP_LEN_LAUNCHES, ipm_kernel.UPDATE_LAUNCHES)
    got, want = ipm_step_len(*args), ipm_step_len_ref(*args)
    for g, w in zip(got, want):
        assert np.array_equal(_bits(g), _bits(w))
    dirs, aps = _t(_dirs(d), cuda_device), _t((ap, ad), cuda_device)
    state = _t(_state(v), cuda_device)
    ref = ipm_update_ref(state, dirs, *aps)
    out = ipm_update(tuple(s.clone() for s in state), dirs, *aps)
    for g, w in zip(out, ref):
        assert np.array_equal(_bits(g), _bits(w))
    assert (ipm_kernel.STEP_LEN_LAUNCHES - before[0],
            ipm_kernel.UPDATE_LAUNCHES - before[1]) == (1, 1)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["cold", "warm", "masked"])
@pytest.mark.parametrize("t", [128, 640, 1408])
def test_graph_solve_equals_eager_on_card(cuda_device, t, mode):
    c, a, b = _lp(7 + t, 128, 280, t, int(0.7 * t), cuda_device)
    kw = dict(iters=40, tol=1e-5)
    if mode == "warm":
        x, y, _ = ipm_box_lp(c, a, b, graphs=False, **kw)
        kw.update(x0=(x + 0.05).clamp(0.0, 1.0), y0=y)
    elif mode == "masked":
        kw["active"] = torch.arange(128, device=cuda_device) % 3 != 0
    runs = []           # the first graph solve captures its shape's graphs
    for graphs in (False, True, True):
        before = ipm_graph._snapshot()
        out = ipm_box_lp(c, a, b, graphs=graphs, **kw)
        torch.cuda.synchronize()
        delta = [x - y for x, y in zip(ipm_graph._snapshot(), before)]
        runs.append((out, delta))
    (eager, d_eager), *graph_runs = runs
    for out, delta in graph_runs:
        for g, w in zip(out, eager):
            assert np.array_equal(_bits(g), _bits(w))
        assert delta == d_eager
    assert min(d for d in d_eager if not isinstance(d, Counter)) > 0


@pytest.mark.gpu
def test_graph_solve_plain_backends_on_card(cuda_device):
    """The plain matvecs captured as well (the float32 rows copied into a
    static buffer); the plain factor's cholesky_solve runs MAGMA, which
    cannot be captured: with it the default is the eager loop and
    graphs=True raises."""
    c, a, b = _lp(3, 128, 280, 256, 180, cuda_device)
    kw = dict(iters=40, tol=1e-5, matvec_backend="xla")
    eager = ipm_box_lp(c, a, b, graphs=False, factor_backend="blocked", **kw)
    replays = ipm_graph.REPLAYS
    graph = ipm_box_lp(c, a, b, factor_backend="blocked", **kw)
    assert ipm_graph.REPLAYS > replays
    for g, w in zip(graph, eager):
        assert np.array_equal(_bits(g), _bits(w))
    replays = ipm_graph.REPLAYS
    plain = ipm_box_lp(c, a, b, factor_backend="xla", **kw)
    again = ipm_box_lp(c, a, b, graphs=False, factor_backend="xla", **kw)
    assert ipm_graph.REPLAYS == replays
    for g, w in zip(plain, again):
        assert np.array_equal(_bits(g), _bits(w))
    with pytest.raises(ValueError, match="cannot be captured"):
        ipm_box_lp(c, a, b, graphs=True, factor_backend="xla", **kw)
