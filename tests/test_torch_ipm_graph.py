"""The IPM Newton step's hand-written kernels (``csrc/ipm_step.cu``: the
prep, the predict and the correct; ``csrc/gemv.cu``'s right-hand-side
epilogue) and the solve as CUDA graphs (``ops/ipm_graph.py``) in the
PyTorch port.

On the CPU: the step lengths' and the update's twins (``ops/ipm_ref.py``,
inside the predict's and the correct's) equal the JAX package's work bit
for bit on numpy inputs from a seed: the step lengths against
``ldpc_tpu.ops.ipm_solver._pos_step`` composed as at ``:222-227``, the
masked update against ``:247-267`` written out in ``jax.numpy`` (the update
lives inside JAX's solver; each op runs on its own, as the port's eager ops
do, so no product is fused into an add). Cases: NaN and inf directions,
all-positive directions (step 1), ties, steps past the box (clamps and
floors). The solve through the three step wrappers (their twins on the
CPU) equals, bit for bit, the solve whose Newton step is the eager glue the
kernels replaced, written out here, cold, warm and masked, on both
backends. The wrappers run the twins on a CPU tensor and count nothing,
the eager solve (``graphs=False``) is the default one there, and
``graphs=True`` on a CPU tensor raises. The eager solve's tolerances
against JAX stay ``tests/test_torch_ipm.py``'s.

The kernels' launch plan (``ipm_step_plan``) on the CPU: legal at every
shape of AGC-ALP's tiers, H02's, ragged and wide ones, for 1 to 256 lanes,
covering every float of every lane once by the kernels' own index
arithmetic (emulated here), refusing an empty shape with ValueError. The
twins also equal JAX at a ragged T = 130, n = 283.

On the card (marked ``gpu``; ``python -m pytest tests/test_torch_ipm_graph.py
-m gpu --noconftest``): the three kernels, one launch each, against their
twins on the same inputs, every elementwise output bit for bit and mu and
mu_aff within (T + 2n) 2^-23 sum |terms| (the corrector's targets against
the twin given the kernel's mu_aff), a lane with a non-finite dx or dy
keeping its iterate, at AGC-ALP's eight tiers (T = 128 ... 1408, B = 128,
n = 280) with the special lanes, at ragged, unaligned (width 1), H02
(T = 2176, n = 640), two-pass (T = 8192), odd (B = 127) and B = 1, 3 and
256 shapes, and in layouts the plan does not pick (fewer threads and
several passes, more threads, width 1 on aligned arrays); illegal layouts
refused; the three captured in a CUDA graph replay to the eager launches'
bits; the right-hand side's epilogue equals its twin on the kernel's own
A^T v; a Newton step makes twelve launches and no PyTorch device
operation; the graph solve equals the eager one bit for bit in x, y and err
for cold, warm and masked solves at three tiers, twice in a row; and the
launch counters after a graph solve equal the eager solve's.
"""
from collections import Counter

import numpy as np
import pytest
import torch

from ldpc_tpu_torch.decoders.agc_alp import AGCALPDecoder
from ldpc_tpu_torch.ops import (_launch, chol_kernel, gemv_kernel, ipm_graph,
                                ipm_kernel, ipm_solver)
from ldpc_tpu_torch.ops.chol import blocked_cho_solve, blocked_cholesky
from ldpc_tpu_torch.ops.chol_ref import cholesky_nan
from ldpc_tpu_torch.ops.gemv_kernel import pack_rows
from ldpc_tpu_torch.ops.ipm_kernel import (MAX_THREADS, PER_THREAD,
                                           ipm_correct, ipm_predict,
                                           ipm_prep, ipm_step_plan)
from ldpc_tpu_torch.ops.ipm_ref import (DIAG_HI, DIAG_LO, FLOOR, FRAC,
                                        MU_FLOOR, Terms,
                                        corrector_targets_ref,
                                        directions_ref, ipm_correct_ref,
                                        ipm_predict_ref, ipm_prep_ref,
                                        ipm_step_len_ref, ipm_update_ref,
                                        newton_rhs_ref)
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


@pytest.mark.parametrize("case", CASES)
def test_twins_equal_jax_bit_for_bit_ragged(case):
    """Both twins against JAX at T = 130, n = 283 (neither a multiple of 4:
    the kernels' width-1 layout)."""
    v, d, ap, ad = _step_inputs(13, 6, 130, 283, case)
    args = _step_args(v, d)
    got = ipm_step_len_ref(*_t(args))
    want = _jax_step_len(*(jnp.asarray(a) for a in args))
    for g, w in zip(got, want):
        assert np.array_equal(_bits(g), _bits(w))
    state, dirs = _state(v), _dirs(d)
    got = ipm_update_ref(_t(state), _t(dirs), *_t((ap, ad)))
    want = _jax_update(*((tuple(jnp.asarray(a) for a in group))
                         for group in (state, dirs)),
                       jnp.asarray(ap), jnp.asarray(ad))
    for g, w in zip(got, want):
        assert np.array_equal(_bits(g), _bits(w))


def _held(plan, bsz, width, vec):
    """Emulates ``csrc/ipm_step.cu``'s ``at`` at width ``vec`` over the
    plan's blocks, threads and passes: how often the plan's threads hold
    each float of a (bsz, width) array."""
    m = plan["threads"]
    lane = np.arange(plan["blocks"])[:, None, None, None]
    k = np.arange(m)[None, :, None, None]
    p = np.arange(plan["passes"])[None, None, :, None]
    r = np.arange(PER_THREAD)[None, None, None, :]
    j = 4 * (p * m + k) + r if vec == 4 else (p * PER_THREAD + r) * m + k
    lane, j = np.broadcast_arrays(lane, j)
    keep = (lane < bsz) & (j < width)
    count = np.zeros((bsz, width), np.int64)
    np.add.at(count, (lane[keep], j[keep]), 1)
    return count


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("n", [280, 283, 640])
@pytest.mark.parametrize("t", [128, 130, 1408, 2176, 8192])
@pytest.mark.parametrize("bsz", [1, 3, 128, 256])
def test_ipm_step_plan(bsz, t, n, aligned):
    plan = ipm_step_plan(bsz, t, n, aligned)
    m, passes = plan["threads"], plan["passes"]
    assert plan["vec"] == (4 if aligned and t % 4 == 0 and n % 4 == 0
                           else 1)
    assert m % 32 == 0 and 32 <= m <= MAX_THREADS
    assert plan["blocks"] == bsz
    # 4 floats of each array a thread a pass, no warp left idle in the
    # last pass, and more passes only where a block of MAX_THREADS is full
    span = PER_THREAD * m * passes
    assert span >= max(t, n) > span - PER_THREAD * 32
    assert passes == 1 or m == MAX_THREADS
    # rows at the plan's width; the step lengths' columns at width 1
    for width, vec in ((t, plan["vec"]), (n, plan["vec"]), (n, 1)):
        assert (_held(plan, bsz, width, vec) == 1).all()


def test_ipm_step_plan_at_the_path_shapes():
    """AGC-ALP's deepest tier and H02's, as the card runs them."""
    assert ipm_step_plan(128, 1408, 280, True) == {
        "vec": 4, "threads": 352, "passes": 1, "blocks": 128}
    assert ipm_step_plan(128, 2176, 640, True) == {
        "vec": 4, "threads": 544, "passes": 1, "blocks": 128}
    assert ipm_step_plan(4, 8192, 640, True) == {
        "vec": 4, "threads": 1024, "passes": 2, "blocks": 4}
    assert ipm_step_plan(128, 130, 283, False)["vec"] == 1
    assert ipm_step_plan(128, 128, 280, True)["threads"] == 96


@pytest.mark.parametrize("shape", [(4, 32769, 280), (4, 128, 40000)])
def test_ipm_step_plan_takes_any_width(shape):
    """A lane wider than one pass of a full block takes more passes."""
    bsz, t, n = shape
    plan = ipm_step_plan(bsz, t, n, True)
    assert plan["threads"] == MAX_THREADS
    assert plan["passes"] == -(-max(t, n) // (PER_THREAD * MAX_THREADS))
    for width in (t, n):
        assert (_held(plan, bsz, width, plan["vec"]) == 1).all()


@pytest.mark.parametrize("shape", [(0, 128, 280), (4, 0, 280), (4, 128, 0)])
def test_ipm_step_plan_refuses(shape):
    with pytest.raises(ValueError, match="ipm_step_plan"):
        ipm_step_plan(*shape, True)


def _terms(v):
    """The :class:`Terms` a predict or a correct reads, from ``v``'s
    arrays (the prep's outputs it does not read left as they are)."""
    return Terms(*(v[k] for k in Terms._fields))


def _fused_inputs(seed, bsz, t, n, case):
    """A Newton step's inputs, float32 from a seed: the iterate (interior),
    the prep's A^T y, scaled objective and rhs, a direction's terms, mu, its
    dx and A dx. Lane 1 is the case's lane: NaN in dx (``nan_dx``); NaN in
    A dx, so in ds and dy, NaN in A^T y and 0 / 0 in the scalings
    (``nan_dy``); infinite directions (``inf``); directions along which
    nothing bounds a step, so both are 1 (``positive``); one ratio in many
    places (``ties``); scalings past their clamp and mu at 0, so sigma's
    floor and clamp act, and steps past the box (``clamp``). Lane 2's
    directions are so small that both steps clamp to 1."""
    rng = np.random.default_rng(seed)

    def pos(w, lo=1e-3, hi=5.0):
        return rng.uniform(lo, hi, (bsz, w)).astype(np.float32)

    def nrm(w, sd=2.0):
        return rng.normal(0.0, sd, (bsz, w)).astype(np.float32)

    v = {"x": pos(n, 1e-3, 1.0 - 1e-3), "s": pos(t), "y": pos(t),
         "zl": pos(n), "zu": pos(n), "ax": nrm(t, 3.0), "aty": nrm(n),
         "cs": nrm(n), "be": nrm(t, 3.0), "rp": nrm(t), "rd": nrm(n),
         "dy_s": pos(t), "dxl": pos(n), "dxu": pos(n), "ry": nrm(t),
         "rl": nrm(n), "ru": nrm(n), "dx": nrm(n), "adx": nrm(t),
         "mu": pos(1)[:, 0]}
    v["dxx"], v["v"] = v["dxl"] + v["dxu"], nrm(t)
    for k in ("rp", "ry", "rl", "ru", "dx", "adx"):
        v[k][2] *= np.float32(1e-5)
    nan, inf = np.float32(np.nan), np.float32(np.inf)
    if case == "nan_dx":
        v["dx"][1, 3] = nan
    elif case == "nan_dy":
        v["adx"][1, -1] = nan
        v["aty"][1, 0] = nan
        v["y"][1, 1] = v["s"][1, 1] = 0.0
    elif case == "inf":
        v["dx"][1, 1] = -inf
        v["rp"][1, 2] = inf
        v["ry"][1, 0] = inf
        v["rl"][1, 0] = inf
    elif case == "positive":
        v["rp"][1] = -np.abs(v["rp"][1])
        for k in ("ry", "rl", "ru"):
            v[k][1] = np.abs(v[k][1])
        for k in ("adx", "dy_s", "dxl", "dxu", "dx"):
            v[k][1] = 0.0
    elif case == "ties":
        v["s"][1, ::3] = v["y"][1, ::3] = 0.75
        v["rp"][1, ::3], v["adx"][1, ::3] = 1.5, 0.0
        v["dy_s"][1, ::3], v["ry"][1, ::3] = 0.0, -1.5
        v["x"][1, ::4], v["dx"][1, ::4] = 0.25, -0.5
        v["zl"][1, ::5], v["dxl"][1, ::5], v["rl"][1, ::5] = 1.0, 0.0, -2.0
    elif case == "clamp":
        v["s"][1, :5] = v["zl"][1, :5] = 1e-12
        v["mu"][1] = 0.0
        v["dx"][1] = rng.choice([-4.0, 4.0], n)
    v["w"] = (np.float32(1.0) - v["x"]).astype(np.float32)
    return v


def _fstate(v):
    return tuple(v[k] for k in ("x", "w", "s", "y", "zl", "zu", "ax"))


def test_wrappers_run_the_twins_on_cpu():
    v = {k: torch.from_numpy(a) for k, a in
         _fused_inputs(9, 4, 16, 12, "random").items()}
    nc = torch.tensor(float(16 + 2 * 12))
    state, terms = _fstate(v), _terms(v)
    before = _launch.snapshot()
    got = ipm_prep(state, v["aty"], v["cs"], v["be"], nc)
    want = ipm_prep_ref(state, v["aty"], v["cs"], v["be"], nc)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    got = ipm_predict(state, terms, v["dx"], v["adx"], nc)
    want = ipm_predict_ref(state, terms, v["dx"], v["adx"], nc)
    assert all(torch.equal(g, w) for g, w in zip((*got[0], *got[1:]),
                                                 (*want[0], *want[1:])))
    got = ipm_correct(state, terms, v["dx"], v["adx"])
    want = ipm_correct_ref(state, terms, v["dx"], v["adx"])
    assert all(torch.equal(g, w) for g, w in zip((*got[0], *got[1:]),
                                                 (*want[0], *want[1:])))
    assert _launch.since(before) == []


def _glue_newton(lp, state):
    """The Newton step as the port ran it before its glue became the three
    kernels (eager ops around the step lengths' and the update's twins),
    verbatim."""
    x, w, s, y, zl, zu, ax = state
    rp = ax + s - lp.be
    rd = lp.cs + lp.mvt(y) - zl + zu
    mu = ((y * s).sum(dim=-1) + (zl * x).sum(dim=-1)
          + (zu * w).sum(dim=-1)) / lp.n_compl
    dy_s = (y / s).clamp(1e-10, 1e10)
    dxl = (zl / x).clamp(1e-10, 1e10)
    dxu = (zu / w).clamp(1e-10, 1e10)
    m = lp.normal(dy_s, dxl + dxu)
    if lp.blocked:
        fac = blocked_cholesky(m)

        def m_solve(r):
            return blocked_cho_solve(fac, r)
    else:
        chol = cholesky_nan(m)

        def m_solve(r):
            return torch.cholesky_solve(r.unsqueeze(-1), chol).squeeze(-1)

    def solve_dir(sig_mu, extra_y, extra_l, extra_u):
        ry = (sig_mu[:, None] - extra_y) / s - y
        rl = (sig_mu[:, None] - extra_l) / x - zl
        ru = (sig_mu[:, None] - extra_u) / w - zu
        rhs = -rd - lp.mvt(ry + dy_s * rp) + rl - ru
        dx = m_solve(rhs).contiguous()
        adx = lp.mv(dx)
        ds = -rp - adx
        dy = ry - dy_s * ds
        dzl = rl - dxl * dx
        dzu = ru + dxu * dx
        return dx, dy, ds, dzl, dzu, adx

    zero_r, zero_n = torch.zeros_like(y), torch.zeros_like(x)
    dxa, dya, dsa, dzla, dzua, _ = solve_dir(
        torch.zeros((x.shape[0],), dtype=torch.float32, device=x.device),
        zero_r, zero_n, zero_n)
    ap, ad = ipm_step_len_ref(s, dsa, x, dxa, w, y, dya, zl, dzla, zu, dzua)
    ap_, ad_ = ap[:, None], ad[:, None]
    mu_aff = (((y + ad_ * dya) * (s + ap_ * dsa)).sum(dim=-1)
              + ((zl + ad_ * dzla) * (x + ap_ * dxa)).sum(dim=-1)
              + ((zu + ad_ * dzua) * (w - ap_ * dxa)).sum(dim=-1)
              ) / lp.n_compl
    ratio = mu_aff / mu.clamp_min(1e-12)
    sigma = (ratio * (ratio * ratio)).clamp(0.0, 1.0)
    dx, dy, ds, dzl, dzu, adx = solve_dir(
        sigma * mu, dya * dsa, dzla * dxa, -dzua * dxa)
    ap, ad = ipm_step_len_ref(s, ds, x, dx, w, y, dy, zl, dzl, zu, dzu)
    return ipm_update_ref(state, (dx, dy, ds, dzl, dzu, adx), ap, ad)


@pytest.mark.parametrize("mode", ["cold", "warm", "masked"])
@pytest.mark.parametrize("backends", [("xla", "xla"), ("kernel", "blocked")])
def test_the_step_kernels_twins_give_the_eager_glues_bits(monkeypatch,
                                                         backends, mode):
    """On the CPU the solve through the three step wrappers (their twins)
    equals, bit for bit, the solve whose Newton step is the eager glue the
    kernels replaced."""
    c, a, b = _lp(21, 5, 36, 44, 30)
    kw = dict(iters=40, tol=1e-5, matvec_backend=backends[0],
              factor_backend=backends[1])
    if mode == "warm":
        x, y, _ = ipm_box_lp(c, a, b, iters=10)
        kw.update(x0=(x + 0.05).clamp(0.0, 1.0), y0=y)
    elif mode == "masked":
        kw["active"] = torch.arange(5) % 2 == 0
    got = ipm_box_lp(c, a, b, **kw)
    monkeypatch.setattr(ipm_solver, "_newton", _glue_newton)
    want = ipm_box_lp(c, a, b, **kw)
    for g, w in zip(got, want):
        assert np.array_equal(_bits(g), _bits(w))


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
    before = _launch.snapshot()
    tallies = (ipm_graph.REPLAYS, ipm_graph.CALLS, ipm_graph.NODES)
    delta = [(c, 2, None if c.by is None else Counter({128: 3}))
             for c in _launch.COUNTERS]
    calls = sum(n for _, n, _ in delta)

    class _Graph:
        replays = 0

        def replay(self):
            self.replays += 1

    part = ipm_graph.Captured(_Graph(), delta, calls, 40, [])
    try:
        ipm_graph.replay(part)
        ipm_graph.replay(part)
        after = _launch.snapshot()
        for (c, (n0, by0)), (_, (n1, by1)) in zip(before, after):
            assert n1 - n0 == 4
            if c.by is not None:
                assert by1[128] - by0[128] == 6
        assert part.graph.replays == 2
        assert (ipm_graph.REPLAYS - tallies[0], ipm_graph.CALLS - tallies[1],
                ipm_graph.NODES - tallies[2]) == (2, 2 * calls, 80)
    finally:
        _launch.restore(before)
        ipm_graph.REPLAYS, ipm_graph.CALLS, ipm_graph.NODES = tallies


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_inputs(dev, bsz, t, n, case, offset=0):
    """``_fused_inputs`` on the card (B = 1: the case's lane 1 of a 3-lane
    draw, alone), each array a contiguous view ``offset`` floats into a
    buffer of its own (offset 1: not 16-byte aligned), and n_compl."""
    v = _fused_inputs(11, max(bsz, 3), t, n, case)
    lanes = slice(1, 2) if bsz == 1 else slice(0, bsz)

    def put(a):
        a = np.ascontiguousarray(a[lanes])
        buf = torch.empty(a.size + offset, dtype=torch.float32, device=dev)
        view = buf[offset:].view(a.shape)
        view.copy_(torch.from_numpy(a))
        return view

    return ({k: put(a) for k, a in v.items()},
            torch.full((), float(t + 2 * n), device=dev))


def _empty(dev, *shape):
    return torch.empty(shape, dtype=torch.float32, device=dev)


def _prep_by(plan, state, v, nc):
    """One prep launch by ``plan``, not the wrapper's."""
    (bsz, t), n, dev = state[2].shape, state[0].shape[1], nc.device
    out = Terms(*(_empty(dev, bsz) if k == "mu" else
                  _empty(dev, bsz, t if k in ("rp", "dy_s", "ry", "v")
                         else n) for k in Terms._fields))
    _launch.launch("ipm_prep", "ldpc_ipm_prep", dev, *state, v["aty"],
                   v["cs"], v["be"], nc, *out, bsz, t, n, DIAG_LO, DIAG_HI,
                   plan["vec"], plan["threads"])
    return out


def _predict_by(plan, state, terms, dx, adx, nc):
    """One predict launch by ``plan``."""
    (bsz, t), n, dev = state[2].shape, state[0].shape[1], nc.device
    ap, ad, mu_aff = _empty(dev, bsz), _empty(dev, bsz), _empty(dev, bsz)
    ry, v = _empty(dev, bsz, t), _empty(dev, bsz, t)
    rl, ru = _empty(dev, bsz, n), _empty(dev, bsz, n)
    _launch.launch("ipm_predict", "ldpc_ipm_predict", dev, *state[:6],
                   terms.rp, terms.dy_s, terms.dxl, terms.dxu, terms.ry,
                   terms.rl, terms.ru, dx, adx, terms.mu, nc, ap, ad, mu_aff,
                   ry, rl, ru, v, bsz, t, n, FRAC, MU_FLOOR, plan["vec"],
                   plan["threads"])
    return terms._replace(ry=ry, rl=rl, ru=ru, v=v), ap, ad, mu_aff


def _correct_by(plan, state, terms, dx, adx):
    """One correct launch by ``plan``, the state in place."""
    (bsz, t), n, dev = state[2].shape, state[0].shape[1], dx.device
    ap, ad = _empty(dev, bsz), _empty(dev, bsz)
    _launch.launch("ipm_correct", "ldpc_ipm_correct", dev, *state, terms.rp,
                   terms.dy_s, terms.dxl, terms.dxu, terms.ry, terms.rl,
                   terms.ru, dx, adx, ap, ad, bsz, t, n, FRAC, FLOOR,
                   1.0 - FLOOR, plan["vec"], plan["threads"])
    return state, ap, ad


def _sum_close(got, want, terms_abs, t, n):
    """A per-lane sum over its n_compl: NaN where the twin's is NaN, the
    twin's infinity where it is infinite, else within
    (T + 2n) 2^-23 sum |terms| / n_compl."""
    g = got.double().cpu().numpy()
    w = want.double().cpu().numpy()
    nan, fin = np.isnan(w), np.isfinite(w)
    assert np.array_equal(np.isnan(g), nan)
    assert np.array_equal(g[~nan & ~fin], w[~nan & ~fin])
    n_compl = t + 2 * n
    bound = n_compl * 2.0 ** -23 * terms_abs.cpu().numpy() / n_compl
    assert (np.abs(g - w)[fin] <= bound[fin]).all()


def _fused_vs_twins(dev, bsz, t, n, case, offset=0, plan=None):
    """The three kernels (through the wrappers, one launch each, or by
    ``plan``) against their twins on the same card inputs: every
    elementwise output bit for bit, mu and mu_aff within the sums' bound
    (the outputs after mu_aff against the twin given the kernel's)."""
    v, nc = _card_inputs(dev, bsz, t, n, case, offset)
    state, terms, dx, adx = _fstate(v), _terms(v), v["dx"], v["adx"]
    want_p = ipm_prep_ref(state, v["aty"], v["cs"], v["be"], nc)
    want_q = ipm_predict_ref(state, terms, dx, adx, nc)
    want_c = ipm_correct_ref(state, terms, dx, adx)
    out = tuple(u.clone() for u in state)
    if plan is None:
        before = _launch.snapshot()
        got_p = ipm_prep(state, v["aty"], v["cs"], v["be"], nc)
        got_q = ipm_predict(state, terms, dx, adx, nc)
        got_c = ipm_correct(out, terms, dx, adx)
        assert {c.name: k for c, k, _ in _launch.since(before)} == {
            "PREP_LAUNCHES": 1, "PREDICT_LAUNCHES": 1, "CORRECT_LAUNCHES": 1}
    else:
        got_p = _prep_by(plan, state, v, nc)
        got_q = _predict_by(plan, state, terms, dx, adx, nc)
        got_c = _correct_by(plan, out, terms, dx, adx)
    torch.cuda.synchronize()
    x, w, s, y, zl, zu, _ = state
    for k in Terms._fields:
        if k != "mu":
            assert np.array_equal(_bits(getattr(got_p, k)),
                                  _bits(getattr(want_p, k))), k
    _sum_close(got_p.mu, want_p.mu, (y * s).abs().sum(-1)
               + (zl * x).abs().sum(-1) + (zu * w).abs().sum(-1), t, n)
    # predict: the step lengths exact, mu_aff within the bound, the
    # corrector's targets exact given the kernel's mu_aff
    for g, k in zip(got_q[1:3], want_q[1:3]):
        assert np.array_equal(_bits(g), _bits(k))
    dirs = directions_ref(terms, dx, adx)
    ap_, ad_ = want_q[1][:, None], want_q[2][:, None]
    _, dya, dsa, dzla, dzua, _ = dirs
    _sum_close(got_q[3], want_q[3],
               ((y + ad_ * dya) * (s + ap_ * dsa)).abs().sum(-1)
               + ((zl + ad_ * dzla) * (x + ap_ * dx)).abs().sum(-1)
               + ((zu + ad_ * dzua) * (w - ap_ * dx)).abs().sum(-1), t, n)
    targets = corrector_targets_ref(state, terms, dirs, got_q[3])
    for k, want in zip(("ry", "rl", "ru", "v"), targets):
        assert np.array_equal(_bits(getattr(got_q[0], k)), _bits(want)), k
    # correct: all exact, the state in place
    assert all(g is o for g, o in zip(got_c[0], out))
    for g, want in zip((*got_c[0], *got_c[1:]), (*want_c[0], *want_c[1:])):
        assert np.array_equal(_bits(g), _bits(want))
    if case in ("nan_dx", "nan_dy") and bsz > 1:  # the lane keeps its iterate
        assert np.array_equal(_bits(got_c[0][6][1]), _bits(state[6][1]))
        assert np.array_equal(_bits(got_c[0][0][1]),
                              _bits(state[0][1].clamp(FLOOR, 1.0 - FLOOR)))
    if case == "positive" and bsz > 1:
        assert float(got_q[1][1]) == float(got_q[2][1]) == 1.0
    if bsz > 2:
        assert float(got_c[1][2]) == float(got_c[2][2]) == 1.0


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("t", [128, 256, 384, 512, 640, 896, 1152, 1408])
def test_kernels_equal_twins_on_card(cuda_device, t, case):
    """AGC-ALP's row tiers at 128 lanes and n = 280."""
    _fused_vs_twins(cuda_device, 128, t, 280, case)


# (B, T, n, offset): ragged (width 1), unaligned views (width 1), few
# lanes, an odd lane count, B = 256, H02's deepest tier (one block of 544
# threads a lane), lanes that take two passes of a block of 1024
CARD_SHAPES = [(128, 130, 283, 0), (128, 1408, 280, 1), (1, 1408, 280, 0),
               (3, 640, 280, 0), (3, 130, 283, 1), (127, 1152, 280, 0),
               (256, 1408, 280, 0), (256, 128, 280, 0), (128, 2176, 640, 0),
               (128, 2176, 640, 1), (4, 8192, 640, 0), (3, 8190, 283, 1)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("shape", CARD_SHAPES)
def test_kernels_equal_twins_on_card_at_every_shape(cuda_device, shape,
                                                    case):
    bsz, t, n, offset = shape
    _fused_vs_twins(cuda_device, bsz, t, n, case, offset)


def _layout(bsz, vec, threads):
    return {"vec": vec, "threads": threads, "blocks": bsz}


# (B, T, n, plan): layouts the plan does not pick at that shape: fewer
# threads, so several passes (4 and 11 at T = 1408; 2 and 3 at H02's),
# more threads than the lane needs, width 1 on aligned arrays
CARD_LAYOUTS = [
    (128, 1408, 280, _layout(128, 4, 96)),
    (128, 1408, 280, _layout(128, 1, 96)),
    (128, 1408, 280, _layout(128, 1, 352)),
    (128, 1408, 280, _layout(128, 4, 1024)),
    (3, 1408, 283, _layout(3, 1, 32)),
    (128, 128, 280, _layout(128, 4, 256)),
    (128, 128, 280, _layout(128, 1, 64)),
    (128, 2176, 640, _layout(128, 4, 288)),
    (128, 2176, 640, _layout(128, 1, 192)),
    (128, 2176, 640, _layout(128, 1, 544)),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("layout", CARD_LAYOUTS)
def test_every_layout_equals_twins_on_card(cuda_device, layout, case):
    *shape, plan = layout
    _fused_vs_twins(cuda_device, *shape, case, plan=plan)


@pytest.mark.gpu
def test_kernels_refuse_an_illegal_layout(cuda_device):
    """The entry points check the plan they are given (width 4 on
    unaligned arrays, a block above 1024 threads, threads not a multiple
    of 32, a width other than 1 or 4) and refuse it."""
    v, nc = _card_inputs(cuda_device, 4, 1408, 280, "random", 1)
    state, terms = _fstate(v), _terms(v)
    for plan in (_layout(4, 4, 352), _layout(4, 1, 1056), _layout(4, 1, 48),
                 _layout(4, 2, 352)):
        with pytest.raises(RuntimeError, match="ipm_prep launch failed"):
            _prep_by(plan, state, v, nc)
        with pytest.raises(RuntimeError, match="ipm_predict launch failed"):
            _predict_by(plan, state, terms, v["dx"], v["adx"], nc)
        with pytest.raises(RuntimeError, match="ipm_correct launch failed"):
            _correct_by(plan, state, terms, v["dx"], v["adx"])


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(128, 1408, 280, 0), (128, 2176, 640, 0),
                                   (3, 130, 283, 1), (1, 1408, 280, 0),
                                   (4, 8192, 640, 0)])
def test_kernels_replay_in_a_graph_on_card(cuda_device, shape):
    """The three kernels captured in one CUDA graph (each feeding the next,
    as in a Newton step) replay to the eager launches' bits; at T = 8192 a
    lane takes two passes."""
    bsz, t, n, offset = shape
    v, nc = _card_inputs(cuda_device, bsz, t, n, "nan_dx", offset)
    state = _fstate(v)

    def step(st):
        terms = ipm_prep(st, v["aty"], v["cs"], v["be"], nc)
        terms, ap, ad, mu_aff = ipm_predict(st, terms, v["dx"], v["adx"],
                                            nc)
        st, ap_c, ad_c = ipm_correct(st, terms, v["dx"], v["adx"])
        return (*terms, ap, ad, mu_aff, *st, ap_c, ad_c)

    eager = step(tuple(u.clone() for u in state))
    graphed = tuple(u.clone() for u in state)
    step(tuple(u.clone() for u in state))    # warm-up outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = step(graphed)
    graph.replay()
    torch.cuda.synchronize()
    for g, w in zip(got, eager):
        assert np.array_equal(_bits(g), _bits(w))


# (B, T, n): AGC-ALP's tiers (lanes whole in one block of A^T y, and split
# over blocks at the deeper ones), an odd lane count, ragged and H02's
_RHS_SHAPES = [(128, 128, 280), (128, 640, 280), (128, 1408, 280),
               (127, 1152, 280), (3, 130, 283), (128, 2176, 640)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", _RHS_SHAPES)
def test_newton_rhs_equals_its_twin_on_card(cuda_device, shape):
    """The A^T y kernel's epilogue: -rd - A^T v + rl - ru bit for bit with
    the twin's ops on the kernel's own A^T v, NaN and inf entries included;
    one A^T y launch a call."""
    bsz, t, n = shape
    _, a, _ = _lp(5 + t, bsz, n, t, int(0.8 * t), cuda_device)
    a8, _ = pack_rows(a)
    gen = torch.Generator(device=cuda_device).manual_seed(t)
    v, rd, rl, ru = (torch.randn((bsz, w), generator=gen, device=cuda_device)
                     for w in (t, n, n, n))
    rd[1, 0], rl[1, 1], ru[2, 2] = float("nan"), float("inf"), -float("inf")
    before = gemv_kernel.GEMV_T_LAUNCHES
    got = ipm_kernel.newton_rhs(a8, v, rd, rl, ru, n)
    assert gemv_kernel.GEMV_T_LAUNCHES - before == 1
    want = newton_rhs_ref(rd, gemv_kernel.batched_gemv_t(a8, v, n), rl, ru)
    torch.cuda.synchronize()
    assert np.array_equal(_bits(got), _bits(want))
    with pytest.raises(ValueError, match="newton_rhs: rl must have shape"):
        ipm_kernel.newton_rhs(a8, v, rd, rl[:, :-1], ru, n)


@pytest.mark.gpu
@pytest.mark.parametrize("t", [128, 1408])
def test_a_newton_step_makes_twelve_launches_and_no_torch_op(cuda_device, t):
    """One Newton step on the card with the kernel backends (n = 280):
    twelve hand-written launches, one of each step kernel, and nothing else
    on the device: what PyTorch runs (a ``TorchDispatchMode`` sees every
    ATen call) is allocations."""
    from torch.utils._python_dispatch import TorchDispatchMode

    c, a, b = _lp(3 + t, 128, 280, t, int(0.7 * t), cuda_device)
    solve = ipm_solver._Solve(cuda_device, 128, t, 280, True, True, False,
                              False, False, 1e-6, 5, 1e-5, 0.8, 1e-2, False)
    solve._copy_in(c, a, b, None, None, None)
    solve._start()
    solve._boundary()
    torch.cuda.synchronize()
    ops = []

    class Seen(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            ops.append(str(func).split(".")[1])
            return func(*args, **(kwargs or {}))

    before = _launch.snapshot()
    with Seen():
        ipm_solver._newton(solve.lp, solve.state)
    delta = _launch.since(before)
    assert {c.name: k for c, k, _ in delta
            if c.module == ipm_kernel.__name__} == {
        "PREP_LAUNCHES": 1, "PREDICT_LAUNCHES": 1, "CORRECT_LAUNCHES": 1}
    assert sum(k for _, k, _ in delta) == 12
    assert set(ops) <= {"empty", "empty_like", "new_empty", "empty_strided"}


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
        before = _launch.snapshot()
        out = ipm_box_lp(c, a, b, graphs=graphs, **kw)
        torch.cuda.synchronize()
        runs.append((out, _launch.since(before)))
    (eager, d_eager), *graph_runs = runs
    for out, delta in graph_runs:
        for g, w in zip(out, eager):
            assert np.array_equal(_bits(g), _bits(w))
        assert delta == d_eager
    # every hand-written kernel of the Newton step launched but the blocked
    # chain's diagonal kernel (n = 280 takes the fused factor and solve)
    launched = {(c.module, c.name): n for c, n, _ in d_eager}
    counted = {(c.module, c.name): launched.get((c.module, c.name), 0)
               for c in _launch.COUNTERS
               if c.module.rsplit(".", 1)[1] in ("gemv_kernel", "chol_kernel",
                                                 "ipm_kernel")}
    assert len(counted) == 9
    assert counted.pop((chol_kernel.__name__, "LAUNCHES")) == 0
    assert min(counted.values()) > 0


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
