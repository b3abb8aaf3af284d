"""The fused Cholesky factor and solve of the IPM's Newton system
(``ops/chol_kernel.py`` ``chol_factor`` / ``chol_solve`` ->
``csrc/chol_fused.cu``) and the choice ``ops/chol.py`` makes by n.

On the CPU: the wrappers' checks, the choice by n, the twins
(``ops/chol_ref.py`` ``chol_factor_ref`` / ``chol_solve_ref``) against the
blocked chain (``chain_cholesky``: ``bmm`` panels around the diagonal
block's twin) in the same ``CholFactors`` layout at n = 280 and H02's 640,
the NaN rule, a NumPy emulation of the kernel's data flow (panel, chunked
update, the one sweep over the diagonal block, the rows below it and the
identity rows, the stores) against the twin, and the launch counters the
graphs replay. Tolerances are ``tests/test_chol.py``'s: 2e-4 of the
factor's scale, 5e-3 on the solve (float32 factors that differ only in the
order of their sums).

On the card (marked ``gpu``; ``python -m pytest
tests/test_torch_chol_fused.py -m gpu --noconftest``; this file does not
import JAX): the kernels against ``cholesky_ex`` + ``cholesky_solve`` and
the twins at AGC-ALP's (128, 280) and at other shapes, the blocked chain at
n = 640, NaN in a non-SPD lane only, repeat calls bit-identical, the
refusals, and an IPM solve replayed as CUDA graphs equal to the eager loop
bit for bit with the fused kernels' counters equal on both and one factor a
Newton step.
"""
from collections import Counter

import numpy as np
import pytest
import torch

from ldpc_tpu_torch.ops import _launch, chol_kernel, ipm_graph, ipm_solver
from ldpc_tpu_torch.ops.chol import (CholFactors, blocked_cho_solve,
                                     blocked_cholesky, chain_cholesky, fused)
from ldpc_tpu_torch.ops.chol_kernel import (FUSED_MAX_N, chol_factor,
                                            chol_solve)
from ldpc_tpu_torch.ops.chol_ref import (chol_factor_ref, chol_solve_ref,
                                         cholesky_nan)

NB = 64


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def spd(rng, b, n, cond_boost=0.0):
    """``tests/test_chol.py``'s SPD generator."""
    a = rng.normal(size=(b, n, n)).astype(np.float32)
    m = np.einsum("bij,bkj->bik", a, a) / n + np.eye(n, dtype=np.float32)
    if cond_boost:
        d = np.exp(rng.uniform(-cond_boost, cond_boost,
                               (b, n))).astype(np.float32)
        m = m * d[:, :, None] * d[:, None, :]
    return m


def _close(got, want, rel=2e-4):
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= rel * scale


@pytest.mark.parametrize("n,nb,want", [(1, 64, True), (37, 64, True),
                                       (280, 64, True), (320, 64, True),
                                       (321, 64, False), (448, 64, False),
                                       (640, 64, False), (280, 32, False)])
def test_the_fused_kernels_take_n_up_to_their_limit(n, nb, want):
    assert FUSED_MAX_N == 320
    assert fused(n, nb) is want


def test_wrappers_refuse_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match=r"\(B, n, n\)"):
        chol_factor(torch.zeros(4, 4))
    with pytest.raises(ValueError, match=r"\(B, n, n\)"):
        chol_factor(torch.zeros(2, 4, 5))
    with pytest.raises(ValueError, match="no implementation"):
        chol_factor(torch.zeros(2, 4, 4, device="meta"))
    with pytest.raises(ValueError, match="no implementation"):
        chol_solve(torch.zeros(2, 64, 64), torch.zeros(1, 2, 64, 64),
                   torch.zeros(2, 4, device="meta"), 4)
    with pytest.raises(ValueError, match=r"n in 1\.\.320, got 321"):
        chol_kernel._fused_n("chol_factor", 321)
    with pytest.raises(ValueError, match="got 0"):
        chol_kernel._fused_n("chol_solve", 0)
    assert chol_kernel._fused_n("chol_factor", 280) == 320
    assert chol_kernel._fused_n("chol_factor", 64) == 64
    # the check the wrappers make of their tensors on CUDA
    cpu = torch.device("cpu")
    with pytest.raises(TypeError,
                       match="chol_factor: m must be torch.float32"):
        _launch.expect("chol_factor", "m",
                       torch.zeros(2, 3, 3, dtype=torch.float64),
                       torch.float32, (2, 3, 3), cpu)
    with pytest.raises(ValueError,
                       match=r"chol_solve: l must have shape \(2, 3, 3\)"):
        _launch.expect("chol_solve", "l", torch.zeros(2, 3, 4), torch.float32,
                       (2, 3, 3), cpu)
    with pytest.raises(ValueError, match="chol_factor: m must be contiguous"):
        _launch.expect("chol_factor", "m",
                       torch.zeros(2, 3, 3).transpose(1, 2), torch.float32,
                       (2, 3, 3), cpu)


@pytest.mark.parametrize("n", [280, 640])
def test_twin_matches_the_chain(n):
    """The twins give the chain's CholFactors layout (L padded to a
    multiple of 64 with an identity tail, zero above the diagonal; the
    inverted blocks zero above theirs) and its values, and the same
    solve."""
    rng = np.random.default_rng(n)
    m = torch.from_numpy(spd(rng, 3, n, cond_boost=2.0))
    r = torch.from_numpy(rng.normal(size=(3, n)).astype(np.float32))
    l, inv = chol_factor_ref(m)
    chain = chain_cholesky(m)
    n_pad = -(-n // NB) * NB
    assert l.shape == chain.l.shape == (3, n_pad, n_pad)
    assert inv.shape == chain.inv_diag.shape == (n_pad // NB, 3, NB, NB)
    assert not bool(l.triu(1).any()) and not bool(inv.triu(1).any())
    assert torch.equal(l[:, n:, n:], torch.eye(n_pad - n).expand(
        3, -1, -1))
    assert not bool(l[:, n:, :n].any())
    _close(l, chain.l)
    _close(inv, chain.inv_diag)
    x = chol_solve_ref(l, inv, r, n)
    x_chain = blocked_cho_solve(chain, r)
    x_ref = torch.cholesky_solve(r[..., None], cholesky_nan(m))[..., 0]
    np.testing.assert_allclose(x.numpy(), x_chain.numpy(), atol=5e-3,
                               rtol=5e-3)
    np.testing.assert_allclose(x.numpy(), x_ref.numpy(), atol=5e-3,
                               rtol=5e-3)


@pytest.mark.parametrize("n", [70, 280, 640])
def test_blocked_cholesky_chooses_by_n_on_the_cpu(n):
    """At n <= FUSED_MAX_N ``blocked_cholesky`` and ``blocked_cho_solve``
    run the fused wrappers (here their twins), past it the chain; both give
    CholFactors, and no kernel launches on the CPU."""
    rng = np.random.default_rng(3 + n)
    m = torch.from_numpy(spd(rng, 2, n))
    r = torch.from_numpy(rng.normal(size=(2, n)).astype(np.float32))
    before = (chol_kernel.LAUNCHES, chol_kernel.FACTOR_LAUNCHES,
              chol_kernel.SOLVE_LAUNCHES)
    fac = blocked_cholesky(m)
    x = blocked_cho_solve(fac, r)
    assert isinstance(fac, CholFactors) and (fac.nb, fac.n) == (NB, n)
    want = (chol_factor_ref(m) if fused(n, NB)
            else (chain_cholesky(m).l, chain_cholesky(m).inv_diag))
    assert torch.equal(fac.l, want[0]) and torch.equal(fac.inv_diag, want[1])
    assert torch.equal(x, chol_solve_ref(fac.l, fac.inv_diag, r, n))
    assert (chol_kernel.LAUNCHES, chol_kernel.FACTOR_LAUNCHES,
            chol_kernel.SOLVE_LAUNCHES) == before


def test_twin_nans_a_non_spd_lane_only():
    rng = np.random.default_rng(11)
    m = spd(rng, 4, 200)
    m[1] = -np.eye(200, dtype=np.float32)
    l, inv = chol_factor_ref(torch.from_numpy(m))
    x = chol_solve_ref(l, inv, torch.ones(4, 200), 200)
    assert bool(torch.isnan(l[1]).any()) and bool(torch.isnan(x[1]).any())
    for b in (0, 2, 3):
        assert bool(l[b].isfinite().all()) and bool(x[b].isfinite().all())
        assert bool(inv[:, b].isfinite().all())


THREADS, GROUPS = 256, 8


def _emulate(m):
    """The fused factor's data flow for one lane, in float32 NumPy: the
    zeros no block step writes, then per block column the panel rows'
    update (a thread per row, split over up to GROUPS threads by k where
    the panel has few rows: the row's own thread sums from M's row, the
    others from zero, and it adds their partial sums in group order), one
    sweep over the 64 columns of the diagonal block's rows (the identity
    past n), the rows below it and 64 identity rows (each column's pivot
    posted by the diagonal block's rows; x_k scaled by r = 1 / sqrt(pivot),
    the diagonal's own row taking s; x_j -= x_k (D_jk r) on the rows below
    and the identity rows, x_j -= (x_k r) D_jk on the diagonal block's rows
    past column k + 1), and the stores. Every entry of L and V is written
    exactly once or the emulation fails (NaN marks the unwritten)."""
    f32 = np.float32
    n = m.shape[0]
    n_pad = -(-n // NB) * NB
    l = np.full((n_pad, n_pad), np.nan, f32)
    inv = np.full((n_pad // NB, NB, NB), np.nan, f32)
    for i in range(n_pad):
        l[i, (i // NB + 1) * NB:] = 0
        if i >= n:
            l[i, :n_pad - NB] = 0
    for q in range(n_pad // NB):
        qs = q * NB
        rr = n - qs
        w, below = min(rr, NB), max(rr - NB, 0)
        p = np.zeros((max(rr, NB), NB), f32)
        p[:rr, :w] = m[qs:qs + rr, qs:qs + w]
        if q:
            groups = min(GROUPS, max(1, THREADS // rr))
            span = -(-(qs // groups) // 4) * 4
            bt = l[qs:qs + NB, :qs].T
            a = l[qs:qs + rr, :qs]
            assert np.isfinite(bt).all() and np.isfinite(a).all()
            parts = []
            for grp in range(groups):
                acc = p[:rr].copy() if grp == 0 else np.zeros((rr, NB), f32)
                for k in range(grp * span, min(qs, (grp + 1) * span)):
                    acc -= a[:, k:k + 1] * bt[None, k]
                parts.append(acc)
            p[:rr] = parts[0]
            for part in parts[1:]:
                p[:rr] += part
        rows = np.zeros((NB + below + NB, NB), f32)
        for g in range(len(rows)):
            if g < w or NB <= g < NB + below:
                rows[g] = p[g]
            else:
                rows[g, g if g < NB else g - NB - below] = 1
        diag = rows[:NB]
        for k in range(NB):
            col = diag[:, k].copy()
            s = np.sqrt(col[k], dtype=f32)
            r = f32(1) / s
            t = diag[:, k] * r
            diag[:, k] = np.where(np.arange(NB) > k, t,
                                  np.where(np.arange(NB) == k, s,
                                           diag[:, k]))
            for j in range(k + 1, NB):
                if j == k + 1:
                    diag[:, j] -= diag[:, k] * (col[j] * r)
                else:
                    diag[:, j] -= (diag[:, k] * r) * col[j]
            rest = rows[NB:]
            rest[:, k] *= r
            for j in range(k + 1, NB):
                rest[:, j] -= rest[:, k] * (col[j] * r)
        for g in range(NB + below):
            v = rows[g].copy()
            if g < NB:
                v[np.arange(NB) > g] = 0
            l[qs + g, qs:qs + NB] = v
        for c_ in range(NB):
            v = rows[NB + below + c_]
            inv[q, :, c_] = np.where(np.arange(NB) >= c_, v, 0)
    assert np.isfinite(l).all() and np.isfinite(inv).all()
    return l, inv


@pytest.mark.parametrize("n", [1, 37, 64, 70, 130, 280])
def test_kernel_data_flow_matches_the_twin(n):
    """The kernel's data flow, emulated, writes every entry of L and V
    once and agrees with the twin to float32 rounding."""
    rng = np.random.default_rng(100 + n)
    m = spd(rng, 1, n, cond_boost=1.0)
    l, inv = _emulate(m[0])
    lr, vr = chol_factor_ref(torch.from_numpy(m))
    _close(torch.from_numpy(l), lr[0])
    _close(torch.from_numpy(inv), vr[:, 0])


def test_graphs_replay_the_fused_counters():
    """The fused kernels' counters are among those a graph replay adds, the
    by-shape Counter the split of the factor's."""
    declared = {c.name: c for c in _launch.COUNTERS
                if c.module == chol_kernel.__name__}
    assert [(c.name, c.by) for c in declared.values()] == [
        ("LAUNCHES", None), ("FACTOR_LAUNCHES", "FACTOR_SHAPE_LAUNCHES"),
        ("SOLVE_LAUNCHES", None)]
    snap = _launch.snapshot()
    assert isinstance(chol_kernel.FACTOR_SHAPE_LAUNCHES, Counter)
    delta = [(declared["FACTOR_LAUNCHES"], 5, Counter({(128, 280): 5}))]
    part = ipm_graph.Captured(type("G", (), {"replay": lambda self: None})(),
                              delta, 5, 0, [])
    try:
        before = (chol_kernel.FACTOR_LAUNCHES,
                  chol_kernel.FACTOR_SHAPE_LAUNCHES[128, 280])
        ipm_graph.replay(part)
        assert chol_kernel.FACTOR_LAUNCHES == before[0] + 5
        assert chol_kernel.FACTOR_SHAPE_LAUNCHES[128, 280] == before[1] + 5
    finally:
        _launch.restore(snap)


# -- on the card ------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_spd(dev, bsz, n, seed, boost=2.0):
    return torch.from_numpy(spd(np.random.default_rng(seed), bsz, n,
                                boost)).to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("bsz,n", [(128, 280), (16, 640)])
def test_factor_and_solve_match_cholesky_solve_on_card(cuda_device, bsz, n):
    """AGC-ALP's shape by the fused kernels (one launch each) and H02's by
    the blocked chain, against cholesky_ex + cholesky_solve within
    tests/test_chol.py's tolerances, with one lane not SPD: NaN in that
    lane only."""
    m = _card_spd(cuda_device, bsz, n, n)
    m[3] = -torch.eye(n, device=cuda_device)
    good = torch.ones(bsz, dtype=torch.bool, device=cuda_device)
    good[3] = False
    r = torch.randn((bsz, n), device=cuda_device,
                    generator=torch.Generator(cuda_device).manual_seed(n))
    before = (chol_kernel.FACTOR_LAUNCHES, chol_kernel.SOLVE_LAUNCHES,
              chol_kernel.FACTOR_SHAPE_LAUNCHES[bsz, n])
    fac = blocked_cholesky(m)
    x = blocked_cho_solve(fac, r)
    torch.cuda.synchronize()
    grew = (chol_kernel.FACTOR_LAUNCHES - before[0],
            chol_kernel.SOLVE_LAUNCHES - before[1],
            chol_kernel.FACTOR_SHAPE_LAUNCHES[bsz, n] - before[2])
    assert grew == ((1, 1, 1) if fused(n, NB) else (0, 0, 0))
    l_ref = cholesky_nan(m)
    x_ref = torch.cholesky_solve(r[..., None], l_ref)[..., 0]
    _close(fac.l[good][:, :n, :n], l_ref[good])
    np.testing.assert_allclose(x[good].cpu().numpy(),
                               x_ref[good].cpu().numpy(), atol=5e-3,
                               rtol=5e-3)
    assert bool(torch.isnan(fac.l[3]).any()) and bool(torch.isnan(x[3]).any())
    assert bool(fac.l[good].isfinite().all()) and bool(
        x[good].isfinite().all())


@pytest.mark.gpu
@pytest.mark.parametrize("bsz,n", [(1, 1), (3, 37), (5, 64), (4, 65),
                                   (128, 200), (2, 281), (16, 320)])
def test_kernels_match_their_twins_on_card(cuda_device, bsz, n):
    """The kernels against the twins (L, V and x within 2e-4 of their
    scale), L and V zero above the diagonal, a second call bit-identical,
    and a contiguous view that is not 16-byte aligned (the panel then copied
    a float at a time) giving the same bits."""
    m = _card_spd(cuda_device, bsz, n, 7 * n + bsz, boost=1.0)
    r = torch.randn((bsz, n), device=cuda_device,
                    generator=torch.Generator(cuda_device).manual_seed(1))
    store = torch.empty(m.numel() + 1, device=cuda_device)
    shifted = store[1:].view(m.shape)
    shifted.copy_(m)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 != 0
    l, inv = chol_factor(m)
    l2, inv2 = chol_factor(m)
    l3, inv3 = chol_factor(shifted)
    x = chol_solve(l, inv, r, n)
    x2 = chol_solve(l, inv, r, n)
    lr, vr = chol_factor_ref(m)
    xr = chol_solve_ref(lr, vr, r, n)
    torch.cuda.synchronize()
    _close(l, lr)
    _close(inv, vr)
    _close(x, xr, rel=5e-3)
    assert not bool(l.triu(1).any()) and not bool(inv.triu(1).any())
    for a, b in ((l, l2), (inv, inv2), (l, l3), (inv, inv3), (x, x2)):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_kernels_refuse_on_card(cuda_device):
    from ldpc_tpu_torch.ops import _build
    assert _build.load().ldpc_chol_fused_max_n() == FUSED_MAX_N
    before = (chol_kernel.FACTOR_LAUNCHES, chol_kernel.SOLVE_LAUNCHES)
    with pytest.raises(ValueError, match="n in 1..320"):
        chol_factor(torch.zeros(2, 321, 321, device=cuda_device))
    with pytest.raises(TypeError, match="float32"):
        chol_factor(torch.zeros(2, 8, 8, device=cuda_device,
                                dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        chol_factor(torch.zeros(2, 8, 8, device=cuda_device).transpose(1, 2))
    l, inv = chol_factor(_card_spd(cuda_device, 2, 8, 1))
    with pytest.raises(ValueError, match="chol_solve: l must have shape"):
        chol_solve(l, inv, torch.zeros(3, 8, device=cuda_device), 8)
    assert (chol_kernel.FACTOR_LAUNCHES,
            chol_kernel.SOLVE_LAUNCHES) == (before[0] + 1, before[1])


def _cut_lp(dev, seed, bsz=128, n=280, t=640, active=448):
    """Signed +-1/0 cut rows with a feasible rhs, as a row slice of a
    deeper buffer (``tests/test_torch_ipm_graph.py``'s shape of LP)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    score = torch.rand((bsz, active, n), generator=gen, device=dev)
    k = torch.randint(3, 9, (bsz, active, 1), generator=gen, device=dev)
    kth = score.sort(dim=-1).values.gather(-1, k - 1)
    sign = torch.where(torch.rand(score.shape, generator=gen, device=dev)
                       < 0.5, -1.0, 1.0)
    rows = torch.where(score <= kth, sign, 0.0)
    buf = torch.zeros((bsz, t + 32, n), device=dev)
    buf[:, :active] = rows
    b = torch.zeros((bsz, t), device=dev)
    b[:, :active] = (rows > 0).sum(dim=-1) - 1.0
    c = 4.0 * torch.randn((bsz, n), generator=gen, device=dev)
    return c, buf[:, :t], b


def _fused_counts():
    return (chol_kernel.FACTOR_LAUNCHES, chol_kernel.SOLVE_LAUNCHES,
            Counter(chol_kernel.FACTOR_SHAPE_LAUNCHES), chol_kernel.LAUNCHES)


@pytest.mark.gpu
def test_ipm_graphs_equal_the_eager_loop_with_the_fused_kernels(cuda_device):
    """An IPM solve at AGC-ALP's shape replayed as CUDA graphs equals the
    eager loop bit for bit; the fused kernels' counters grow alike on both,
    by one factor and two solves a Newton step (the solver's chunks times
    check_every), all at (128, 280), and the chain's diagonal kernel not at
    all."""
    c, a, b = _cut_lp(cuda_device, 5)
    kw = dict(iters=40, tol=1e-5, check_every=5)
    runs = []
    for graphs in (False, True, True):
        before, chunks = _fused_counts(), ipm_solver.COUNTS["chunks"]
        out = ipm_solver.ipm_box_lp(c, a, b, graphs=graphs, **kw)
        torch.cuda.synchronize()
        after = _fused_counts()
        steps = (ipm_solver.COUNTS["chunks"] - chunks) * kw["check_every"]
        grew = (after[0] - before[0], after[1] - before[1],
                after[2] - before[2], after[3] - before[3])
        assert steps > 0
        assert grew == (steps, 2 * steps, Counter({(128, 280): steps}), 0)
        runs.append((out, grew))
    (eager, d_eager), *graph_runs = runs
    for out, grew in graph_runs:
        assert grew == d_eager
        for g, w in zip(out, eager):
            assert torch.equal(g.view(torch.int32), w.view(torch.int32))

