"""Batched primal-dual interior-point LP solver, Mehrotra predictor-corrector
(counterpart of ``ldpc_tpu/ops/ipm_solver.py``).

    min  c^T x   s.t.  A x <= b,  0 <= x <= 1

with per-lane dense rows A (B, R, n). All-zero rows (the cut buffers'
inactive slots) get the benign rhs ``2n``, so their slacks stay interior and
their duals go to ~0. AGC-ALP re-solves its cut LPs with it: PDHG stalls at
~1e-2 on these degenerate LPs, the IPM reaches ~1e-5 coordinates in ~30
Newton steps, the regime of the reference's exact simplex.

Each Newton step builds the normal matrix
``M = A^T diag(y/s) A + diag(zl/x + zu/w) + delta I`` once, factors it once,
and solves it twice (predictor and corrector). Backends:

* ``matvec_backend``: ``"xla"`` (the JAX package's name, kept so
  configurations carry across) runs the plain twins of :mod:`.gemv_ref`;
  ``"kernel"`` runs :mod:`.gemv_kernel` (``csrc/gemv.cu`` and
  ``csrc/normal_build.cu`` on a CUDA tensor, the same twins on a CPU tensor).
  All three read an int8 copy of the rows made once per solve
  (``pack_rows``), exact for entries in {-1, 0, 1}: the solve raises
  ``ValueError`` on any other entry, read with the first chunk's host read;
* ``factor_backend``: ``"xla"`` is ``torch.linalg.cholesky_ex`` +
  ``cholesky_solve`` with the NaN rule of :func:`.chol_ref.cholesky_nan`;
  ``"blocked"`` is :mod:`.chol` (its diagonal step ``csrc/chol_diag_inv.cu``
  on CUDA);
* ``"auto"`` is ``"kernel"``/``"blocked"`` on CUDA and ``"xla"``/``"xla"``
  on the CPU.

The step lengths and the masked update of every Newton step are
:mod:`.ipm_kernel` (``csrc/ipm_step.cu`` on CUDA, the twins of
:mod:`.ipm_ref` on the CPU), whatever the backends: XLA fuses that work in
JAX.

Precision: the late Newton systems need full float32 products (the diagonal
entries span about 1e+-10); TF32 keeps three decimal digits and stalls the
solver at PDHG's accuracy. The solver refuses to run while
``torch.backends.cuda.matmul.allow_tf32`` is on or the float32 matmul
precision is not ``"highest"``; it does not flip the global flags itself.
Divisions whose rounding decides the trajectory divide by tensors (a Python
scalar divisor on CUDA, or a Python numerator anywhere, is
multiplication by a reciprocal in torch, which rounds differently from JAX).

JAX's ``fori_loop`` of ``lax.cond`` chunks is a Python loop of at most
``ceil(iters / check_every)`` chunks (8 at AGC-ALP's 40/5). Before each chunk
the host reads one flag, whether any lane still has to step (with the
packed copy's guard before the first chunk): one device sync per chunk, at
most 8 per solve. A chunk that does not step leaves the state
unchanged, so the flag stays false and leaving the loop at the first false
one is exact.

``graphs`` (None: on a CUDA tensor) runs the solve as JAX runs it, one
device program per part with no per-op dispatch: the start, a chunk
boundary (the lanes' errors, the stall bookkeeping and the flag), a chunk
of ``check_every`` Newton steps and the certificate are each captured once
per solve shape (device, lanes, rows, columns, warm start and mask given,
backends and settings) as a CUDA graph over static buffers
(:mod:`.ipm_graph`; one per row tier of AGC-ALP), and replayed after the
solve's inputs are copied in. The replays run the eager loop's kernels in
its order, so the two give the same bits, and the launch counters the same
counts. ``graphs=False`` runs the eager loop on either device, and so does
``graphs=None`` with ``factor_backend="xla"``: its ``cholesky_solve`` runs
MAGMA on CUDA, which allocates inside the call and cannot be captured.
``graphs=True`` on a CPU tensor or with that backend raises.

What the parts run must be capturable: no host read, and no
``torch.where`` with a Python number (it copies the number to the card);
``masked_fill`` takes the number as an argument of its kernel.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from ..utils.profiling import spanned
from . import gemv_kernel, ipm_graph
from .chol import blocked_cho_solve, blocked_cholesky
from .chol_ref import cholesky_nan
from .gemv_kernel import (batched_gemv, batched_gemv_t, normal_build,
                          pack_rows)
from .gemv_ref import PAD, gemv_ref, gemv_t_ref, normal_ref
from .ipm_kernel import ipm_step_len, ipm_update
from .lp_solver import require_full_f32

__all__ = ["FACTOR_BACKENDS", "MATVEC_BACKENDS", "ipm_box_lp"]

MATVEC_BACKENDS = ("auto", "xla", "kernel")
FACTOR_BACKENDS = ("auto", "xla", "blocked")

_F32 = torch.float32


@dataclass
class _Lp:
    """What every part of a solve reads besides the iterate."""
    mv: Callable            # A x
    mvt: Callable           # A^T y
    normal: Callable        # A^T diag(d) A + diag(dxx) + delta I
    blocked: bool           # factor_backend "blocked"
    cs: torch.Tensor        # (B, n) objective over its per-lane scale
    be: torch.Tensor        # (B, R) rhs, 2n on all-zero rows
    row_on: torch.Tensor    # (B, R) bool
    cscale: torch.Tensor    # (B, 1)
    active: torch.Tensor | None
    n_compl: torch.Tensor   # () R + 2n
    tol: float
    stall_ratio: float


def _const(v: float, dev: torch.device) -> torch.Tensor:
    # a device fill, not a host-to-device copy: no stream sync
    return torch.full((), v, dtype=_F32, device=dev)


def _store(dsts, srcs) -> None:
    """Copy each result into its static buffer (an in-place kernel's result
    already is it)."""
    for dst, src in zip(dsts, srcs):
        if src is not dst:
            dst.copy_(src)


def _products(rows, n: int, delta: float, kernel: bool):
    """(A x, A^T y, normal matrix) on ``rows``: the packed int8 copy with
    the kernel matvecs, else the float32 rows with their twins."""
    if kernel:
        def mv(v):
            return batched_gemv(rows, v.contiguous())

        def mvt(v):
            return batched_gemv_t(rows, v.contiguous(), n)

        def normal(d, dxx):
            return normal_build(rows, d.contiguous(), dxx.contiguous(),
                                delta, n)
    else:
        def mv(v):
            return gemv_ref(rows, v)

        def mvt(v):
            return gemv_t_ref(rows, v)

        def normal(d, dxx):
            return normal_ref(rows, d, dxx, delta)
    return mv, mvt, normal


def _scaled(c, b, rows, n: int):
    """(cscale, cs, row_on, be): the per-lane objective scaling for
    conditioning (argmin-invariant) and the benign rhs of all-zero rows
    (the slack stays at 2n, the dual -> ~0)."""
    cscale = c.abs().mean(dim=-1, keepdim=True).clamp_min(1e-6)
    cs = c / cscale
    row_on = (rows != 0).any(dim=-1)                             # (B, R)
    be = torch.where(row_on, b, _const(2.0 * n, c.device))
    return cscale, cs, row_on, be


def _start(lp: _Lp, x0, y0, warm_shift: float):
    """The first iterate (x, w, s, y, zl, zu, ax): the box centre, or the
    warm start pulled ``warm_shift`` into the interior."""
    (bsz, n), r_cap, dev = lp.cs.shape, lp.be.shape[1], lp.cs.device
    if x0 is not None:
        x = x0.clamp(warm_shift, 1.0 - warm_shift)
    else:
        x = torch.full((bsz, n), 0.5, dtype=_F32, device=dev)
    w = 1.0 - x
    ax = lp.mv(x)
    s = (lp.be - ax).clamp_min(warm_shift if x0 is not None else 1.0)
    if y0 is not None:
        y = (y0 / lp.cscale.clamp_min(1e-6)).clamp_min(warm_shift)
        rc0 = lp.cs + lp.mvt(y)
        zl = rc0.clamp_min(warm_shift)
        zu = (-rc0).clamp_min(warm_shift)
    else:
        y = torch.ones((bsz, r_cap), dtype=_F32, device=dev)
        zl = 1.0 + lp.cs.clamp_min(0.0)
        zu = 1.0 + (-lp.cs).clamp_min(0.0)
    return tuple(v.contiguous() for v in (x, w, s, y, zl, zu, ax))


def _residuals(lp: _Lp, ax, x, w, s, y, zl, zu):
    rp = ax + s - lp.be                                          # (B, R)
    rd = lp.cs + lp.mvt(y) - zl + zu                             # (B, n)
    mu = ((y * s).sum(dim=-1) + (zl * x).sum(dim=-1)
          + (zu * w).sum(dim=-1)) / lp.n_compl                   # (B,)
    return rp, rd, mu


def _newton(lp: _Lp, state):
    """One predictor-corrector step; a lane whose direction is not finite
    (its factorization broke down) keeps its current, still finite,
    iterate."""
    x, w, s, y, zl, zu, ax = state
    rp, rd, mu = _residuals(lp, ax, x, w, s, y, zl, zu)
    dy_s = (y / s).clamp(1e-10, 1e10)                            # (B, R)
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
        """Newton direction for the complementarity targets
        y s -> sig_mu - extra_y (and so on); returns
        (dx, dy, ds, dzl, dzu, A dx)."""
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
    # predictor (affine scaling, sigma = 0)
    dxa, dya, dsa, dzla, dzua, _ = solve_dir(
        torch.zeros((x.shape[0],), dtype=_F32, device=x.device), zero_r,
        zero_n, zero_n)
    ap, ad = ipm_step_len(s, dsa, x, dxa, w, y, dya, zl, dzla, zu, dzua)
    ap_, ad_ = ap[:, None], ad[:, None]
    mu_aff = (((y + ad_ * dya) * (s + ap_ * dsa)).sum(dim=-1)
              + ((zl + ad_ * dzla) * (x + ap_ * dxa)).sum(dim=-1)
              + ((zu + ad_ * dzua) * (w - ap_ * dxa)).sum(dim=-1)
              ) / lp.n_compl
    ratio = mu_aff / mu.clamp_min(1e-12)
    sigma = (ratio * (ratio * ratio)).clamp(0.0, 1.0)
    # corrector (reuses the factorization)
    dx, dy, ds, dzl, dzu, adx = solve_dir(
        sigma * mu, dya * dsa, dzla * dxa, -dzua * dxa)
    ap, ad = ipm_step_len(s, ds, x, dx, w, y, dy, zl, dzl, zu, dzu)
    return ipm_update(state, (dx, dy, ds, dzl, dzu, adx), ap, ad)


def _boundary(lp: _Lp, state, best_err, stall_cnt):
    """A chunk boundary: the exact refresh of the running A x, each lane's
    error max(mu, |r_p|, |r_d|) (inactive lanes 0), the stall bookkeeping
    and the flag whether any lane still has to step. "Improving" is judged
    against the lane's running minimum, and a lane that has stalled twice
    stays stalled (JAX ipm_solver.py:300-316)."""
    x, w, s, y, zl, zu, _ = state
    ax = lp.mv(x)
    rp, rd, mu = _residuals(lp, ax, x, w, s, y, zl, zu)
    err = torch.maximum(
        mu, torch.maximum((rp.abs() * lp.row_on).amax(dim=-1),
                          rd.abs().amax(dim=-1)))
    if lp.active is not None:
        err = err.masked_fill(~lp.active, 0.0)
    improving = err < lp.stall_ratio * best_err
    latched = stall_cnt >= 2
    stall_cnt = torch.where(latched, stall_cnt,
                            (stall_cnt + 1).masked_fill(improving, 0))
    best_err = torch.minimum(best_err, err)
    go = ((err > lp.tol) & (stall_cnt < 2)).any()
    return state[:6] + (ax,), best_err, stall_cnt, go


def _certificate(lp: _Lp, state):
    """(x, y in the caller's units, err): the certificate in the caller's
    (unscaled-c) convention, as pdhg_box_lp's: max(primal violation,
    relative duality gap)."""
    x, y = state[0], state[3]
    ax = lp.mv(x)
    viol = (ax - lp.be).clamp_min(0.0).amax(dim=-1)
    rc = lp.cs + lp.mvt(y)
    pobj = (lp.cs * x).sum(dim=-1)
    dobj = -(lp.be * y * lp.row_on).sum(dim=-1) + rc.clamp_max(0.0).sum(dim=-1)
    gap = (pobj - dobj) / (1.0 + pobj.abs() + dobj.abs())
    err = torch.maximum(viol, gap)
    if lp.active is not None:
        err = err.masked_fill(~lp.active, 0.0)
    return x, y * lp.cscale, err


@spanned("lp.poll")
def _poll(go) -> bool:
    """The chunk loop's host read of the flag."""
    return bool(go)


@spanned("lp.poll")
def _first_read(go, guard) -> bool:
    """One host read for the first flag and the packed copy's guard."""
    go, exact = torch.stack((go, guard)).tolist()
    if not exact:
        raise ValueError("ipm_box_lp: the kernel matvecs need cut rows with "
                         "entries in {-1, 0, 1}")
    return go


class _GraphSolve:
    """One solve shape's static buffers and captured parts: the inputs
    copied in before each solve (objective, rhs, warm start, mask, the
    packed or float32 rows), the constants, the iterate, the stall
    bookkeeping, the flag and the outputs."""

    def __init__(self, dev, bsz, r_cap, n, kernel, blocked, warm_x, warm_y,
                 masked, delta, check_every, tol, stall_ratio, warm_shift):
        def buf(*shape, dtype=_F32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        self.n, self.kernel = n, kernel
        self.check_every, self.warm_shift = check_every, warm_shift
        self.c, self.b = buf(bsz, n), buf(bsz, r_cap)
        self.x0 = buf(bsz, n) if warm_x else None
        self.y0 = buf(bsz, r_cap) if warm_y else None
        self.active = buf(bsz, dtype=torch.bool) if masked else None
        # the packed copy's pad columns stay zero: only [..., :n] is written
        self.rows = (buf(bsz, r_cap, -(-n // PAD) * PAD, dtype=torch.int8)
                     if kernel else buf(bsz, r_cap, n))
        self.lp = _Lp(*_products(self.rows, n, delta, kernel), blocked,
                      cs=buf(bsz, n), be=buf(bsz, r_cap),
                      row_on=buf(bsz, r_cap, dtype=torch.bool),
                      cscale=buf(bsz, 1), active=self.active,
                      n_compl=_const(float(r_cap + 2 * n), dev), tol=tol,
                      stall_ratio=stall_ratio)
        self.state = tuple(buf(bsz, r_cap if i in (2, 3, 6) else n)
                           for i in range(7))
        self.best_err = buf(bsz)
        self.stall_cnt = buf(bsz, dtype=torch.int32)
        self.go = buf(dtype=torch.bool)
        self.out = (buf(bsz, n), buf(bsz, r_cap), buf(bsz))
        self.parts = None

    # the captured parts: each reads and writes the static buffers only
    def _start(self):
        lp = self.lp
        _store((lp.cscale, lp.cs, lp.row_on, lp.be),
               _scaled(self.c, self.b, self.rows, self.n))
        _store(self.state, _start(lp, self.x0, self.y0, self.warm_shift))
        self.best_err.fill_(float("inf"))
        self.stall_cnt.zero_()

    def _boundary(self):
        state, best_err, stall_cnt, go = _boundary(
            self.lp, self.state, self.best_err, self.stall_cnt)
        _store((self.state[6], self.best_err, self.stall_cnt, self.go),
               (state[6], best_err, stall_cnt, go))

    def _chunk(self):
        state = self.state
        for _ in range(self.check_every):
            state = _newton(self.lp, state)
        _store(self.state, state)

    def _finish(self):
        _store(self.out, _certificate(self.lp, self.state))

    def run(self, c, a, b, x0, y0, active, iters: int):
        guard = None
        for dst, src in ((self.c, c), (self.b, b), (self.x0, x0),
                         (self.y0, y0), (self.active, active)):
            if dst is not None:
                dst.copy_(src)
        if self.kernel:
            _, guard = pack_rows(a, out=self.rows)
        else:
            self.rows.copy_(a)
        if self.parts is None:
            bsz, dev = self.c.shape[0], self.c.device
            keep = ((lambda: gemv_kernel._run_counts(dev, bsz)),) \
                if self.kernel else ()
            self.parts = ipm_graph.capture(
                {"start": self._start, "boundary": self._boundary,
                 "chunk": self._chunk, "finish": self._finish}, dev, keep)
        parts = self.parts
        ipm_graph.replay(parts["start"])
        ipm_graph.replay(parts["boundary"])
        go = (_first_read(self.go, guard) if guard is not None
              else _poll(self.go))
        n_chunks = -(-iters // self.check_every)
        for k in range(n_chunks):
            if not go:
                break
            ipm_graph.replay(parts["chunk"])
            if k + 1 == n_chunks:
                break
            ipm_graph.replay(parts["boundary"])
            go = _poll(self.go)
        ipm_graph.replay(parts["finish"])
        return tuple(v.clone() for v in self.out)


# one per solve shape, for the life of the process (AGC-ALP: one per row
# tier and batch width)
_graph_solves: dict[tuple, _GraphSolve] = {}


@spanned("lp.solve")
def ipm_box_lp(c, a_rows, b, iters: int = 35, tol: float = 1e-6,
               active=None, delta: float = 1e-6, check_every: int = 5,
               x0=None, y0=None, warm_shift: float = 1e-2,
               factor_backend: str = "auto", stall_ratio: float = 0.8,
               matvec_backend: str = "auto", graphs: bool | None = None):
    """Mehrotra predictor-corrector IPM, batched over lanes.

    c (B, n); a_rows (B, R, n) (a row slice of a larger buffer is fine);
    b (B, R); ``active`` optional (B,) bool: inactive lanes are left out of
    the stop test and read err 0 (their iterates still step; callers discard
    them). ``x0``/``y0``: a shifted warm start from a previous solution,
    pulled ``warm_shift`` into the interior. ``graphs``: replay the solve's
    captured CUDA graphs (None: on a CUDA tensor with the blocked factor;
    True on a CPU tensor or with the plain factor raises) or run the eager
    loop (False).

    Runs ``check_every``-step chunks, at most ``iters`` steps, while some
    active lane is above ``tol`` in max(mu, |r_p|, |r_d|) and has not
    plateaued: a lane plateaus (and stays so) after two chunk boundaries in
    a row that each fail to bring its error below ``stall_ratio`` times its
    running minimum. A lane whose Newton direction is not finite (its
    factorization broke down) keeps its iterate.

    Returns (x (B, n), y (B, R) duals of A x <= b in the caller's units,
    err (B,) = max(primal violation, relative duality gap)).
    """
    require_full_f32("ipm_box_lp")
    dev = a_rows.device
    on_cuda = dev.type == "cuda"
    if matvec_backend not in MATVEC_BACKENDS:
        raise ValueError(f"unknown matvec_backend {matvec_backend!r}; "
                         f"known: {MATVEC_BACKENDS}")
    if factor_backend not in FACTOR_BACKENDS:
        raise ValueError(f"unknown factor_backend {factor_backend!r}; "
                         f"known: {FACTOR_BACKENDS}")
    if iters < 1 or check_every < 1:
        raise ValueError(f"iters ({iters}) and check_every ({check_every}) "
                         f"must be >= 1")
    if graphs and not on_cuda:
        raise ValueError(f"ipm_box_lp: graphs=True needs a CUDA tensor, got "
                         f"{dev}")
    if matvec_backend == "auto":
        matvec_backend = "kernel" if on_cuda else "xla"
    if factor_backend == "auto":
        factor_backend = "blocked" if on_cuda else "xla"
    kernel, blocked = matvec_backend == "kernel", factor_backend == "blocked"
    if graphs and not blocked:
        raise ValueError("ipm_box_lp: graphs=True needs factor_backend "
                         "'blocked': the plain factor's cholesky_solve (MAGMA "
                         "on CUDA) cannot be captured")
    bsz, r_cap, n = a_rows.shape
    if (on_cuda and blocked if graphs is None else graphs) and bsz:
        key = (dev.index, bsz, r_cap, n, kernel, blocked, x0 is not None,
               y0 is not None, active is not None, delta, check_every, tol,
               stall_ratio, warm_shift)
        solve = _graph_solves.get(key)
        if solve is None:
            solve = _graph_solves[key] = _GraphSolve(dev, *key[1:])
        return solve.run(c, a_rows, b, x0, y0, active, iters)

    c = c.to(_F32)
    a = a_rows.to(_F32)
    guard = None
    rows = a
    if kernel:
        rows, guard = pack_rows(a)
    cscale, cs, row_on, be = _scaled(c, b.to(_F32), rows, n)
    lp = _Lp(*_products(rows, n, delta, kernel), blocked, cs=cs, be=be,
             row_on=row_on, cscale=cscale, active=active,
             n_compl=_const(float(r_cap + 2 * n), dev), tol=tol,
             stall_ratio=stall_ratio)
    state = _start(lp, None if x0 is None else x0.to(_F32),
                   None if y0 is None else y0.to(_F32), warm_shift)
    best_err = torch.full((bsz,), float("inf"), dtype=_F32, device=dev)
    stall_cnt = torch.zeros((bsz,), dtype=torch.int32, device=dev)
    for _ in range(-(-iters // check_every)):
        state, best_err, stall_cnt, go = _boundary(lp, state, best_err,
                                                   stall_cnt)
        go = _first_read(go, guard) if guard is not None else _poll(go)
        guard = None
        if not go:
            break
        for _ in range(check_every):
            state = _newton(lp, state)
    return _certificate(lp, state)
