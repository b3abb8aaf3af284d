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
  ``csrc/normal_build.cu`` on a CUDA tensor, the same twins on a CPU tensor);
* ``factor_backend``: ``"xla"`` is ``torch.linalg.cholesky_ex`` +
  ``cholesky_solve`` with the NaN rule of :func:`.chol_ref.cholesky_nan`;
  ``"blocked"`` is :mod:`.chol` (its diagonal step ``csrc/chol_diag_inv.cu``
  on CUDA);
* ``"auto"`` is ``"kernel"``/``"blocked"`` on CUDA and ``"xla"``/``"xla"``
  on the CPU.

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
the host reads one flag, whether any lane still has to step: one device sync
per chunk, at most 8 per solve. A chunk that does not step leaves the state
unchanged, so the flag stays false and leaving the loop at the first false
one is exact.
"""
from __future__ import annotations

import torch

from .chol import blocked_cho_solve, blocked_cholesky
from .chol_ref import cholesky_nan
from .gemv_kernel import batched_gemv, batched_gemv_t, normal_build
from .gemv_ref import gemv_ref, gemv_t_ref, normal_ref

__all__ = ["FACTOR_BACKENDS", "MATVEC_BACKENDS", "ipm_box_lp"]

MATVEC_BACKENDS = ("auto", "xla", "kernel")
FACTOR_BACKENDS = ("auto", "xla", "blocked")


def _pos_step(v, dv, frac: float = 0.995):
    """Largest alpha in (0, 1] with v + alpha dv >= (1 - frac) v, per lane
    (v > 0 assumed). Returns (B,)."""
    neg = dv < 0
    ratio = torch.where(neg, -v / torch.where(neg, dv, -1.0), float("inf"))
    amax = ratio.reshape(ratio.shape[0], -1).amin(dim=-1)
    return torch.clamp_max(frac * amax, 1.0)


def _check_precision() -> None:
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            "ipm_box_lp needs full float32 matmuls: set "
            "torch.backends.cuda.matmul.allow_tf32 = False and "
            "torch.set_float32_matmul_precision('highest')")


def ipm_box_lp(c, a_rows, b, iters: int = 35, tol: float = 1e-6,
               active=None, delta: float = 1e-6, check_every: int = 5,
               x0=None, y0=None, warm_shift: float = 1e-2,
               factor_backend: str = "auto", stall_ratio: float = 0.8,
               matvec_backend: str = "auto"):
    """Mehrotra predictor-corrector IPM, batched over lanes.

    c (B, n); a_rows (B, R, n) (a row slice of a larger buffer is fine);
    b (B, R); ``active`` optional (B,) bool: inactive lanes are left out of
    the stop test and read err 0 (their iterates still step; callers discard
    them). ``x0``/``y0``: a shifted warm start from a previous solution,
    pulled ``warm_shift`` into the interior.

    Runs ``check_every``-step chunks, at most ``iters`` steps, while some
    active lane is above ``tol`` in max(mu, |r_p|, |r_d|) and has not
    plateaued: a lane plateaus (and stays so) after two chunk boundaries in
    a row that each fail to bring its error below ``stall_ratio`` times its
    running minimum. A lane whose Newton direction is not finite (its
    factorization broke down) keeps its iterate.

    Returns (x (B, n), y (B, R) duals of A x <= b in the caller's units,
    err (B,) = max(primal violation, relative duality gap)).
    """
    _check_precision()
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
    if matvec_backend == "auto":
        matvec_backend = "kernel" if on_cuda else "xla"
    if factor_backend == "auto":
        factor_backend = "blocked" if on_cuda else "xla"
    bsz, r_cap, n = a_rows.shape
    f32 = torch.float32
    c = c.to(f32)
    a = a_rows.to(f32)

    if matvec_backend == "kernel":
        def mv(v):
            return batched_gemv(a, v.contiguous())

        def mvt(v):
            return batched_gemv_t(a, v.contiguous())

        def normal(d, dxx):
            return normal_build(a, d.contiguous(), dxx.contiguous(), delta)
    else:
        def mv(v):
            return gemv_ref(a, v)

        def mvt(v):
            return gemv_t_ref(a, v)

        def normal(d, dxx):
            return normal_ref(a, d, dxx, delta)

    def const(v: float) -> torch.Tensor:
        # a device fill, not a host-to-device copy: no stream sync
        return torch.full((), v, dtype=f32, device=dev)

    # per-lane objective scaling for conditioning (argmin-invariant)
    cscale = c.abs().mean(dim=-1, keepdim=True).clamp_min(1e-6)
    cs = c / cscale

    # benign rhs for all-zero rows: the slack stays at 2n, the dual -> ~0
    row_on = (a != 0).any(dim=-1)                                # (B, R)
    be = torch.where(row_on, b.to(f32), const(2.0 * n))

    if x0 is not None:
        x = x0.to(f32).clamp(warm_shift, 1.0 - warm_shift)
    else:
        x = torch.full((bsz, n), 0.5, dtype=f32, device=dev)
    w = 1.0 - x
    ax = mv(x)
    s = (be - ax).clamp_min(warm_shift if x0 is not None else 1.0)
    if y0 is not None:
        y = (y0.to(f32) / cscale.clamp_min(1e-6)).clamp_min(warm_shift)
        rc0 = cs + mvt(y)
        zl = rc0.clamp_min(warm_shift)
        zu = (-rc0).clamp_min(warm_shift)
    else:
        y = torch.ones((bsz, r_cap), dtype=f32, device=dev)
        zl = 1.0 + cs.clamp_min(0.0)
        zu = 1.0 + (-cs).clamp_min(0.0)

    n_compl = const(float(r_cap + 2 * n))

    def residuals(ax, x, w, s, y, zl, zu):
        rp = ax + s - be                                         # (B, R)
        rd = cs + mvt(y) - zl + zu                               # (B, n)
        mu = ((y * s).sum(dim=-1) + (zl * x).sum(dim=-1)
              + (zu * w).sum(dim=-1)) / n_compl                  # (B,)
        return rp, rd, mu

    def newton(state):
        x, w, s, y, zl, zu, ax = state
        rp, rd, mu = residuals(ax, x, w, s, y, zl, zu)
        dy_s = (y / s).clamp(1e-10, 1e10)                        # (B, R)
        dxl = (zl / x).clamp(1e-10, 1e10)
        dxu = (zu / w).clamp(1e-10, 1e10)
        m = normal(dy_s, dxl + dxu)
        if factor_backend == "blocked":
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
            rhs = -rd - mvt(ry + dy_s * rp) + rl - ru
            dx = m_solve(rhs)
            adx = mv(dx)
            ds = -rp - adx
            dy = ry - dy_s * ds
            dzl = rl - dxl * dx
            dzu = ru + dxu * dx
            return dx, dy, ds, dzl, dzu, adx

        zero_r, zero_n = torch.zeros_like(y), torch.zeros_like(x)
        # predictor (affine scaling, sigma = 0)
        dxa, dya, dsa, dzla, dzua, _ = solve_dir(
            torch.zeros((bsz,), dtype=f32, device=dev), zero_r, zero_n,
            zero_n)
        ap = torch.minimum(_pos_step(s, dsa),
                           torch.minimum(_pos_step(x, dxa),
                                         _pos_step(w, -dxa)))
        ad = torch.minimum(_pos_step(y, dya),
                           torch.minimum(_pos_step(zl, dzla),
                                         _pos_step(zu, dzua)))
        ap_, ad_ = ap[:, None], ad[:, None]
        mu_aff = (((y + ad_ * dya) * (s + ap_ * dsa)).sum(dim=-1)
                  + ((zl + ad_ * dzla) * (x + ap_ * dxa)).sum(dim=-1)
                  + ((zu + ad_ * dzua) * (w - ap_ * dxa)).sum(dim=-1)
                  ) / n_compl
        ratio = mu_aff / mu.clamp_min(1e-12)
        sigma = (ratio * (ratio * ratio)).clamp(0.0, 1.0)
        # corrector (reuses the factorization)
        dx, dy, ds, dzl, dzu, adx = solve_dir(
            sigma * mu, dya * dsa, dzla * dxa, -dzua * dxa)
        ap = torch.minimum(_pos_step(s, ds),
                           torch.minimum(_pos_step(x, dx), _pos_step(w, -dx)))
        ad = torch.minimum(_pos_step(y, dy),
                           torch.minimum(_pos_step(zl, dzl),
                                         _pos_step(zu, dzu)))
        # a lane whose factorization broke down (NaN direction) keeps its
        # current, still finite, iterate
        ok = (torch.isfinite(dx).all(dim=-1)
              & torch.isfinite(dy).all(dim=-1))[:, None]
        ap_, ad_ = ap[:, None], ad[:, None]
        # running A x: reuse the corrector's A dx; re-derived exactly at
        # every chunk boundary
        ax = torch.where(ok, ax + ap_ * adx, ax)
        x = torch.where(ok, x + ap_ * dx, x)
        s = torch.where(ok, s + ap_ * ds, s)
        y = torch.where(ok, y + ad_ * dy, y)
        zl = torch.where(ok, zl + ad_ * dzl, zl)
        zu = torch.where(ok, zu + ad_ * dzu, zu)
        # keep strictly interior in float32
        floor = 1e-12
        x = x.clamp(floor, 1.0 - floor)
        w = 1.0 - x
        return (x, w, s.clamp_min(floor), y.clamp_min(floor),
                zl.clamp_min(floor), zu.clamp_min(floor), ax)

    def lane_errs(state):
        x, w, s, y, zl, zu, _ = state
        ax = mv(x)                          # exact refresh of the carry
        rp, rd, mu = residuals(ax, x, w, s, y, zl, zu)
        err = torch.maximum(
            mu, torch.maximum((rp.abs() * row_on).amax(dim=-1),
                              rd.abs().amax(dim=-1)))
        if active is not None:
            err = torch.where(active, err, 0.0)
        return err, ax

    state = (x, w, s, y, zl, zu, ax)
    best_err = torch.full((bsz,), float("inf"), dtype=f32, device=dev)
    stall_cnt = torch.zeros((bsz,), dtype=torch.int32, device=dev)
    for _ in range(-(-iters // check_every)):
        err, ax_fresh = lane_errs(state)
        state = state[:6] + (ax_fresh,)
        # "improving" is judged against the lane's running minimum, and a
        # lane that has stalled twice stays stalled (JAX ipm_solver.py:300-316)
        improving = err < stall_ratio * best_err
        latched = stall_cnt >= 2
        stall_cnt = torch.where(latched, stall_cnt,
                                torch.where(improving, 0, stall_cnt + 1))
        best_err = torch.minimum(best_err, err)
        if not bool(((err > tol) & (stall_cnt < 2)).any()):
            break
        for _ in range(check_every):
            state = newton(state)
    x, w, s, y, zl, zu, _ = state

    # certificate in the caller's (unscaled-c) convention, as pdhg_box_lp's:
    # max(primal violation, relative duality gap)
    ax = mv(x)
    viol = (ax - be).clamp_min(0.0).amax(dim=-1)
    rc = cs + mvt(y)
    pobj = (cs * x).sum(dim=-1)
    dobj = -(be * y * row_on).sum(dim=-1) + rc.clamp_max(0.0).sum(dim=-1)
    gap = (pobj - dobj) / (1.0 + pobj.abs() + dobj.abs())
    err = torch.maximum(viol, gap)
    if active is not None:
        err = torch.where(active, err, 0.0)
    return x, y * cscale, err
