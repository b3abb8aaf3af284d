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
  ``csrc/normal_build.cu`` on a CUDA tensor, the same twins on a CPU tensor;
  A^T y forms each direction's right-hand side in its epilogue,
  :func:`.ipm_kernel.newton_rhs`). All three read an int8 copy of the rows
  made once per solve (``pack_rows``), exact for entries in {-1, 0, 1}: the
  solve raises ``ValueError`` on any other entry, read with the first
  chunk's host read;
* ``factor_backend``: ``"xla"`` is ``torch.linalg.cholesky_ex`` +
  ``cholesky_solve`` with the NaN rule of :func:`.chol_ref.cholesky_nan`;
  ``"blocked"`` is :mod:`.chol` (on CUDA the fused factor and solves of
  ``csrc/chol_fused.cu`` up to n = 320, else the chain around
  ``csrc/chol_diag_inv.cu``);
* ``"auto"`` is ``"kernel"``/``"blocked"`` on CUDA and ``"xla"``/``"xla"``
  on the CPU.

The rest of a Newton step, its elementwise and per-lane work (residuals,
mu, scalings, targets, directions, step lengths, mu_aff, sigma, the masked
update), is :mod:`.ipm_kernel`'s prep, predict and correct
(``csrc/ipm_step.cu`` on CUDA, the twins of :mod:`.ipm_ref` on the CPU),
whatever the backends: XLA fuses that work in JAX. On CUDA with the kernel
backends and n <= 320 a Newton step is twelve launches and no PyTorch
operation: A^T y, prep, the normal matrix, the factor, and for each of the
predictor and the corrector the right-hand side, the solve, A dx and
predict or correct.

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

A solve runs in four parts over buffers of its shape (device, lanes, rows,
columns, warm start and mask given, backends and settings; the solve's
inputs are copied in first): the start, a chunk boundary (the lanes'
errors, the stall bookkeeping and the flag), a chunk of ``check_every``
Newton steps and the certificate. One loop (``_Solve.run``) drives them,
with the host reads between them, whether the parts run eager or as CUDA
graphs, so the two give the same bits, host reads and counts.

``graphs`` (None: on a CUDA tensor) runs the solve as JAX runs it, one
device program per part with no per-op dispatch: each part is captured once
per solve shape as a CUDA graph over the shape's buffers
(:mod:`.ipm_graph`; one shape per row tier of AGC-ALP, kept for the life of
the process) and replayed. ``graphs=False`` calls the parts eagerly, on
either device, over buffers made for the call, and so does ``graphs=None``
with ``factor_backend="xla"``: its ``cholesky_solve`` runs MAGMA on CUDA,
which allocates inside the call and cannot be captured. ``graphs=True`` on
a CPU tensor or with that backend raises.

What the parts run must be capturable: no host read, and no
``torch.where`` with a Python number (it copies the number to the card);
``masked_fill`` takes the number as an argument of its kernel.

:data:`COUNTS` counts the solves, the chunks of Newton steps run and each
host read of the chunk loop's flag, on either path and at no host read of
its own; while a profiler records, the spans ``lp.capture`` (a solve
shape's first call, which captures its graphs) and ``lp.copy_in`` (the
inputs copied into its buffers before the replays) name those steps.
"""
from __future__ import annotations

from collections import Counter
from dataclasses import dataclass
from functools import partial
from typing import Callable

import torch

from ..utils.profiling import span, spanned
from . import gemv_kernel, ipm_graph
from .chol import blocked_cho_solve, blocked_cholesky
from .chol_ref import cholesky_nan
from .gemv_kernel import batched_gemv, batched_gemv_t, normal_build, pack_rows
from .gemv_ref import PAD, gemv_ref, gemv_t_ref, normal_ref
from .ipm_kernel import ipm_correct, ipm_predict, ipm_prep, newton_rhs
from .ipm_ref import newton_rhs_ref, residuals_ref
from .lp_solver import require_full_f32

__all__ = ["COUNTS", "FACTOR_BACKENDS", "MATVEC_BACKENDS", "ipm_box_lp",
           "ipm_capture"]

MATVEC_BACKENDS = ("auto", "xla", "kernel")
FACTOR_BACKENDS = ("auto", "xla", "blocked")

_F32 = torch.float32

# the solver's work and host reads, summed over every solve of the process:
# ``solves`` (calls of ipm_box_lp), ``chunks`` (chunks of ``check_every``
# Newton steps run, eager or replayed) and ``reads.poll`` (each host read of
# the loop's flag, the first with the packed copy's guard)
COUNTS: Counter = Counter()


@dataclass
class _Lp:
    """What every part of a solve reads besides the iterate."""
    mv: Callable            # A x
    mvt: Callable           # A^T y
    normal: Callable        # A^T diag(d) A + diag(dxx) + delta I
    rhs: Callable           # -rd - A^T v + rl - ru
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
    """Copy each result into its buffer (an in-place kernel's result
    already is it)."""
    for dst, src in zip(dsts, srcs):
        if src is not dst:
            dst.copy_(src)


def _products(rows, n: int, delta: float, kernel: bool):
    """(A x, A^T y, normal matrix, a Newton direction's right-hand side) on
    ``rows``: the packed int8 copy with the kernel matvecs, else the
    float32 rows with their twins."""
    if kernel:
        def mv(v):
            return batched_gemv(rows, v.contiguous())

        def mvt(v):
            return batched_gemv_t(rows, v.contiguous(), n)

        def normal(d, dxx):
            return normal_build(rows, d.contiguous(), dxx.contiguous(),
                                delta, n)

        def rhs(v, rd, rl, ru):
            return newton_rhs(rows, v.contiguous(), rd, rl, ru, n)
    else:
        def mv(v):
            return gemv_ref(rows, v)

        def mvt(v):
            return gemv_t_ref(rows, v)

        def normal(d, dxx):
            return normal_ref(rows, d, dxx, delta)

        def rhs(v, rd, rl, ru):
            return newton_rhs_ref(rd, gemv_t_ref(rows, v), rl, ru)
    return mv, mvt, normal, rhs


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


def _newton(lp: _Lp, state):
    """One predictor-corrector step; a lane whose direction is not finite
    (its factorization broke down) keeps its current, still finite,
    iterate. Its elementwise and per-lane work is three calls of
    :mod:`.ipm_kernel` (one kernel each on CUDA) around the matvecs, the
    normal matrix, the factor and the two solves: on CUDA with the kernel
    backends twelve launches."""
    # residuals, mu, scalings and the predictor's targets (sigma = 0)
    terms = ipm_prep(state, lp.mvt(state[3]), lp.cs, lp.be, lp.n_compl)
    m = lp.normal(terms.dy_s, terms.dxx)
    if lp.blocked:
        fac = blocked_cholesky(m)

        def m_solve(r):
            return blocked_cho_solve(fac, r)
    else:
        chol = cholesky_nan(m)

        def m_solve(r):
            return torch.cholesky_solve(r.unsqueeze(-1), chol).squeeze(-1)

    def direction(terms):
        """(dx, A dx) of the direction for ``terms``' targets."""
        dx = m_solve(lp.rhs(terms.v, terms.rd, terms.rl,
                            terms.ru)).contiguous()
        return dx, lp.mv(dx)

    # predictor; its step lengths, mu_aff, sigma and the corrector's targets
    terms = ipm_predict(state, terms, *direction(terms), lp.n_compl)[0]
    # corrector (reuses the factorization) and the masked update
    return ipm_correct(state, terms, *direction(terms))[0]


def _boundary(lp: _Lp, state, best_err, stall_cnt):
    """A chunk boundary: the exact refresh of the running A x, each lane's
    error max(mu, |r_p|, |r_d|) (inactive lanes 0), the stall bookkeeping
    and the flag whether any lane still has to step. "Improving" is judged
    against the lane's running minimum, and a lane that has stalled twice
    stays stalled (JAX ipm_solver.py:300-316)."""
    ax = lp.mv(state[0])
    rp, rd, mu = residuals_ref(state[:6] + (ax,), lp.mvt(state[3]), lp.cs,
                               lp.be, lp.n_compl)
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
    COUNTS["reads.poll"] += 1
    return bool(go)


@spanned("lp.poll")
def _first_read(go, guard) -> bool:
    """One host read for the first flag and the packed copy's guard."""
    COUNTS["reads.poll"] += 1
    go, exact = torch.stack((go, guard)).tolist()
    if not exact:
        raise ValueError("ipm_box_lp: the kernel matvecs need cut rows with "
                         "entries in {-1, 0, 1}")
    return go


class _Solve:
    """One solve shape's buffers and its four parts (start, boundary,
    chunk, finish): the inputs copied in before each solve (objective, rhs,
    warm start, mask, the packed or float32 rows), the constants, the
    iterate, the stall bookkeeping, the flag and the outputs. With
    ``graphs`` the parts are captured at first use and replayed, else
    called."""

    def __init__(self, dev, bsz, r_cap, n, kernel, blocked, warm_x, warm_y,
                 masked, delta, check_every, tol, stall_ratio, warm_shift,
                 graphs):
        def buf(*shape, dtype=_F32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        self.n, self.kernel, self.graphs = n, kernel, graphs
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
        self.replays = None

    # the parts: each reads and writes the solve's buffers only
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

    def capture(self) -> bool:
        """Capture the parts, once; returns whether it did now."""
        if self.replays is not None:
            return False
        bsz, dev = self.c.shape[0], self.c.device
        keep = ((lambda: gemv_kernel._run_counts(dev, bsz)),) \
            if self.kernel else ()
        with span("lp.capture"):
            parts = ipm_graph.capture(
                {"start": self._start, "boundary": self._boundary,
                 "chunk": self._chunk, "finish": self._finish}, dev, keep)
        self.replays = tuple(partial(ipm_graph.replay, parts[name]) for name
                             in ("start", "boundary", "chunk", "finish"))
        return True

    def _copy_in(self, c, a, b, x0, y0, active):
        """Copy a solve's inputs into the buffers; returns the packed
        copy's guard (None for the float32 rows)."""
        for dst, src in ((self.c, c), (self.b, b), (self.x0, x0),
                         (self.y0, y0), (self.active, active)):
            if dst is not None:
                dst.copy_(src)
        if not self.kernel:
            self.rows.copy_(a)
            return None
        return pack_rows(a.to(_F32), out=self.rows)[1]

    def run(self, c, a, b, x0, y0, active, iters: int):
        """One solve: copy in, then start, boundary and the first read (with
        the packed copy's guard), chunks with a boundary and a read between
        two, and the certificate."""
        if self.graphs:
            with span("lp.copy_in"):
                guard = self._copy_in(c, a, b, x0, y0, active)
            self.capture()
            start, boundary, chunk, finish = self.replays
        else:
            guard = self._copy_in(c, a, b, x0, y0, active)
            start, boundary, chunk, finish = (self._start, self._boundary,
                                              self._chunk, self._finish)
        start()
        boundary()
        go = (_first_read(self.go, guard) if guard is not None
              else _poll(self.go))
        n_chunks = -(-iters // self.check_every)
        for k in range(n_chunks):
            if not go:
                break
            chunk()
            COUNTS["chunks"] += 1
            if k + 1 == n_chunks:
                break
            boundary()
            go = _poll(self.go)
        finish()
        return tuple(v.clone() for v in self.out) if self.graphs else self.out


# one per solve shape, for the life of the process (AGC-ALP: one per row
# tier and batch width)
_graph_solves: dict[tuple, _Solve] = {}


def _plan(fn, a_rows, iters, tol, active, delta, check_every, warm_x,
          warm_y, warm_shift, factor_backend, stall_ratio, matvec_backend,
          graphs) -> tuple[tuple, bool]:
    """(the solve shape: :class:`_Solve`'s arguments, whether it runs as
    CUDA graphs), the arguments checked."""
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
        raise ValueError(f"{fn}: graphs=True needs a CUDA tensor, got {dev}")
    if matvec_backend == "auto":
        matvec_backend = "kernel" if on_cuda else "xla"
    if factor_backend == "auto":
        factor_backend = "blocked" if on_cuda else "xla"
    kernel, blocked = matvec_backend == "kernel", factor_backend == "blocked"
    if graphs and not blocked:
        raise ValueError(f"{fn}: graphs=True needs factor_backend "
                         f"'blocked': the plain factor's cholesky_solve "
                         f"(MAGMA on CUDA) cannot be captured")
    bsz, r_cap, n = a_rows.shape
    shape = (dev, bsz, r_cap, n, kernel, blocked, warm_x, warm_y,
             active is not None, delta, check_every, tol, stall_ratio,
             warm_shift)
    return shape, bool((on_cuda and blocked if graphs is None else graphs)
                       and bsz)


def _graph_solve(shape: tuple) -> _Solve:
    """The process's solve of ``shape`` as CUDA graphs."""
    solve = _graph_solves.get(shape)
    if solve is None:
        solve = _graph_solves[shape] = _Solve(*shape, graphs=True)
    return solve


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
    shape, graphs = _plan(
        "ipm_box_lp", a_rows, iters, tol, active, delta, check_every,
        x0 is not None, y0 is not None, warm_shift, factor_backend,
        stall_ratio, matvec_backend, graphs)
    COUNTS["solves"] += 1
    solve = _graph_solve(shape) if graphs else _Solve(*shape, graphs=False)
    return solve.run(c, a_rows, b, x0, y0, active, iters)


def ipm_capture(c, a_rows, b, iters: int = 35, tol: float = 1e-6,
                active=None, delta: float = 1e-6, check_every: int = 5,
                x0=None, y0=None, warm_shift: float = 1e-2,
                factor_backend: str = "auto", stall_ratio: float = 0.8,
                matvec_backend: str = "auto",
                graphs: bool | None = None) -> bool:
    """Capture now the CUDA graphs that :func:`ipm_box_lp` would replay for
    the same arguments (their shapes and settings; no value is read), so
    that the shape's first solve replays at once. Solves nothing and moves
    no counter but ``ipm_graph.CAPTURES``. Returns whether it captured:
    False on the eager path and for a shape already captured."""
    require_full_f32("ipm_capture")
    shape, graphs = _plan("ipm_capture", a_rows, iters, tol, active, delta,
                          check_every, x0 is not None, y0 is not None,
                          warm_shift, factor_backend, stall_ratio,
                          matvec_backend, graphs)
    return graphs and _graph_solve(shape).capture()
