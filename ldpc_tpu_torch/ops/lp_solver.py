"""Batched first-order LP solver (PDHG / Chambolle-Pock) for LP decoding
(counterpart of ``ldpc_tpu/ops/lp_solver.py``).

    min  c^T x   s.t.  A x <= b,  0 <= x <= 1

    x_{k+1} = clip_[0,1](x_k - tau (c + A^T y_k))
    y_{k+1} = max(0,  y_k + sigma (A (2 x_{k+1} - x_k) - b))

with diagonal preconditioners from the active constraint rows. Constraints
are dense signed rows (B, R, n), one matrix per lane; inactive rows are all
zero with rhs 0, which keeps their duals at 0.

Three solvers:

* :func:`pdhg_box_lp`, the plain one (the JAX package's ``"xla"`` backend):
  batched ``torch.bmm`` matvecs, two per step;
* :func:`pdhg_box_lp_fused`, which runs each ``check_every``-step chunk as
  one call of :func:`..ops.pdhg_kernel.pdhg_chunk` (the CUDA kernel on a CUDA
  tensor, its plain twin on a CPU tensor);
* :func:`pdhg_box_lp_shared`, fixed-iteration PDHG with one (R, n) matrix
  shared by the batch (Full LP): its two products are plain GEMMs, as in the
  JAX package, which computes them outside any Pallas kernel.

JAX's ``fori_loop(cond(...))`` chunk loop is a Python loop here: before each
chunk the host reads the batch-max error, one device sync per chunk (at most
``ceil(iters / check_every)`` per solve; ALP's 2048/64 budget gives 32). A
chunk that does not run leaves the carry unchanged, so no later chunk can run
either and the loop leaves at the first one. The stop tests are evaluated in
float32, as JAX evaluates them on the device.
"""
from __future__ import annotations

import numpy as np
import torch

from .pdhg_kernel import pdhg_chunk
from .pdhg_ref import lane_err, pdhg_step

__all__ = ["pdhg_box_lp", "pdhg_box_lp_fused", "pdhg_box_lp_shared",
           "pdhg_steps", "require_full_f32"]


def require_full_f32(caller: str) -> None:
    """Raise unless float32 matmuls run in full float32: TF32 would
    silently change every product."""
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            f"{caller} needs full float32 matmuls: set "
            "torch.backends.cuda.matmul.allow_tf32 = False and "
            "torch.set_float32_matmul_precision('highest')")


def pdhg_steps(a_rows: torch.Tensor, safety: float = 0.95,
               omega: float = 1.0):
    """Diagonal (Pock-Chambolle alpha=1) preconditioners, per lane.

    tau_j = safety * omega / sum_i |A_ij|  (primal, (B, n));
    sigma_i = safety / (omega * sum_j |A_ij|) (dual, (B, R)).
    Empty columns get tau = safety * omega (the column sum is floored at 1)
    and empty rows sigma = 0, so a zero row's dual never moves. ``omega`` is
    the PDLP-style primal weight (tau * sigma is invariant to it).
    """
    abs_a = a_rows.abs()
    row_sum = abs_a.sum(dim=-1)                          # (B, R)
    col_sum = abs_a.sum(dim=-2)                          # (B, n)
    # a tensor numerator: ``scalar / tensor`` in torch is reciprocal-times,
    # which rounds differently from JAX's one division (a fill, not a
    # host-to-device copy, so no stream sync)
    num_tau = torch.full((), safety * omega, dtype=torch.float32,
                         device=a_rows.device)
    num_sigma = torch.full((), safety / omega, dtype=torch.float32,
                           device=a_rows.device)
    tau = num_tau / col_sum.clamp_min(1.0)
    sigma = torch.where(row_sum > 0, num_sigma / row_sum.clamp_min(1e-6),
                        0.0)
    return tau, sigma


def _go(vmax: np.float32, vprev: np.float32, tol: float,
        stall_ratio: float | None) -> bool:
    """The chunk loop's run test, in float32 as on the device."""
    go = vmax > np.float32(tol)
    if stall_ratio is not None:
        go &= bool((vmax < np.float32(stall_ratio) * vprev)
                   or not np.isfinite(vprev))
    return bool(go)


def _host_max(v: torch.Tensor) -> np.float32:
    return np.float32(v.max().item())


def pdhg_box_lp(c, a_rows, b, x0, y0, iters: int, safety: float = 0.95,
                tol: float | None = None, check_every: int = 200,
                active=None, stall_ratio: float | None = None,
                average: bool = False, omega: float = 1.0):
    """Preconditioned PDHG steps, optionally tolerance-driven.
    Shapes: c, x0 (B, n); a_rows (B, R, n); b, y0 (B, R).

    With ``tol`` None: ``iters`` steps, returns (x, y). With ``tol`` set: runs
    ``check_every``-step chunks (at most ``ceil(iters / check_every)``) while
    the batch-max error exceeds ``tol`` and, with ``stall_ratio``, while it
    still improves by more than ``1 - stall_ratio`` per chunk; returns
    (x, y, err) with ``err`` the per-lane (B,) max(primal violation, relative
    duality gap), starting from the error of (x0, y0). ``active``: optional
    (B,) bool; inactive lanes read err 0 (their x, y still step; callers
    discard them). ``average``: per chunk, keep per lane whichever of the
    last iterate and the chunk's ergodic mean has the smaller error.
    """
    tau, sigma = pdhg_steps(a_rows, safety, omega)
    x, y = x0, y0
    if tol is None:
        for _ in range(iters):
            x, y = pdhg_step(c, a_rows, b, tau, sigma, x, y)
        return x, y

    def err(x, y):
        v = lane_err(c, a_rows, b, x, y)
        return v if active is None else torch.where(active, v, 0.0)

    v = err(x, y)
    vprev = np.float32(np.inf)
    for _ in range(-(-iters // check_every)):
        vmax = _host_max(v)
        if not _go(vmax, vprev, tol, stall_ratio):
            break
        if average:
            sx, sy = torch.zeros_like(x), torch.zeros_like(y)
            for _ in range(check_every):
                x, y = pdhg_step(c, a_rows, b, tau, sigma, x, y)
                sx = sx + x
                sy = sy + y
            xa, ya = sx / check_every, sy / check_every
            v_last, v_avg = err(x, y), err(xa, ya)
            take = v_avg < v_last
            x = torch.where(take[:, None], xa, x)
            y = torch.where(take[:, None], ya, y)
            v = torch.minimum(v_avg, v_last)
        else:
            for _ in range(check_every):
                x, y = pdhg_step(c, a_rows, b, tau, sigma, x, y)
            v = err(x, y)
        vprev = vmax
    return x, y, v


def _refuse_rows(outside) -> None:
    if outside:
        raise ValueError("pdhg_box_lp_fused: the kernel needs cut rows with "
                         "entries in {-1, 0, 1}")


def pdhg_box_lp_fused(c, a_rows, b, x0, y0, iters: int, safety: float = 0.95,
                      tol: float = 1e-4, check_every: int = 200,
                      active=None, stall_ratio: float | None = None,
                      average: bool = False, omega: float = 1.0):
    """Tolerance-driven PDHG whose chunks are :func:`pdhg_chunk` calls.

    Same arguments and (x, y, err) return as ``pdhg_box_lp(tol=...)``; any
    row count the kernel's shared memory holds. The error starts at +inf, so
    the first chunk always runs (no host read before it); inactive lanes'
    errors are zeroed. ``a_rows`` may be a row slice of a larger per-lane
    buffer (lane stride > R * n); ``b`` and ``y0`` are made contiguous once
    per solve.

    The kernel holds the rows as int8, exact for entries in {-1, 0, 1}: the
    first chunk reports any other entry of an active lane, and the solve
    raises ``ValueError`` on it. The report is read with the host read the
    loop makes before its second chunk (after the loop when only one chunk
    was to run).
    """
    tau, sigma = pdhg_steps(a_rows, safety, omega)
    x, y = x0.contiguous(), y0.contiguous()
    b = b.contiguous()
    v = guard = None
    vprev = np.float32(np.inf)
    for _ in range(-(-iters // check_every)):
        if v is None:
            vmax = np.float32(np.inf)
        elif guard is None:
            vmax = _host_max(v)
        else:                       # one host read for both values
            vmax, outside = torch.stack((v.max(), guard.any().to(v.dtype))
                                        ).tolist()
            vmax, guard = np.float32(vmax), None
            _refuse_rows(outside)
        if not _go(vmax, vprev, tol, stall_ratio):
            break
        first = v is None
        x, y, v, outside = pdhg_chunk(c, a_rows, b, tau, sigma, x, y,
                                      check_every, active=active,
                                      average=average)
        if first:                   # the rows are the same in every chunk
            guard = outside
        if active is not None:
            v = torch.where(active, v, 0.0)
        vprev = vmax
    if guard is not None:
        _refuse_rows(guard.any().item())
    if v is None:
        v = torch.full((a_rows.shape[0],), float("inf"),
                       dtype=torch.float32, device=a_rows.device)
    return x, y, v


def pdhg_box_lp_shared(c, a, b, x0, y0, iters: int, safety: float = 0.95):
    """``iters`` preconditioned PDHG steps with a constraint matrix shared
    by the batch (``ldpc_tpu/ops/lp_solver.py:204-223``).

    c, x0 (B, n); a (R, n); b (R,); y0 (B, R). Returns (x, y). The products
    ``y @ a`` and ``(2 x' - x) @ a.T`` are GEMMs in full float32 (TF32 is
    refused); the loop reads nothing back to the host.
    """
    require_full_f32("pdhg_box_lp_shared")
    abs_a = a.abs()
    # tensor numerators: ``scalar / tensor`` is reciprocal-times in torch
    num = torch.full((), safety, dtype=torch.float32, device=a.device)
    tau = num / abs_a.sum(dim=0).clamp_min(1.0)                 # (n,)
    row_sum = abs_a.sum(dim=1)                                  # (R,)
    sigma = torch.where(row_sum > 0, num / row_sum.clamp_min(1e-6), 0.0)
    a_t = a.t()
    x, y = x0, y0
    for _ in range(iters):
        x_new = (x - tau * (c + y @ a)).clamp(0.0, 1.0)
        y = (y + sigma * ((2.0 * x_new - x) @ a_t - b)).clamp_min(0.0)
        x = x_new
    return x, y
