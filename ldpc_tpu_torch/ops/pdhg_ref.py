"""Plain PyTorch PDHG chunk, the twin of the kernel ``csrc/pdhg_chunk.cu``.

What ``ldpc_tpu/ops/pallas/pdhg_kernel.py`` (``_kernel``) computes, per lane:
``iters`` preconditioned PDHG steps on

    min c.x  s.t.  A x <= b,  0 <= x <= 1

    x <- clip_[0,1](x - tau * (c + A^T y))
    y <- max(0, y + sigma * (A (2x' - x) - b))

then the lane's combined error ``max(max(A x - b, 0), relative duality
gap)``; with ``average`` also the chunk's ergodic mean, kept per lane when its
error is smaller (PDLP-style restart to the average).

``active`` is per lane: an inactive lane's x and y pass through bit for bit
and its error reads 0. The TPU kernel skips by lane *group* and still steps
inactive lanes inside an active group (``pdhg_kernel.py:101-108``). The
decoder's outputs are the same either way: ``_round_body`` discards frozen
lanes' x and y (``ldpc_tpu/decoders/alp.py:387-389``) and
``pdhg_box_lp_fused`` zeroes their error (``ldpc_tpu/ops/lp_solver.py:187-188``).

The matvecs are ``torch.bmm`` in float32 (no TF32); the kernel sums in
another order, so the two agree to float32 rounding, not bit for bit.
"""
from __future__ import annotations

import torch

__all__ = ["lane_err", "pdhg_step", "pdhg_chunk_ref"]


def _at_y(a: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """A^T y per lane: a (B, T, n), y (B, T) -> (B, n)."""
    return torch.bmm(y.unsqueeze(1), a).squeeze(1)


def _a_x(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A x per lane: a (B, T, n), x (B, n) -> (B, T)."""
    return torch.bmm(a, x.unsqueeze(-1)).squeeze(-1)


def pdhg_step(c, a, b, tau, sigma, x, y):
    """One PDHG step for every lane; returns (x', y')."""
    x_new = (x - tau * (c + _at_y(a, y))).clamp(0.0, 1.0)
    y_new = (y + sigma * (_a_x(a, 2.0 * x_new - x) - b)).clamp_min(0.0)
    return x_new, y_new


def lane_err(c, a, b, x, y) -> torch.Tensor:
    """Per-lane max(primal violation, relative duality gap), (B,).

    Primal feasibility alone is not enough: a warm-started iterate can be
    feasible long before it is optimal, and the ALP cut search at such a
    point emits cuts that do not separate the LP optimum."""
    viol = (_a_x(a, x) - b).clamp_min(0.0).amax(dim=-1)
    rc = c + _at_y(a, y)
    pobj = (c * x).sum(dim=-1)
    dobj = -(b * y).sum(dim=-1) + rc.clamp_max(0.0).sum(dim=-1)
    gap = (pobj - dobj) / (1.0 + pobj.abs() + dobj.abs())
    return torch.maximum(viol, gap)


def pdhg_chunk_ref(c, a, b, tau, sigma, x, y, iters: int, active=None,
                   average: bool = False):
    """``iters`` PDHG steps per lane and the lane's error at the end.

    c, tau, x: (B, n) f32; a: (B, T, n) f32; b, sigma, y: (B, T) f32;
    ``active``: optional (B,) bool. Returns (x', y', err (B,)).
    """
    if iters < 1:
        raise ValueError(f"pdhg_chunk_ref: iters must be >= 1, got {iters}")
    if a.shape[1] < 1:
        raise ValueError("pdhg_chunk_ref: the row slice is empty")
    x0, y0 = x, y
    sx = torch.zeros_like(x) if average else None
    sy = torch.zeros_like(y) if average else None
    for _ in range(iters):
        x, y = pdhg_step(c, a, b, tau, sigma, x, y)
        if average:
            sx = sx + x
            sy = sy + y
    err = lane_err(c, a, b, x, y)
    if average:
        inv = 1.0 / float(iters)
        xa, ya = sx * inv, sy * inv
        err_avg = lane_err(c, a, b, xa, ya)
        take = err_avg < err
        x = torch.where(take[:, None], xa, x)
        y = torch.where(take[:, None], ya, y)
        err = torch.minimum(err_avg, err)
    if active is not None:
        x = torch.where(active[:, None], x, x0)
        y = torch.where(active[:, None], y, y0)
        err = torch.where(active, err, 0.0)
    return x, y, err
