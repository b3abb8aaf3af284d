"""Plain PyTorch twins of the IPM step's two hand-written kernels
(``csrc/ipm_step.cu``, wrapped by :mod:`.ipm_kernel`).

JAX has no Pallas kernel here: XLA fuses the same elementwise work of
``ldpc_tpu/ops/ipm_solver.py``, the step lengths (``_pos_step`` at ``:39``,
used six times per direction at ``:222-227`` and ``:239-243``) and the
masked update with its interior clamp (``:247-267``). These twins are the
eager ops the port ran before the kernels existed, unchanged:
:func:`.ipm_solver.ipm_box_lp` reaches them through the wrappers on a CPU
tensor; on the card the tests and ``chip_smoke.py`` hold the kernels to them
bit for bit.
"""
from __future__ import annotations

import torch

__all__ = ["FLOOR", "FRAC", "ipm_step_len_ref", "ipm_update_ref"]

FRAC = 0.995     # fraction to the boundary of a step
FLOOR = 1e-12    # keeps the iterate strictly interior in float32


def _pos_step(v, dv, frac: float = FRAC):
    """Largest alpha in (0, 1] with v + alpha dv >= (1 - frac) v, per lane
    (v > 0 assumed). Returns (B,)."""
    neg = dv < 0
    ratio = torch.where(neg, -v / torch.where(neg, dv, -1.0), float("inf"))
    amax = ratio.reshape(ratio.shape[0], -1).amin(dim=-1)
    return torch.clamp_max(frac * amax, 1.0)


def ipm_step_len_ref(s, ds, x, dx, w, y, dy, zl, dzl, zu, dzu,
                     frac: float = FRAC):
    """The primal and dual step lengths of a Newton direction: ``ap`` keeps
    s, x and w = 1 - x interior along (ds, dx, -dx), ``ad`` keeps y, zl and
    zu interior along (dy, dzl, dzu). s, ds, y, dy (B, T); the rest (B, n).
    Returns (ap, ad), each (B,)."""
    ap = torch.minimum(_pos_step(s, ds, frac),
                       torch.minimum(_pos_step(x, dx, frac),
                                     _pos_step(w, -dx, frac)))
    ad = torch.minimum(_pos_step(y, dy, frac),
                       torch.minimum(_pos_step(zl, dzl, frac),
                                     _pos_step(zu, dzu, frac)))
    return ap, ad


def ipm_update_ref(state, dirs, ap, ad):
    """One Newton update: ``state`` (x, w, s, y, zl, zu, ax), ``dirs`` (dx,
    dy, ds, dzl, dzu, adx), the step lengths ``ap``, ``ad`` (B,). A lane
    whose dx or dy is not finite (its factorization broke down) keeps its
    iterate; every lane is then clamped strictly interior and w = 1 - x.
    Returns the new state."""
    x, _, s, y, zl, zu, ax = state
    dx, dy, ds, dzl, dzu, adx = dirs
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
    x = x.clamp(FLOOR, 1.0 - FLOOR)
    w = 1.0 - x
    return (x, w, s.clamp_min(FLOOR), y.clamp_min(FLOOR),
            zl.clamp_min(FLOOR), zu.clamp_min(FLOOR), ax)
