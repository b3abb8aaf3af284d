"""Plain PyTorch twins of the IPM Newton step's hand-written kernels
(``csrc/ipm_step.cu``, wrapped by :mod:`.ipm_kernel`, and the right-hand
side that ``csrc/gemv.cu``'s A^T y forms in its epilogue).

JAX has no Pallas kernel here: XLA fuses the same elementwise work of
``ldpc_tpu/ops/ipm_solver.py``'s ``newton`` (``:165-267``): the residuals
and mu, the diagonal scalings, each direction's targets, right-hand side
and back-substitution, the step lengths (``_pos_step`` at ``:39``), mu_aff
and sigma, and the masked update with its interior clamp. These twins are
the eager ops the port ran before the kernels existed, unchanged, split
where the kernels split the step: :func:`.ipm_solver.ipm_box_lp` reaches
them through the wrappers on a CPU tensor; on the card the tests and
``chip_smoke.py`` hold the kernels to them, bit for bit in every
elementwise output and to float32 rounding in the per-lane sums (mu,
mu_aff).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["DIAG_HI", "DIAG_LO", "FLOOR", "FRAC", "MU_FLOOR", "Terms",
           "affine_mu_ref", "corrector_targets_ref", "directions_ref",
           "ipm_correct_ref", "ipm_predict_ref", "ipm_prep_ref",
           "ipm_step_len_ref", "ipm_update_ref", "newton_rhs_ref",
           "residuals_ref", "targets_ref"]

FRAC = 0.995     # fraction to the boundary of a step
FLOOR = 1e-12    # keeps the iterate strictly interior in float32
DIAG_LO = 1e-10  # the clamp of the diagonal scalings y / s, zl / x, zu / w
DIAG_HI = 1e10
MU_FLOOR = 1e-12  # mu's floor in sigma's ratio


class Terms(NamedTuple):
    """What one launch of a Newton step passes to the next: the prep's
    residuals, mu and scalings, and one direction's targets (the
    predictor's from the prep, the corrector's from the predict) with v,
    the input of A^T in its right-hand side."""
    rp: torch.Tensor    # (B, T) A x + s - b
    rd: torch.Tensor    # (B, n) c + A^T y - zl + zu
    mu: torch.Tensor    # (B,) the complementarity
    dy_s: torch.Tensor  # (B, T) y / s, clamped
    dxl: torch.Tensor   # (B, n) zl / x, clamped
    dxu: torch.Tensor   # (B, n) zu / w, clamped
    dxx: torch.Tensor   # (B, n) dxl + dxu: the normal matrix's diagonal
    ry: torch.Tensor    # (B, T) the targets
    rl: torch.Tensor    # (B, n)
    ru: torch.Tensor    # (B, n)
    v: torch.Tensor     # (B, T) ry + dy_s rp


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


def residuals_ref(state, aty, cs, be, n_compl):
    """(rp, rd, mu) of ``state`` (x, w, s, y, zl, zu, ax) given A^T y, the
    scaled objective ``cs`` (B, n), the rhs ``be`` (B, T) and ``n_compl``
    (0-d: R + 2n)."""
    x, w, s, y, zl, zu, ax = state
    rp = ax + s - be                                             # (B, R)
    rd = cs + aty - zl + zu                                      # (B, n)
    mu = ((y * s).sum(dim=-1) + (zl * x).sum(dim=-1)
          + (zu * w).sum(dim=-1)) / n_compl                      # (B,)
    return rp, rd, mu


def targets_ref(state, sig_mu, extra_y, extra_l, extra_u, dy_s, rp):
    """A direction's targets for y s -> sig_mu - extra_y (and so on):
    (ry, rl, ru, v = ry + dy_s rp)."""
    x, w, s, y, zl, zu, _ = state
    ry = (sig_mu[:, None] - extra_y) / s - y
    rl = (sig_mu[:, None] - extra_l) / x - zl
    ru = (sig_mu[:, None] - extra_u) / w - zu
    return ry, rl, ru, ry + dy_s * rp


def ipm_prep_ref(state, aty, cs, be, n_compl) -> Terms:
    """The Newton step's first part: the residuals and mu, the diagonal
    scalings, and the predictor's targets (sigma = 0: (0 - 0) / s - y, and
    so on)."""
    x, w, s, y, zl, zu, _ = state
    rp, rd, mu = residuals_ref(state, aty, cs, be, n_compl)
    dy_s = (y / s).clamp(DIAG_LO, DIAG_HI)                       # (B, R)
    dxl = (zl / x).clamp(DIAG_LO, DIAG_HI)
    dxu = (zu / w).clamp(DIAG_LO, DIAG_HI)
    zero_r, zero_n = torch.zeros_like(y), torch.zeros_like(x)
    targets = targets_ref(state, torch.zeros((x.shape[0],), dtype=x.dtype,
                                             device=x.device),
                          zero_r, zero_n, zero_n, dy_s, rp)
    return Terms(rp, rd, mu, dy_s, dxl, dxu, dxl + dxu, *targets)


def newton_rhs_ref(rd, atv, rl, ru):
    """A direction's right-hand side, given A^T v."""
    return -rd - atv + rl - ru


def directions_ref(terms: Terms, dx, adx):
    """(dx, dy, ds, dzl, dzu, A dx) of a direction from its dx and A dx."""
    ds = -terms.rp - adx
    dy = terms.ry - terms.dy_s * ds
    dzl = terms.rl - terms.dxl * dx
    dzu = terms.ru + terms.dxu * dx
    return dx, dy, ds, dzl, dzu, adx


def affine_mu_ref(state, dirs, ap, ad, n_compl):
    """mu_aff (B,): the complementarity after the predictor's step."""
    x, w, s, y, zl, zu, _ = state
    dxa, dya, dsa, dzla, dzua, _ = dirs
    ap_, ad_ = ap[:, None], ad[:, None]
    return (((y + ad_ * dya) * (s + ap_ * dsa)).sum(dim=-1)
            + ((zl + ad_ * dzla) * (x + ap_ * dxa)).sum(dim=-1)
            + ((zu + ad_ * dzua) * (w - ap_ * dxa)).sum(dim=-1)
            ) / n_compl


def corrector_targets_ref(state, terms: Terms, dirs, mu_aff):
    """The corrector's (ry, rl, ru, v) from the predictor's directions and
    mu_aff: sigma = (mu_aff / mu)^3 clamped to [0, 1], the targets
    sigma mu - dy ds, ..."""
    dxa, dya, dsa, dzla, dzua, _ = dirs
    ratio = mu_aff / terms.mu.clamp_min(MU_FLOOR)
    sigma = (ratio * (ratio * ratio)).clamp(0.0, 1.0)
    return targets_ref(state, sigma * terms.mu, dya * dsa, dzla * dxa,
                       -dzua * dxa, terms.dy_s, terms.rp)


def ipm_predict_ref(state, terms: Terms, dx, adx, n_compl):
    """The predictor's directions from its dx and A dx, its step lengths,
    mu_aff and the corrector's targets. Returns (``terms`` with the
    corrector's ry, rl, ru and v, ap, ad, mu_aff)."""
    x, w, s, y, zl, zu, _ = state
    dirs = directions_ref(terms, dx, adx)
    dxa, dya, dsa, dzla, dzua, _ = dirs
    ap, ad = ipm_step_len_ref(s, dsa, x, dxa, w, y, dya, zl, dzla, zu, dzua)
    mu_aff = affine_mu_ref(state, dirs, ap, ad, n_compl)
    ry, rl, ru, v = corrector_targets_ref(state, terms, dirs, mu_aff)
    return terms._replace(ry=ry, rl=rl, ru=ru, v=v), ap, ad, mu_aff


def ipm_correct_ref(state, terms: Terms, dx, adx):
    """The corrector's directions from its dx and A dx, its step lengths
    and the masked update. Returns (the new state, ap, ad)."""
    x, w, s, y, zl, zu, _ = state
    dirs = directions_ref(terms, dx, adx)
    dx, dy, ds, dzl, dzu, _ = dirs
    ap, ad = ipm_step_len_ref(s, ds, x, dx, w, y, dy, zl, dzl, zu, dzu)
    return ipm_update_ref(state, dirs, ap, ad), ap, ad
