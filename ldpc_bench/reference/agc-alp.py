"""Adaptive LP decoding with adaptive cut generation (AGC-ALP), in plain
PyTorch.

The reference decoder's AGC-ALP (acg-alp-ldpc ``algo/agc_alp.h:76-119``)
with the repository's own LP solver, whose constants the configuration file
lists under ``assumed``. Per batch of lanes, starting from the box LP's
optimum (objective: the LLRs tilted by ``perturb`` along a fixed direction),
each round of a lane not done:

1. the H cut search (``alp.h:21-97``, shared with ``alp.py``): every check
   row's most violated odd-set cut, a candidate when its violation exceeds
   ``cut_tol``, appended for lanes below ``max_rows`` cuts into a buffer of
   ``capacity`` rows, duplicates of an active cut skipped by two int32
   hashes, what overflows dropped;
2. lanes that may still add cuts and gained no H cut this round (the
   ``||`` short-circuit of ``agc_alp.h:99-101``) eliminate H over GF(2)
   (``CalculateGauss``, ``agc_alp.h:19-74``): the columns ordered
   fractional first by |u - 0.5| (``gauss_eps`` decides integral), then
   the integral zeros, then the integral ones, each stably; the reduced
   row echelon form of H in that order, its rows in pivot order; and the
   same cut search over its rows, appended the same way;
3. a lane is done when it added no cut and its last solve's error is at
   most ``lp_tol`` or did not fall below ``stall_ratio`` times the round
   before's; the others re-solve, warm-started, on the smallest row tier
   that covers every working lane's cuts, until every lane is done or has
   worked ``lp_max_rounds`` rounds.

Each LP is solved by a plain Mehrotra predictor-corrector interior-point
method, batched over the lanes: the normal matrix
``A^T diag(y/s) A + diag(zl/x + zu/w) + delta I`` as a dense ``bmm``, factored
by ``torch.linalg.cholesky_ex`` (a lane whose factor fails reads NaN and
keeps its iterate: the failed-factor rule), solved twice a step. Chunks of
``ipm_check_every`` steps, at most ``ipm_iters``, run while some working
lane's error max(mu, |r_p|, |r_d|) is above ``ipm_tol`` and has not
plateaued (two chunk boundaries in a row without falling below
``stall_ratio`` times its running minimum: the plateau rule). The solution
handed back is the last iterate, with the certificate error max(primal
violation, relative duality gap).

Success: every coordinate within ``lp_int_tol`` of 0 or 1 and the rounded
word a codeword.

Departures from the C++: each LP is solved by the interior-point method
above, not GLPK's dual simplex, so a solution is optimal to its tolerances
and not an exact vertex, and the stop rules of the solve and of the rounds
(``ipm_tol``, ``lp_tol``, ``stall_ratio``) are this repository's; cuts go
into a fixed buffer of row tiers rather than a growing GLPK problem, with
duplicate cuts skipped and overflow dropped; the objective is tilted by
``perturb`` so that the optimum is a unique vertex; lanes share a batch's
row tier and chunk loop. Float32 with TF32 off; ``control`` rounds the
operands of the normal matrix (the weights y/s) and of the matvecs (x and
y) to TF32's 10-bit mantissa, what a TF32 tensor-core product does.
"""
from __future__ import annotations

import numpy as np
import torch

from . import alp
from .gf2 import syndrome_zero

FRAC = 0.995     # fraction to the boundary of a step
FLOOR = 1e-12    # keeps the iterate strictly interior in float32


def prepare(h: np.ndarray, cfg: dict, device) -> dict:
    """The code's tables on ``device``: H, its support, the objective tilt
    and the two hash weights (those of ``alp.py``); TF32 off."""
    return alp.prepare(h, cfg, device)


def _pos_step(v, dv):
    """Largest step in (0, 1] keeping v + step dv >= (1 - FRAC) v, per lane."""
    neg = dv < 0
    ratio = torch.where(neg, -v / torch.where(neg, dv, -1.0), float("inf"))
    return torch.clamp_max(FRAC * ratio.amin(dim=-1), 1.0)


class _Ipm:
    """The batched interior-point solve of min c x, A x <= b, 0 <= x <= 1."""

    def __init__(self, cfg: dict, control: bool):
        self.r = alp._tf32 if control else (lambda v: v)
        self.iters = cfg["ipm_iters"]
        self.tol = cfg["ipm_tol"]
        self.every = cfg["ipm_check_every"]
        self.delta = cfg["ipm_delta"]
        self.shift = cfg["ipm_warm_shift"]
        self.ratio = cfg["stall_ratio"]

    def mv(self, a, v):
        return torch.bmm(a, self.r(v).unsqueeze(-1)).squeeze(-1)

    def mvt(self, a, v):
        return torch.bmm(self.r(v).unsqueeze(1), a).squeeze(1)

    def normal(self, a, d, dxx):
        m = torch.bmm(a.transpose(1, 2), a * self.r(d).unsqueeze(-1))
        diag = m.diagonal(dim1=1, dim2=2)
        diag.add_(dxx).add_(self.delta)
        return m

    def residuals(self, p, st):
        x, w, s, y, zl, zu, ax = st
        rp = ax + s - p["be"]
        rd = p["cs"] + self.mvt(p["a"], y) - zl + zu
        mu = ((y * s).sum(dim=-1) + (zl * x).sum(dim=-1)
              + (zu * w).sum(dim=-1)) / p["n_compl"]
        return rp, rd, mu

    def newton(self, p, st):
        """One predictor-corrector step; a lane whose direction is not
        finite keeps its iterate. All lanes step."""
        x, w, s, y, zl, zu, ax = st
        a = p["a"]
        rp, rd, mu = self.residuals(p, st)
        dy_s = (y / s).clamp(1e-10, 1e10)
        dxl = (zl / x).clamp(1e-10, 1e10)
        dxu = (zu / w).clamp(1e-10, 1e10)
        m = self.normal(a, dy_s, dxl + dxu)
        chol, info = torch.linalg.cholesky_ex(m, check_errors=False)
        lower = torch.ones(m.shape[-2:], dtype=torch.bool,
                           device=m.device).tril()
        chol = chol.masked_fill((info != 0)[:, None, None] & lower,
                                float("nan"))

        def direction(sig_mu, extra_y, extra_l, extra_u):
            ry = (sig_mu[:, None] - extra_y) / s - y
            rl = (sig_mu[:, None] - extra_l) / x - zl
            ru = (sig_mu[:, None] - extra_u) / w - zu
            rhs = -rd - self.mvt(a, ry + dy_s * rp) + rl - ru
            dx = torch.cholesky_solve(rhs.unsqueeze(-1), chol).squeeze(-1)
            dx = dx.contiguous()
            adx = self.mv(a, dx)
            ds = -rp - adx
            return dx, ry - dy_s * ds, ds, rl - dxl * dx, ru + dxu * dx, adx

        def lengths(dx, dy, ds, dzl, dzu):
            ap = torch.minimum(_pos_step(s, ds), torch.minimum(
                _pos_step(x, dx), _pos_step(w, -dx)))
            ad = torch.minimum(_pos_step(y, dy), torch.minimum(
                _pos_step(zl, dzl), _pos_step(zu, dzu)))
            return ap, ad

        zero = torch.zeros((x.shape[0],), dtype=torch.float32,
                           device=x.device)
        dxa, dya, dsa, dzla, dzua, _ = direction(
            zero, torch.zeros_like(y), torch.zeros_like(x),
            torch.zeros_like(x))
        ap, ad = lengths(dxa, dya, dsa, dzla, dzua)
        ap_, ad_ = ap[:, None], ad[:, None]
        mu_aff = (((y + ad_ * dya) * (s + ap_ * dsa)).sum(dim=-1)
                  + ((zl + ad_ * dzla) * (x + ap_ * dxa)).sum(dim=-1)
                  + ((zu + ad_ * dzua) * (w - ap_ * dxa)).sum(dim=-1)
                  ) / p["n_compl"]
        ratio = mu_aff / mu.clamp_min(1e-12)
        sigma = (ratio * (ratio * ratio)).clamp(0.0, 1.0)
        dx, dy, ds, dzl, dzu, adx = direction(
            sigma * mu, dya * dsa, dzla * dxa, -dzua * dxa)
        ap, ad = lengths(dx, dy, ds, dzl, dzu)
        ok = (torch.isfinite(dx).all(dim=-1)
              & torch.isfinite(dy).all(dim=-1))[:, None]
        ap_, ad_ = ap[:, None], ad[:, None]
        ax = torch.where(ok, ax + ap_ * adx, ax)
        x = torch.where(ok, x + ap_ * dx, x)
        s = torch.where(ok, s + ap_ * ds, s)
        y = torch.where(ok, y + ad_ * dy, y)
        zl = torch.where(ok, zl + ad_ * dzl, zl)
        zu = torch.where(ok, zu + ad_ * dzu, zu)
        x = x.clamp(FLOOR, 1.0 - FLOOR)
        return (x, 1.0 - x, s.clamp_min(FLOOR), y.clamp_min(FLOOR),
                zl.clamp_min(FLOOR), zu.clamp_min(FLOOR), ax)

    def solve(self, c, a, b, x0, y0, active):
        """(x, y, err) of the lanes' LPs, warm-started from (x0, y0);
        lanes off ``active`` step too, read err 0 and are left out of the
        stop test."""
        bsz, r_cap, n = a.shape
        dev = a.device
        cscale = c.abs().mean(dim=-1, keepdim=True).clamp_min(1e-6)
        cs = c / cscale
        row_on = (a != 0).any(dim=-1)
        be = torch.where(row_on, b, torch.full((), 2.0 * n, device=dev))
        p = {"a": a, "cs": cs, "be": be,
             "n_compl": torch.full((), float(r_cap + 2 * n), device=dev)}
        x = x0.clamp(self.shift, 1.0 - self.shift)
        w = 1.0 - x
        ax = self.mv(a, x)
        s = (be - ax).clamp_min(self.shift)
        y = (y0 / cscale.clamp_min(1e-6)).clamp_min(self.shift)
        rc0 = cs + self.mvt(a, y)
        st = tuple(v.contiguous() for v in (
            x, w, s, y, rc0.clamp_min(self.shift),
            (-rc0).clamp_min(self.shift), ax))
        best = torch.full((bsz,), float("inf"), device=dev)
        stalls = torch.zeros((bsz,), dtype=torch.int32, device=dev)
        for _ in range(-(-self.iters // self.every)):
            x, w, s, y, zl, zu, _ = st
            ax = self.mv(a, x)
            st = (x, w, s, y, zl, zu, ax)
            rp, rd, mu = self.residuals(p, st)
            err = torch.maximum(mu, torch.maximum(
                (rp.abs() * row_on).amax(dim=-1), rd.abs().amax(dim=-1)))
            err = err.masked_fill(~active, 0.0)
            improving = err < self.ratio * best
            stalls = torch.where(stalls >= 2, stalls,
                                 (stalls + 1).masked_fill(improving, 0))
            best = torch.minimum(best, err)
            if not bool(((err > self.tol) & (stalls < 2)).any()):
                break
            for _ in range(self.every):
                st = self.newton(p, st)
        x, y = st[0], st[3]
        viol = (self.mv(a, x) - be).clamp_min(0.0).amax(dim=-1)
        rc = cs + self.mvt(a, y)
        pobj = (cs * x).sum(dim=-1)
        dobj = -(be * y * row_on).sum(dim=-1) + rc.clamp_max(0.0).sum(dim=-1)
        gap = (pobj - dobj) / (1.0 + pobj.abs() + dobj.abs())
        err = torch.maximum(viol, gap).masked_fill(~active, 0.0)
        return x, y * cscale, err


def column_order(u: torch.Tensor, eps: float) -> torch.Tensor:
    """(B, n) int64: each lane's columns, fractional first by |u - 0.5|,
    then the integral zeros, then the integral ones, ties in index order."""
    key = torch.where(u < eps, 1.0, torch.where(u > 1.0 - eps, 2.0,
                                                (u - 0.5).abs()))
    return torch.sort(key, dim=-1, stable=True).indices


def rref(hp: torch.Tensor) -> torch.Tensor:
    """The reduced row echelon form over GF(2) of each lane's (m, n) 0/1
    matrix in its column order: its rows in the order of their pivot
    columns, then the zero rows. (B, m, n) uint8."""
    hm = hp.to(torch.uint8).clone()
    bsz, m, n = hm.shape
    rows = torch.arange(m, device=hm.device)
    lanes = torch.arange(bsz, device=hm.device)
    rank = torch.zeros((bsz,), dtype=torch.int64, device=hm.device)
    for col in range(n):
        if col % 8 == 0 and bool((rank >= m).all()):
            break
        cand = hm[:, :, col].bool() & (rows >= rank[:, None])
        has = cand.any(dim=1)
        piv = cand.to(torch.uint8).argmax(dim=1)
        top = rank.clamp_max(m - 1)
        row_p, row_t = hm[lanes, piv], hm[lanes, top]
        hm[lanes, piv] = torch.where(has[:, None], row_t, row_p)
        hm[lanes, top] = torch.where(has[:, None], row_p, row_t)
        others = hm[:, :, col].bool() & (rows != top[:, None]) & has[:, None]
        hm ^= others[..., None].to(torch.uint8) * row_p[:, None, :]
        rank = rank + has.to(torch.int64)
    return hm


def gauss_supports(h: torch.Tensor, u: torch.Tensor, need: torch.Tensor,
                   eps: float) -> torch.Tensor:
    """(B, m, n) bool: for the lanes of ``need``, the rows of H eliminated
    in the lane's column order (``column_order``), in H's columns; empty
    rows elsewhere."""
    bsz, n = u.shape
    m = h.shape[0]
    out = torch.zeros((bsz, m, n), dtype=torch.bool, device=u.device)
    lanes = need.nonzero().squeeze(1)
    if lanes.numel():
        order = column_order(u[lanes], eps)
        idx = order[:, None, :].expand(-1, m, n)
        reduced = rref(h.to(torch.uint8).expand(lanes.numel(), m, n)
                       .gather(2, idx))
        out[lanes] = torch.zeros_like(reduced).scatter_(
            2, idx, reduced).bool()
    return out


def lane_candidates(sup: torch.Tensor, u: torch.Tensor, cut_tol: float):
    """``alp._candidates`` over per-lane rows: sup (B, m, n) bool."""
    u_b = u[:, None, :]
    size = sup.sum(dim=-1)
    dist = torch.where(sup, (u_b - 0.5).abs(), float("inf"))
    best = dist.argmin(dim=-1)
    flip = (sup & (u_b > 0.5)).sum(dim=-1) % 2 == 0
    col = torch.arange(sup.shape[-1], device=u.device)
    is_best = col == best[..., None]
    in_v = torch.where(is_best & flip[..., None], u_b <= 0.5,
                       u_b > 0.5) & sup
    viol = torch.where(in_v, 1.0 - u_b, torch.where(sup, u_b, 0.0)).sum(-1)
    add = (size > 0) & (viol < 1.0 - cut_tol)
    rows = torch.where(in_v, 1.0, torch.where(sup, -1.0, 0.0))
    return rows, (in_v.sum(dim=-1) - 1).to(torch.float32), add


def decode(t: dict, llr: torch.Tensor, control: bool = False) -> dict:
    """Decode one batch of (B, n) LLRs (the batch is one coupled solve);
    returns bits, success, iterations (rounds worked), dropped and cuts
    (each lane's active cuts at the end)."""
    cfg = t["cfg"]
    ipm = _Ipm(cfg, control)
    bsz, n = llr.shape
    dev = llr.device
    cap = cfg["capacity"]
    tiers = list(cfg["row_tiers"]) + [cap]
    c = llr.to(torch.float32)
    scale = c.abs().mean(dim=1, keepdim=True)
    c = c + cfg["perturb"] * scale * t["pert_dir"][None]
    i32 = torch.int32
    st = {"a": torch.zeros((bsz, cap, n), device=dev),
          "rhs": torch.zeros((bsz, cap), device=dev),
          "h1": torch.zeros((bsz, cap), dtype=i32, device=dev),
          "h2": torch.zeros((bsz, cap), dtype=i32, device=dev),
          "count": torch.zeros((bsz,), dtype=i32, device=dev)}
    x = (c < 0.0).to(torch.float32)
    y = torch.zeros((bsz, cap), device=dev)
    done = torch.zeros((bsz,), dtype=torch.bool, device=dev)
    viol = torch.zeros((bsz,), device=dev)
    viol_prev = torch.full((bsz,), float("inf"), device=dev)
    dropped = torch.zeros((bsz,), dtype=i32, device=dev)
    rounds = torch.zeros((bsz,), dtype=i32, device=dev)
    snap = cfg["snap_tol"]
    while not bool(done.all()):
        rounds = rounds + (~done).to(i32)
        eligible = ~done & (st["count"] < cfg["max_rows"])
        x_s = torch.where(x < snap, 0.0, torch.where(x > 1.0 - snap, 1.0, x))
        rows, rhs, add = alp._candidates(t["sup"], x_s, cfg["cut_tol"])
        added, lost = alp._append(
            st, rows, rhs, add & eligible[:, None],
            alp._hashes(rows, t["w1"]), alp._hashes(rows, t["w2"]))
        dropped = dropped + lost
        need = eligible & (added == 0)
        if bool(need.any()):
            sup = gauss_supports(t["h"], x_s, need, cfg["gauss_eps"])
            rows, rhs, add = lane_candidates(sup, x_s, cfg["cut_tol"])
            added_g, lost = alp._append(
                st, rows, rhs, add & need[:, None],
                alp._hashes(rows, t["w1"]), alp._hashes(rows, t["w2"]))
            added = added + added_g
            dropped = dropped + lost
        stalled = viol >= cfg["stall_ratio"] * viol_prev
        done = done | ((added == 0) & ((viol <= cfg["lp_tol"]) | stalled))
        act = ~done
        r_max, n_act = torch.stack([torch.where(done, 0, st["count"]).max(),
                                    act.sum(dtype=i32)]).tolist()
        viol_new = viol
        if n_act > 0:
            tier = tiers[sum(r_max > v for v in tiers[:-1])]
            x_new, y_t, viol_new = ipm.solve(
                c, st["a"][:, :tier], st["rhs"][:, :tier], x, y[:, :tier],
                act)
            x = torch.where(done[:, None], x, x_new)
            y[:, :tier] = torch.where(done[:, None], y[:, :tier], y_t)
        viol_prev = torch.where(rounds == 1, float("inf"), viol)
        viol = torch.where(done, 0.0, viol_new)
        done = done | (rounds >= cfg["lp_max_rounds"])
    bits = (x > 0.5).to(torch.uint8)
    tol = cfg["lp_int_tol"]
    integral = ((x < tol) | (x > 1.0 - tol)).all(dim=-1)
    return {"bits": bits, "success": integral & syndrome_zero(t["h"], bits),
            "iterations": rounds, "dropped": dropped, "cuts": st["count"]}


def lanes_differ(prog: dict, ref: dict) -> dict:
    """As ``alp.py``'s: ``certificates_differ`` marks a lane whose
    certificate differs or that both certify with different words;
    ``lanes_differ`` marks those and the lanes whose rounds worked
    differ."""
    return alp.lanes_differ(prog, ref)
