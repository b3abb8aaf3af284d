"""Adaptive LP decoding (ALP) with PDHG solves, in plain PyTorch.

The reference decoder's ``ALPDecoder`` (acg-alp-ldpc ``alp.h:21-138``) with
the repository's own first-order solver, whose constants the configuration
file lists under ``assumed``. Per batch of lanes, starting from the box LP's
optimum (objective: the LLRs tilted by ``perturb`` along a fixed direction):

1. snap coordinates within ``snap_tol`` of 0 or 1, then search every check
   row for its most violated odd-set cut (``alp.h:21-97``): V = support
   positions above 0.5, an even V flips the position closest to 0.5 (first
   on ties), and the cut ``sum_V x - sum_rest x <= |V| - 1`` is a candidate
   when its violation exceeds ``cut_tol``;
2. append the candidates of lanes below ``max_rows`` cuts into a per-lane
   buffer of ``capacity`` rows, in row order, skipping any whose two int32
   hashes equal an active cut's and dropping what overflows;
3. a lane is done when it adds no cut and its last solve converged
   (error <= ``lp_tol``) or stalled (error not below ``stall_ratio`` times
   the round before); the others re-solve on the smallest row tier that
   covers every working lane's cuts: PDHG chunks of ``lp_iters`` steps,
   warm-started, at most ``lp_max_iters`` steps, while the batch's largest
   error is above ``lp_tol`` and still falls below ``stall_ratio`` times the
   chunk before's (the first chunk always runs);
4. until every lane is done or has worked ``lp_max_rounds`` rounds.

Success: every coordinate within ``lp_int_tol`` of 0 or 1 and the rounded
word a codeword. PDHG (Chambolle-Pock, diagonal preconditioners with
``pdhg_safety``) runs its two products per step as float32 batched matrix
products with TF32 off; ``control`` rounds their operands to TF32's 10-bit
mantissa, what a TF32 tensor-core product does.
"""
from __future__ import annotations

import numpy as np
import torch

from .gf2 import syndrome_zero


def _tables(n: int, pert_seed: int, hash_seed: int):
    rng = np.random.default_rng(pert_seed)
    pert_dir = rng.uniform(-1.0, 1.0, n).astype(np.float32)
    rng = np.random.default_rng(hash_seed)
    w1 = rng.integers(-2**31, 2**31 - 1, n, dtype=np.int64).astype(np.int32)
    w2 = rng.integers(-2**31, 2**31 - 1, n, dtype=np.int64).astype(np.int32)
    return pert_dir, w1, w2


def prepare(h: np.ndarray, cfg: dict, device) -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    h = np.asarray(h, dtype=np.uint8) % 2
    pert_dir, w1, w2 = _tables(h.shape[1], cfg["perturb_seed"],
                               cfg["hash_seed"])
    t = {k: torch.from_numpy(v).to(device) for k, v in (
        ("h", h), ("sup", h.astype(bool)), ("pert_dir", pert_dir),
        ("w1", w1), ("w2", w2))}
    t["cfg"] = dict(cfg)
    return t


def _tf32(v: torch.Tensor) -> torch.Tensor:
    """float32 rounded to 10 mantissa bits, to nearest even."""
    i = v.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


class _Pdhg:
    def __init__(self, control: bool):
        self.r = _tf32 if control else (lambda v: v)

    def at_y(self, a, y):
        return torch.bmm(self.r(y).unsqueeze(1), a).squeeze(1)

    def a_x(self, a, x):
        return torch.bmm(a, self.r(x).unsqueeze(-1)).squeeze(-1)

    def err(self, c, a, b, x, y):
        viol = (self.a_x(a, x) - b).clamp_min(0.0).amax(dim=-1)
        rc = c + self.at_y(a, y)
        pobj = (c * x).sum(dim=-1)
        dobj = -(b * y).sum(dim=-1) + rc.clamp_max(0.0).sum(dim=-1)
        gap = (pobj - dobj) / (1.0 + pobj.abs() + dobj.abs())
        return torch.maximum(viol, gap)

    def chunk(self, c, a, b, tau, sigma, x, y, iters, active):
        x0, y0 = x, y
        for _ in range(iters):
            x_new = (x - tau * (c + self.at_y(a, y))).clamp(0.0, 1.0)
            y = (y + sigma * (self.a_x(a, 2.0 * x_new - x) - b)).clamp_min(
                0.0)
            x = x_new
        e = self.err(c, a, b, x, y)
        x = torch.where(active[:, None], x, x0)
        y = torch.where(active[:, None], y, y0)
        return x, y, torch.where(active, e, 0.0)

    def solve(self, cfg, c, a, b, x, y, active):
        safety = cfg["pdhg_safety"]
        absa = a.abs()
        num = torch.full((), safety, dtype=torch.float32, device=a.device)
        tau = num / absa.sum(dim=-2).clamp_min(1.0)
        row_sum = absa.sum(dim=-1)
        sigma = torch.where(row_sum > 0, num / row_sum.clamp_min(1e-6), 0.0)
        x, y, b = x.contiguous(), y.contiguous(), b.contiguous()
        tol = np.float32(cfg["lp_tol"])
        ratio = np.float32(cfg["stall_ratio"])
        v, vprev = None, np.float32(np.inf)
        for _ in range(-(-cfg["lp_max_iters"] // cfg["lp_iters"])):
            vmax = np.float32(np.inf) if v is None else \
                np.float32(v.max().item())
            if not (vmax > tol and (vmax < ratio * vprev
                                    or not np.isfinite(vprev))):
                break
            x, y, v = self.chunk(c, a, b, tau, sigma, x, y,
                                 cfg["lp_iters"], active)
            vprev = vmax
        if v is None:
            v = torch.full((a.shape[0],), float("inf"), device=a.device)
        return x, y, v


def _candidates(sup, u, cut_tol):
    u_b = u[:, None, :]
    sup = sup.expand(u.shape[0], *sup.shape)
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


def _hashes(rows, w):
    """int32 wraparound sum of the row times w, exact in int64 first."""
    return (rows.to(torch.int64) * w.to(torch.int64)).sum(dim=-1).to(
        torch.int32)


def _append(st, rows, rhs, add, h1c, h2c):
    cap = st["a"].shape[1]
    count = st["count"]
    live = torch.arange(cap, device=count.device)[None, :] < count[:, None]
    dup = ((h1c[:, :, None] == st["h1"][:, None, :])
           & (h2c[:, :, None] == st["h2"][:, None, :])
           & live[:, None, :]).any(dim=-1)
    add = add & ~dup
    add_i = add.to(torch.int32)
    pos = count[:, None] + add_i.cumsum(dim=1, dtype=torch.int32) - add_i
    keep = add & (pos < cap)
    lane, cand = keep.nonzero(as_tuple=True)
    slot = pos[lane, cand]
    st["a"][lane, slot] = rows[lane, cand]
    st["rhs"][lane, slot] = rhs[lane, cand]
    st["h1"][lane, slot] = h1c[lane, cand]
    st["h2"][lane, slot] = h2c[lane, cand]
    added = keep.sum(dim=1, dtype=torch.int32)
    st["count"] = count + added
    return added, add.sum(dim=1, dtype=torch.int32) - added


def decode(t: dict, llr: torch.Tensor, control: bool = False) -> dict:
    """Decode one batch of (B, n) LLRs (the batch is one coupled solve);
    returns bits, success, iterations (rounds worked), dropped."""
    cfg = t["cfg"]
    pdhg = _Pdhg(control)
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
        rows, rhs, add = _candidates(t["sup"], x_s, cfg["cut_tol"])
        added, lost = _append(st, rows, rhs, add & eligible[:, None],
                              _hashes(rows, t["w1"]), _hashes(rows, t["w2"]))
        dropped = dropped + lost
        stalled = viol >= cfg["stall_ratio"] * viol_prev
        done = done | ((added == 0) & ((viol <= cfg["lp_tol"]) | stalled))
        act = ~done
        r_max, n_act = torch.stack([torch.where(done, 0, st["count"]).max(),
                                    act.sum(dtype=i32)]).tolist()
        viol_new = viol
        if n_act > 0:
            tier = tiers[sum(r_max > v for v in tiers[:-1])]
            x_new, y_t, viol_new = pdhg.solve(
                cfg, c, st["a"][:, :tier], st["rhs"][:, :tier], x,
                y[:, :tier], act)
            x = torch.where(done[:, None], x, x_new)
            y[:, :tier] = torch.where(done[:, None], y[:, :tier], y_t)
        viol_prev = torch.where(rounds == 1, float("inf"), viol)
        viol = torch.where(done, 0.0, viol_new)
        done = done | (rounds >= cfg["lp_max_rounds"])
    bits = (x > 0.5).to(torch.uint8)
    tol = cfg["lp_int_tol"]
    integral = ((x < tol) | (x > 1.0 - tol)).all(dim=-1)
    return {"bits": bits, "success": integral & syndrome_zero(t["h"], bits),
            "iterations": rounds, "dropped": dropped}


def lanes_differ(prog: dict, ref: dict) -> dict:
    """Per-lane disagreements. ``certificates_differ`` marks a lane whose
    certificate differs or that both certify with different words (a failed
    lane's word rounds a fractional optimum, whose coordinates at 0.5 fall
    either way, and is not compared); ``lanes_differ`` marks those and the
    lanes whose rounds worked differ."""
    ps, rs = prog["success"].bool(), ref["success"].bool()
    words = (prog["bits"] != ref["bits"]).any(dim=-1)
    rounds = (prog["iterations"].to(torch.int64)
              != ref["iterations"].to(torch.int64))
    certificates = (ps != rs) | (ps & rs & words)
    return {"lanes_differ": certificates | rounds,
            "certificates_differ": certificates}
