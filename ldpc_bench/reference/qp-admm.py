"""Penalised QP-ADMM decoding (acg-alp-ldpc ``algo/qp_admm.h``, paper
arXiv:1910.12712) in plain PyTorch.

The problem (``ConstructADMMProblem``, ``qp_admm.h:13-102``), built from H
on the host: x_1 ... x_n and, for each check row of degree d >= 3, d - 3
auxiliary variables after them, row by row. Each row gives constraints
``A v <= b`` in the order the C++ code adds them: degree 1, ``x <= 0``;
degree 2, ``x_i - x_j <= 0`` and ``x_j - x_i <= 0``; degree d >= 3, a
chain of d - 2 three-variable parity checks (first over the row's first
two variables and the first auxiliary one, then each auxiliary variable
with the row's next variable and the next auxiliary one, the last over
the last auxiliary variable and the row's last two variables), each the
four inequalities (+,-,-) <= 0, (-,+,-) <= 0, (-,-,+) <= 0, (+,+,+) <= 2
(``add_three``, ``:34-57``). Each variable keeps its (constraint,
coefficient) entries in the order they were added, and e_i is the sum of
its squared coefficients (``:94-99``).

The solve (``DecodeQPADMM``, ``:104-178``), each lane on its own: the
precondition ``min(e) mu > alpha`` (``:108-114``); v_i = 1 where the LLR
is positive, else 0, the auxiliary variables 0 (``:116-119``); z and yl
0; then each iteration (``:130-163``)

    t  = yl + mu (z - b)
    v  = clip((q + alpha / 2 + sum_entries coef t) * (-1 / (mu e - alpha)),
              0, 1)                  (q: the LLRs, 0 on auxiliary variables)
    r  = b - A v
    z  = max(0, r - yl),  yl = max(0, yl - r)

until ``sum (z - r)^2 < eps_stop`` or ``max_iter`` iterations; the bits
are ``v > 0.5`` (``:167-176``) and success is the precondition
(``:166``). A lane's iterations are those it ran: j + 1 where it stopped
in its (j + 1)-th, else ``max_iter``.

Departures from the C++ code:

* float32 throughout, as the configuration states and the program runs,
  where the C++ code's vectors are double (``TFVector``,
  ``utils/channel.h:8``);
* the order of the sums: each variable's entry terms are summed on their
  own, one after another in the order they were added, and that sum is
  added to ``q + alpha / 2``; each constraint's terms as ``(p0 + p1) +
  p2``; the stop's sum of squares is ``torch.sum`` over the constraints,
  in whatever order PyTorch takes on the device;
* lanes run in batches, a lane that has stopped frozen until the whole
  batch has (every ``CHECK_EVERY`` iterations the host asks whether it
  has, never past ``max_iter``); a frozen lane changes nothing;
* where the precondition fails the word is all zeros and success false,
  but the lanes still iterate, so that their iterations count as the
  program's do (the C++ code returns at once).

``control`` runs the same steps one precision step lower, in bfloat16
(the LLRs, the state, the tables' coefficients and the stop's sum).
"""
from __future__ import annotations

import numpy as np
import torch

CHECK_EVERY = 32       # iterations between the host's reads of all(done)


def cascade(h: np.ndarray):
    """The problem of H as plain lists: (n_var, constraints, entries),
    ``constraints`` [(variables, coefficients, rhs)] in the order the C++
    code adds them and ``entries`` [[(constraint, coefficient)]] per
    variable in the order they were added."""
    h = np.asarray(h, dtype=np.uint8) % 2
    m, n = h.shape
    cons = []

    def add(variables, coefs, rhs):
        cons.append((list(variables), list(coefs), float(rhs)))

    def add_three(i, j, k):
        add((i, j, k), (1.0, -1.0, -1.0), 0.0)
        add((i, j, k), (-1.0, 1.0, -1.0), 0.0)
        add((i, j, k), (-1.0, -1.0, 1.0), 0.0)
        add((i, j, k), (1.0, 1.0, 1.0), 2.0)

    n_var = n
    for row in range(m):
        cols = [int(c) for c in np.nonzero(h[row])[0]]
        if len(cols) == 1:
            add(cols, (1.0,), 0.0)
        elif len(cols) == 2:
            add(cols, (1.0, -1.0), 0.0)
            add(cols, (-1.0, 1.0), 0.0)
        elif len(cols) >= 3:
            last = cols[0]
            for j in range(1, len(cols) - 2):
                add_three(last, cols[j], n_var)
                last = n_var
                n_var += 1
            add_three(last, cols[-2], cols[-1])
    entries = [[] for _ in range(n_var)]
    for c, (variables, coefs, _) in enumerate(cons):
        for var, coef in zip(variables, coefs):
            entries[var].append((c, coef))
    return n_var, cons, entries


def prepare(h: np.ndarray, cfg: dict, device) -> dict:
    """The problem's tables on ``device``: each constraint's three
    variables and coefficients (a missing one reads variable 0 with
    coefficient 0), each variable's entries slot by slot (``k`` slots, the
    most entries a variable has, a missing one constraint 0 with
    coefficient 0), b, e, and the decoder's constants."""
    n = np.asarray(h).shape[1]
    n_var, cons, entries = cascade(h)
    n_con = len(cons)
    k = max(len(e) for e in entries)
    con_var = np.zeros((3, n_con), dtype=np.int64)
    con_coef = np.zeros((3, n_con), dtype=np.float32)
    b = np.zeros(n_con, dtype=np.float32)
    for c, (variables, coefs, rhs) in enumerate(cons):
        con_var[:len(variables), c] = variables
        con_coef[:len(coefs), c] = coefs
        b[c] = rhs
    var_con = np.zeros((k, n_var), dtype=np.int64)
    var_coef = np.zeros((k, n_var), dtype=np.float32)
    e = np.zeros(n_var, dtype=np.float32)
    for var, plist in enumerate(entries):
        for s, (c, coef) in enumerate(plist):
            var_con[s, var] = c
            var_coef[s, var] = coef
            e[var] += np.float32(coef * coef)
    t = {"con_var": con_var.reshape(-1), "con_coef": con_coef, "b": b,
         "var_con": var_con.reshape(-1), "var_coef": var_coef, "e": e}
    out = {key: torch.from_numpy(v).to(device) for key, v in t.items()}
    out.update(n=n, n_var=n_var, n_con=n_con, k=k,
               alpha=float(cfg["admm_alpha"]), mu=float(cfg["admm_mu"]),
               max_iter=int(cfg["admm_max_iter"]),
               eps_stop=float(cfg["admm_eps_stop"]))
    return out


def decode(t: dict, llr: torch.Tensor, control: bool = False) -> dict:
    """Decode (B, n) LLRs; returns bits (B, n) uint8, success (B,) bool,
    iterations (B,) int32, dropped None."""
    dt = torch.bfloat16 if control else torch.float32
    dev = llr.device
    b_count, n = llr.shape
    n_var, n_con, k = t["n_var"], t["n_con"], t["k"]

    def const(x):
        return torch.tensor(x, dtype=dt, device=dev)

    alpha, mu, eps = const(t["alpha"]), const(t["mu"]), const(t["eps_stop"])
    half_alpha = alpha / 2.0
    b, e = t["b"].to(dt), t["e"].to(dt)
    var_coef, con_coef = t["var_coef"].to(dt), t["con_coef"].to(dt)
    denom = mu * e - alpha
    inv_coef = torch.div(torch.full_like(denom, -1.0), denom)
    real = e > 0
    feasible = bool(torch.where(real, e, const(float("inf"))).min() * mu
                    > alpha)

    q = torch.cat([llr.to(dt), llr.new_zeros((b_count, n_var - n),
                                             dtype=dt)], dim=1)
    v = (q > 0).to(dt)
    z = q.new_zeros((b_count, n_con))
    yl = q.new_zeros((b_count, n_con))
    done = torch.zeros(b_count, dtype=torch.bool, device=dev)
    it = torch.zeros(b_count, dtype=torch.int32, device=dev)
    shift = q + half_alpha
    k_done = 0
    while k_done < t["max_iter"] and not bool(done.all()):
        for _ in range(min(CHECK_EVERY, t["max_iter"] - k_done)):
            tt = yl + mu * (z - b)
            p = tt.index_select(1, t["var_con"]).view(b_count, k, n_var) \
                * var_coef
            acc = p[:, 0]
            for s in range(1, k):
                acc = acc + p[:, s]
            v_new = ((shift + acc) * inv_coef).clamp(0.0, 1.0)
            pv = v_new.index_select(1, t["con_var"]).view(b_count, 3,
                                                          n_con) * con_coef
            r = b - ((pv[:, 0] + pv[:, 1]) + pv[:, 2])
            z_new = (r - yl).clamp_min(0.0)
            y_new = (yl - r).clamp_min(0.0)
            d = z_new - r
            sum2 = (d * d).sum(dim=-1)
            keep = done[:, None]
            v = torch.where(keep, v, v_new)
            z = torch.where(keep, z, z_new)
            yl = torch.where(keep, yl, y_new)
            ran = ~done
            it = it + ran.to(torch.int32)
            done = done | (ran & (sum2 < eps)) | (it >= t["max_iter"])
            k_done += 1
    bits = (v[:, :n] > 0.5) & feasible
    return {"bits": bits.to(torch.uint8),
            "success": torch.full((b_count,), feasible, dtype=torch.bool,
                                  device=dev),
            "iterations": it, "dropped": None}


def lanes_differ(prog: dict, ref: dict) -> dict:
    """Per-lane disagreements: ``lanes_differ`` marks a lane whose bits,
    success or iterations differ (the lanes are independent, so only
    rounding between the two sums can part them)."""
    bits = (prog["bits"] != ref["bits"]).any(dim=-1)
    other = ((prog["success"].bool() != ref["success"].bool())
             | (prog["iterations"].to(torch.int64)
                != ref["iterations"].to(torch.int64)))
    return {"lanes_differ": bits | other}
