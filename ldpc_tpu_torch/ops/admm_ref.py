"""Plain PyTorch twin of QP-ADMM's hand-written iteration kernel
(``csrc/admm_iterate.cu``, wrapped by :mod:`.admm_kernel`).

JAX has no Pallas kernel here: ``decode_qp_admm`` is one ``lax.while_loop``
whose body, ``iter_fn`` (``ldpc_tpu/decoders/admm.py:249-262``), XLA fuses
into a few loops, and ``stream_chunk`` a second one (``:351-365``). This
twin is the eager loop the port ran before the kernel existed: gathers and
elementwise updates, each constraint's three slots summed in order, and
each variable's slots and each pair's sum2 summed as XLA on the CPU sums
a reduction (:func:`xla_sum`: in order up to 32 terms, in windows of 32
past that), so that the twin equals JAX bit for bit. The decoders reach
it through the wrapper on a CPU tensor; on the card the tests,
``chip_smoke.py`` and ``scripts/torch_admm_speed.py`` hold the kernel to
it.
"""
from __future__ import annotations

import torch

__all__ = ["CHECK_EVERY", "WINDOW", "admm_iterate_ref", "lane_param",
           "stop_ties", "sum2_steps", "window_front", "xla_sum"]

CHECK_EVERY = 32       # iterations between host reads of all(done)
EPS32 = 2.0 ** -23
WINDOW = 32            # XLA's window for a reduction of more terms


def window_front(k: int) -> int:
    """The +0 terms XLA puts in front of a reduction of ``k`` > 32 terms:
    half the padding to whole windows, rounded down (the rest goes
    behind)."""
    return (WINDOW * -(-k // WINDOW) - k) // 2


def xla_sum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """float32 sum of ``x`` over ``dim`` in the order XLA on the CPU sums a
    reduction (``jnp.sum`` under ``jit``). Up to 32 terms, one after
    another from the first (XLA starts from +0, which differs only where
    every term is -0: XLA gives +0 there). Past 32, :func:`window_front`
    +0 terms go in front and the rest of the padding to whole windows
    behind, each window of 32 is summed in order from +0, and the windows'
    sums are summed by the same rule, recursively."""
    dim %= x.dim()
    k = x.shape[dim]
    if k <= WINDOW:
        acc = x.select(dim, 0)
        for s in range(1, k):
            acc = acc + x.select(dim, s)
        return acc
    front = window_front(k)
    pad = WINDOW * -(-k // WINDOW) - k
    if pad:
        x = torch.cat([x.new_zeros(x.shape[:dim] + (front,)
                                   + x.shape[dim + 1:]), x,
                       x.new_zeros(x.shape[:dim] + (pad - front,)
                                   + x.shape[dim + 1:])], dim=dim)
    w = x.unflatten(dim, (-1, WINDOW))
    acc = torch.zeros_like(w.select(dim + 1, 0))
    for s in range(WINDOW):
        acc = acc + w.select(dim + 1, s)
    return xla_sum(acc, dim)


def _pad_to_zero(idx: torch.Tensor, pad: int) -> torch.Tensor:
    """int64 copy of an index table with its padding value ``pad`` set
    to 0."""
    idx = idx.long()
    return torch.where(idx == pad, 0, idx)


def lane_param(p, bsz: int, device: torch.device) -> torch.Tensor:
    """(B, 1) float32 per-lane copy of a scalar or (B,) parameter. A scalar
    becomes a fill (no host-to-device copy, so no stream sync)."""
    if isinstance(p, torch.Tensor):
        t = p.to(device=device, dtype=torch.float32)
        if t.dim() == 0:
            t = t.reshape(1)
        return t.reshape(-1, 1).expand(bsz, 1)
    return torch.full((bsz, 1), float(p), dtype=torch.float32, device=device)


class _Iteration:
    """One reference iteration (``qp_admm.h:130-163``) of P candidate
    structures at once, with per-lane alpha and mu and done-pair freezing.

    ``tables``: dict of con_var (P, nc, 3) int, con_coef (P, nc, 3) f32, b
    (P, nc) f32, var_con (P, nv, k) int, var_coef (P, nv, k) f32, e (P, nv)
    f32, on one device (possibly capacity-padded: phantom variables and
    constraints carry zero coefficients). A lane's row holds the P
    candidates' variables one after another, (B, P * nv), and their
    constraints likewise, (B, P * nc); candidate p's index tables are offset
    by p * nc (or p * nv), so one gather serves every candidate. With P = 1
    this is one structure's decode.
    """

    def __init__(self, tables: dict, alpha: torch.Tensor, mu: torch.Tensor,
                 eps_stop: float):
        var_con, e = tables["var_con"], tables["e"]
        self.p, self.n_var, self.k = var_con.shape
        self.n_con = tables["con_var"].shape[1]
        base = torch.arange(self.p, device=e.device).view(-1, 1, 1)
        self.b = tables["b"].reshape(-1)                          # (P * nc,)
        # slot-major gathers: slot s of every candidate's variables is one
        # contiguous run. A padding slot (index n_con or n_var, coefficient
        # 0) reads its candidate's entry 0 instead of JAX's appended zero
        # column: its product is still a zero, and adding a zero of either
        # sign after the first slot, or to a window's sum from +0, leaves
        # every sum as it was
        self.vc_idx = (_pad_to_zero(var_con, self.n_con) + base * self.n_con
                       ).permute(2, 0, 1).reshape(-1)
        self.vc_coef = tables["var_coef"].permute(2, 0, 1).reshape(
            self.k, -1)                                           # (k, P*nv)
        self.cv_idx = (_pad_to_zero(tables["con_var"], self.n_var)
                       + base * self.n_var).permute(2, 0, 1).reshape(-1)
        self.cv_coef = tables["con_coef"].permute(2, 0, 1).reshape(
            3, -1)                                                # (3, P*nc)
        self.alpha, self.mu = alpha, mu                           # (B, 1)
        self.half_alpha = alpha / 2.0
        # phantom capacity variables have e == 0 (denom == -alpha); their q
        # is 0 and they appear in no constraint, so their value is inert.
        # Guard the division anyway.
        denom = mu * e.reshape(1, -1) - alpha
        one = torch.ones((), dtype=torch.float32, device=e.device)
        self.inv_coef = -one / torch.where(denom == 0, one, denom)
        self.eps_stop = float(eps_stop)

    def _gather_con(self, t: torch.Tensor) -> torch.Tensor:
        bsz = t.shape[0]
        g = t.index_select(1, self.vc_idx).view(bsz, self.k, -1)
        # the windows follow the tables' width k, caps included
        return xla_sum(g * self.vc_coef, 1)

    def _gather_var(self, v: torch.Tensor) -> torch.Tensor:
        bsz = v.shape[0]
        g = v.index_select(1, self.cv_idx).view(bsz, 3, -1)
        p = g * self.cv_coef
        return (p[:, 0] + p[:, 1]) + p[:, 2]

    def _keep(self, done, old, new):
        """``old`` on the (lane, candidate) pairs that are done, else
        ``new`` (the scalar code's break)."""
        bsz = old.shape[0]
        return torch.where(done[:, :, None], old.view(bsz, self.p, -1),
                           new.view(bsz, self.p, -1)).view(bsz, -1)

    def __call__(self, q, v, z, yl, done):
        """``done`` (B, P) bool. Returns (v, z, yl, now_done, sum2)."""
        t = yl + self.mu * (z - self.b)
        bq = (q + self.half_alpha) + self._gather_con(t)
        v_new = (bq * self.inv_coef).clamp(0.0, 1.0)
        r = self.b - self._gather_var(v_new)
        z_new = (r - yl).clamp_min(0.0)
        y_new = (yl - r).clamp_min(0.0)
        d = z_new - r
        sum2 = xla_sum((d * d).view(d.shape[0], self.p, self.n_con))
        v = self._keep(done, v, v_new)
        z = self._keep(done, z, z_new)
        yl = self._keep(done, yl, y_new)
        now_done = ~done & (sum2 < self.eps_stop)
        return v, z, yl, now_done, sum2


def admm_iterate_ref(q, v, z, yl, done, it, tables, alpha, mu,
                     eps_stop: float, max_iter: int, iters: int, sum2=None,
                     check_every: int = CHECK_EVERY):
    """Up to ``iters`` QP-ADMM iterations of every (lane, candidate) pair
    that is not done; returns (v, z, yl, done, it) as new tensors.

    q, v (B, P * n_var) and z, yl (B, P * n_con) float32; done (B, P) bool;
    it (B, P) int32; ``tables`` as :class:`_Iteration`'s, with the leading
    candidate axis (extra keys are ignored); alpha, mu scalars or (B,).
    Each iteration a pair runs adds 1 to its ``it``; the pair is done when
    its sum2 falls below ``eps_stop`` (compared in float32) or its ``it``
    reaches ``max_iter``, and a done pair is frozen. ``sum2`` (B, P)
    float32, when given, receives each pair's sum2 of the last iteration it
    ran here (pairs that ran none keep theirs). The host reads ``all(done)``
    before each block of ``check_every`` iterations and stops when it holds;
    a few iterations more would change nothing, as done pairs are frozen.

    From fresh pairs with ``iters = max_iter`` the final ``it`` is JAX's
    ``done_it`` (j + 1 for a pair that converged at loop index j, else
    ``max_iter``); in a stream it is the per-lane count of JAX's
    ``stream_chunk``."""
    bsz, dev = q.shape[0], q.device
    step = _Iteration(tables, lane_param(alpha, bsz, dev),
                      lane_param(mu, bsz, dev), eps_stop)
    k = 0
    while k < iters and not bool(done.all()):
        for _ in range(min(check_every, iters - k)):
            ran = ~done
            v, z, yl, now_done, s2 = step(q, v, z, yl, done)
            if sum2 is not None:
                sum2.copy_(torch.where(ran, s2, sum2))
            it = it + ran.to(torch.int32)
            done = done | now_done | (it >= max_iter)
            k += 1
    return v, z, yl, done, it


def sum2_steps(fn, state, tables, alpha, mu, steps: int):
    """Each pair's sum2 after each of ``steps`` single iterations of ``fn``
    (:func:`admm_iterate_ref` or the kernel's wrapper) from ``state``
    (q, v, z, yl, done, it), with no pair allowed to stop: (steps, B, P)
    float32 and the state (v, z, yl) reached. ``state`` is not changed."""
    q, v, z, yl, done, it = (t.clone() for t in state)
    out = torch.full((steps,) + tuple(done.shape), float("nan"),
                     dtype=torch.float32, device=q.device)
    done = torch.zeros_like(done)
    for j in range(steps):
        v, z, yl, _, it = fn(q, v, z, yl, done, it, tables, alpha, mu,
                             float("-inf"), 2 ** 31 - 1, 1, sum2=out[j])
    return out, (v, z, yl)


def stop_ties(state, got, want, tables, alpha, mu, eps_stop: float,
              fn_got, fn_want):
    """The pairs whose stop (iteration count or done) differs between two
    runs from ``state`` (q, v, z, yl, done, it): ``got`` by ``fn_got`` and
    ``want`` by ``fn_want``, each (v, z, yl, done, it). For each such pair,
    both functions rerun from ``state`` without stopping to the earlier of
    the two stops, j iterations in; the pair is a tie when the two sum2
    values at j lie on either side of ``eps_stop`` (as float32) within
    n_con * 2**-23 * sum2 of each other, and the two reruns reach equal
    states. Returns (ties, others): lists of (lane, candidate, j, sum2 of
    ``fn_got``, sum2 of ``fn_want``); ``others`` are the differing pairs
    that are not ties."""
    it0 = state[5]
    differ = ((got[4] != want[4]) | (got[3] != want[3])).nonzero().tolist()
    if not differ:
        return [], []
    steps = int((torch.minimum(got[4], want[4]) - it0).max())
    n_con = state[2].shape[1] // it0.shape[1]
    s_got, end_got = sum2_steps(fn_got, state, tables, alpha, mu, steps)
    s_want, end_want = sum2_steps(fn_want, state, tables, alpha, mu, steps)
    same = all(torch.equal(a, b) for a, b in zip(end_got, end_want))
    eps = float(torch.tensor(eps_stop, dtype=torch.float32))
    ties, others = [], []
    for lane, cand in differ:
        j = int(min(got[4][lane, cand], want[4][lane, cand])
                - it0[lane, cand])
        a = float(s_got[j - 1, lane, cand])
        b = float(s_want[j - 1, lane, cand])
        near = abs(a - b) <= n_con * EPS32 * max(a, b)
        row = (lane, cand, j, a, b)
        if same and j > 0 and near and ((a < eps) != (b < eps)):
            ties.append(row)
        else:
            others.append(row)
    return ties, others
