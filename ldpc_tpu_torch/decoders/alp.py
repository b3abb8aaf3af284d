"""Adaptive LP decoding (ALP) with on-device cut generation (counterpart of
``ldpc_tpu/decoders/alp.py``).

Start from the box LP whose optimum is the hard decision on the LLRs
(objective = channel LLRs, no parity rows, ``alp.h:110-121``), then repeat:
(a) search every check row for the most violated odd-set parity cut
(``AddRowsALP``, ``alp.h:21-97``); (b) append the new cuts into a
fixed-capacity per-lane constraint buffer, dropping duplicates by hash and
dropping what overflows; (c) re-solve the LP with warm-started batched PDHG
(:mod:`..ops.lp_solver`) on the smallest row tier covering every working
lane's cuts; until every lane is done or has used its round budget. The
certificate is ``DecodeFromLp`` (``full_lp.h:44-59``): an integral LP
solution that is a codeword.

Cut search (vectorised over (B, m, n) masks, an exact transcription): for
each check row, V = {j in supp: u_j > 0.5}; if |V| is even, flip the
membership of the support position closest to 0.5 (first index on ties,
``alp.h:29-38,45-61``); the cut  sum_V x - sum_{supp \\ V} x <= |V| - 1  is
added iff  sum_V (1-u) + sum_{supp \\ V} u < 1 - tol  (``alp.h:63-94``).

JAX's ``while_loop``, ``lax.switch`` and ``lax.cond`` become Python
control flow. Each round makes three host reads (each waits for the device):
the append's ``nonzero``, the row tier (the largest working lane's cut
count, read with the number of working lanes), and the loop's
``all(done)``, which reads once more after the last round. The round's
solve adds its own: the fused PDHG solver one per chunk it runs (the read
before each later chunk and the one that stops the loop; one fewer when it
runs its whole budget), the plain one a read more, the IPM one per chunk
and one more. A batch runs until its slowest lane stops, so a batch's
reads follow its slowest lane's rounds, not the mean. With the Gaussian
cut source (AGC-ALP) a round makes one more, whether any lane needs the
elimination (JAX's ``lax.cond(any(need))``), and, when one does, a fourth,
the second append's ``nonzero``. Streamed, each chunk reads ``all(done)``
and the refill's ``nonzero``, and a chunk after every lane finished reads
nothing else.

:data:`COUNTS` counts the lanes the rounds hold and solve, and each of
these reads at its site; the spans of :mod:`..utils.profiling` name
each step while a profiler records.
"""
from __future__ import annotations

from collections import Counter

import numpy as np
import torch
from torch import nn

from ..codes.gf2 import is_codeword
from ..ops.ipm_solver import ipm_box_lp
from ..ops.lp_solver import pdhg_box_lp, pdhg_box_lp_fused
from ..utils.profiling import span, spanned
from .base import DecodeResult, resolve_device

__all__ = ["ALPDecoder", "COUNTS", "alp_cut_candidates", "alp_tables",
           "append_cuts", "cut_hashes"]

# the cut loop's work and host reads, summed over every decode of the
# process: ``lanes`` (the batch, once a round); ``solve_lanes`` (the
# round's working lanes, read with the tier); ``reads.<site>`` for each host
# read: ``append``, ``tier`` (once a round), ``done``, and AGC-ALP's
# ``need`` and ``append_g``
COUNTS: Counter = Counter()

_HASH_SEED = 0x5DEECE66
_PERT_SEED = 0xC0FFEE
LP_BACKENDS = ("auto", "xla", "kernel", "ipm")


def alp_tables(n: int):
    """The decoder's fixed tables, as the JAX package builds them with numpy:
    the objective perturbation direction ((n,) float32, ``alp.py:170-172``)
    and the two cut-hash weight vectors ((n,) int32 each, ``alp.py:61-68``).
    Returns (pert_dir, w1, w2) as numpy arrays."""
    rng = np.random.default_rng(_PERT_SEED)
    pert_dir = rng.uniform(-1.0, 1.0, n).astype(np.float32)
    rng = np.random.default_rng(_HASH_SEED)
    w1 = rng.integers(-2**31, 2**31 - 1, n, dtype=np.int64).astype(np.int32)
    w2 = rng.integers(-2**31, 2**31 - 1, n, dtype=np.int64).astype(np.int32)
    return pert_dir, w1, w2


@spanned("alp.cut_search")
def alp_cut_candidates(sup: torch.Tensor, u: torch.Tensor, cut_tol: float):
    """Vectorised AddRowsALP cut search.

    sup: (m, n) or (B, m, n) bool support masks; u: (B, n) current LP
    solution. Returns (rows (B, m, n) float32 signed cut rows, rhs (B, m)
    float32, add (B, m) bool).
    """
    u_b = u[:, None, :]                                   # (B, 1, n)
    if sup.dim() == 2:
        sup = sup.expand(u.shape[0], *sup.shape)
    n_size = sup.sum(dim=-1)                              # (B, m)
    dist = torch.where(sup, (u_b - 0.5).abs(), float("inf"))
    j_best = dist.argmin(dim=-1)                          # first minimum
    in_v = sup & (u_b > 0.5)
    flip = in_v.sum(dim=-1) % 2 == 0                      # (B, m)
    col = torch.arange(sup.shape[-1], device=u.device)
    is_best = col == j_best[..., None]
    is_v = torch.where(is_best & flip[..., None], u_b <= 0.5, u_b > 0.5) & sup
    viol = torch.where(is_v, 1.0 - u_b, torch.where(sup, u_b, 0.0)).sum(-1)
    add = (n_size > 0) & (viol < 1.0 - cut_tol)
    rows = torch.where(is_v, 1.0, torch.where(sup, -1.0, 0.0))
    rhs = (is_v.sum(dim=-1) - 1).to(torch.float32)
    return rows, rhs, add


@spanned("alp.cut_search")
def cut_hashes(rows: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor):
    """Two independent wraparound-int32 hashes of signed cut rows
    (B, m, n) -> ((B, m), (B, m)). Identical V-sets hash identically.

    JAX sums int32 products with wraparound. CUDA has no int32 matmul, so
    the products are summed exactly in int64 (|sum| < n * 2**31) and cast
    to int32, which wraps mod 2**32 to the same value."""
    ri = rows.to(torch.int64)
    return tuple((ri * w.to(torch.int64)).sum(dim=-1).to(torch.int32)
                 for w in (w1, w2))


@spanned("alp.append")
def append_cuts(a_buf, rhs_buf, count, rows, rhs, add,
                hash_state=None, cand_hashes=None):
    """Masked append of candidate cuts into the per-lane buffers.

    a_buf (B, R, n) f32, rhs_buf (B, R) f32, count (B,) int32; rows
    (B, m, n), rhs (B, m), add (B, m) bool. Candidates go to the next free
    slots in row order; those past the capacity R are dropped.

    With ``hash_state=(h1_buf, h2_buf)`` and ``cand_hashes=(h1c, h2c)``, a
    candidate equal to an active cut is suppressed and the appended cuts'
    hashes are recorded (a first-order solve leaves residual violations of
    about its tolerance, which would otherwise re-add the same cut every
    round until the buffer bursts).

    Unlike JAX's functional update, the buffers ``a_buf``, ``rhs_buf`` and
    the hash buffers are written in place (and returned). Returns (a_buf,
    rhs_buf, count, n_added, n_dup, n_dropped, hash_state); the counts are
    (B,) int32. The ``nonzero`` of the kept candidates is a host read.
    """
    bsz, cap = a_buf.shape[:2]
    n_dup = torch.zeros((bsz,), dtype=torch.int32, device=count.device)
    if hash_state is not None:
        h1_buf, h2_buf = hash_state
        h1c, h2c = cand_hashes
        slot = torch.arange(cap, device=count.device)
        live = slot[None, :] < count[:, None]
        dup = ((h1c[:, :, None] == h1_buf[:, None, :]) &
               (h2c[:, :, None] == h2_buf[:, None, :]) &
               live[:, None, :]).any(dim=-1)
        n_dup = (add & dup).sum(dim=1, dtype=torch.int32)
        add = add & ~dup
    add_i = add.to(torch.int32)
    pos = count[:, None] + add_i.cumsum(dim=1, dtype=torch.int32) - add_i
    keep = add & (pos < cap)
    lane, cand = keep.nonzero(as_tuple=True)
    slot = pos[lane, cand]
    a_buf[lane, slot] = rows[lane, cand]
    rhs_buf[lane, slot] = rhs[lane, cand]
    if hash_state is not None:
        h1_buf[lane, slot] = h1c[lane, cand]
        h2_buf[lane, slot] = h2c[lane, cand]
    n_added = keep.sum(dim=1, dtype=torch.int32)
    n_dropped = add.sum(dim=1, dtype=torch.int32) - n_added
    return a_buf, rhs_buf, count + n_added, n_added, n_dup, n_dropped, \
        hash_state


class _AdaptiveLPBase(nn.Module):
    """Shared cut-loop driver of the adaptive LP decoders.

    ``lp_backend``: ``"xla"`` is the plain PDHG solver :func:`pdhg_box_lp`
    (the name is the JAX package's, so configurations carry across);
    ``"kernel"`` is the fused path :func:`pdhg_box_lp_fused`, whose chunks
    run the CUDA kernel on a CUDA tensor and its plain twin on a CPU tensor;
    ``"auto"`` is ``"kernel"`` on CUDA and ``"xla"`` on the CPU; ``"ipm"`` is
    the batched interior-point solver :func:`..ops.ipm_solver.ipm_box_lp`,
    warm-started from the previous round, whose matvec and factor backends
    are the attributes ``ipm_matvec_backend`` and ``ipm_factor_backend``
    (``"auto"``: the kernels on CUDA, the plain twins on the CPU) and whose
    CUDA graphs are ``ipm_graphs`` (None: on CUDA; False: the eager loop).
    Subclasses with ``use_gauss`` add the Gaussian-elimination cut source
    (:meth:`_gauss_sup`, AGC-ALP).
    """

    use_gauss = False

    def __init__(self, h, max_rows: int, max_rounds: int, lp_iters: int,
                 int_tol: float, cut_tol: float = 1e-3,
                 snap_tol: float = 0.02, perturb: float = 1e-3,
                 lp_backend: str = "auto",
                 device: torch.device | str = "cuda"):
        super().__init__()
        device = resolve_device(device)
        h = np.asarray(h, dtype=np.uint8) % 2
        self.m, self.n = h.shape
        self.max_rows = int(max_rows)
        self.max_rounds = int(max_rounds)
        self.lp_iters = int(lp_iters)
        self.int_tol = float(int_tol)
        self.cut_tol = float(cut_tol)
        self.snap_tol = float(snap_tol)
        self.perturb = float(perturb)
        # IPM budget and tolerance (lp_backend="ipm"): ~35 Newton steps reach
        # mu ~ 1e-6; tol is on max(mu, |r_p|, |r_d|) in scaled units; 5-step
        # chunks (the plateau rule needs two non-improving boundaries, so a
        # solve pays at least ~3 chunks); warm start from the last round
        self.ipm_iters = 40
        self.ipm_tol = 1e-5
        self.ipm_check_every = 5
        self.ipm_warm = True
        self.ipm_matvec_backend = "auto"
        self.ipm_factor_backend = "auto"
        # the solve as CUDA graphs (None: on CUDA; False: the eager loop)
        self.ipm_graphs = None
        # adaptive inner-solve budget: chunks of lp_iters up to lp_max_iters,
        # stopping when the worst batch error is below lp_tol; the cut
        # threshold must exceed it, else residual violations on existing
        # cuts read as fresh cuts and lanes never finish
        self.lp_tol = 3e-4
        self.lp_max_iters = max(8 * self.lp_iters, 4000)
        # chunk- and round-level stagnation: stop when the error improves
        # by less than 20 % per step of the respective loop
        self.stall_ratio = 0.8
        # capacity: the reference checks `rows < max_rows` BEFORE a round
        # and lets the final round overshoot (agc_alp.h:99-101), so pad by
        # up to 2m cuts, rounded up to a multiple of 128
        self.capacity = -(-(self.max_rows + 2 * self.m) // 128) * 128
        # row tiers: 128-steps up to 512, then 256-steps from 640
        fine = list(range(128, min(512, self.capacity) + 1, 128))
        coarse = list(range(640, self.capacity, 256))
        self._tiers = tuple(t for t in fine + coarse if t < self.capacity)
        if lp_backend not in LP_BACKENDS:
            raise ValueError(f"unknown lp_backend {lp_backend!r}; known: "
                             f"{LP_BACKENDS}")
        if lp_backend == "auto":
            lp_backend = "kernel" if device.type == "cuda" else "xla"
        self.lp_backend = lp_backend
        # the cut threshold must exceed the solver's coordinate noise, else
        # residual violations on existing cuts read as fresh cuts and lanes
        # never finish; the binding noise floor is the backend's
        solver_tol = self.ipm_tol if lp_backend == "ipm" else self.lp_tol
        if not self.cut_tol > solver_tol:
            raise ValueError(f"cut_tol {self.cut_tol} below the {lp_backend} "
                             f"solver's tol {solver_tol}")
        pert_dir, w1, w2 = alp_tables(self.n)
        for name, arr in (("h", h), ("sup", h.astype(bool)),
                          ("pert_dir", pert_dir), ("hash_w1", w1),
                          ("hash_w2", w2)):
            self.register_buffer(name, torch.from_numpy(arr).to(device))

    def _gauss_sup(self, x, need=None):
        """(B, m, n) bool supports of the solution-adapted (eliminated) H,
        the extra cut source of lanes whose H cuts ran dry; ``need`` (B,)
        marks the lanes whose rows are used. Only decoders with
        ``use_gauss`` have one."""
        raise NotImplementedError(
            f"{type(self).__name__} has no Gaussian-elimination cut source")

    def _init_state(self, llrs: torch.Tensor) -> dict:
        """Fresh per-lane cut-loop state."""
        bsz = llrs.shape[0]
        dev = llrs.device
        c = llrs.to(torch.float32)
        cap = self.capacity
        # generic objective tilt (~0.1 %): a first-order method lands inside
        # the optimal face, where the odd-set search finds far fewer cuts
        # than at a vertex; the tilt makes the optimum a unique vertex
        if self.perturb:
            scale = c.abs().mean(dim=1, keepdim=True)
            c = c + self.perturb * scale * self.pert_dir[None]

        def zeros(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        i32 = torch.int32
        return {
            "c": c,
            "x": (c < 0.0).to(torch.float32),    # exact box-LP optimum
            "y": zeros(bsz, cap),
            "a": zeros(bsz, cap, self.n),
            "rhs": zeros(bsz, cap),
            "count": zeros(bsz, dtype=i32),
            "done": zeros(bsz, dtype=torch.bool),
            "viol": zeros(bsz),
            "viol_prev": torch.full((bsz,), float("inf"), device=dev),
            "dropped": zeros(bsz, dtype=i32),
            "rounds": zeros(bsz, dtype=i32),
            "cum_h": zeros(bsz, dtype=i32),      # H cuts appended
            "cum_g": zeros(bsz, dtype=i32),      # gauss cuts appended
            "h1": zeros(bsz, cap, dtype=i32),
            "h2": zeros(bsz, cap, dtype=i32),
        }

    def _tier(self, r_max: int) -> int:
        """The smallest row tier covering ``r_max`` active cuts."""
        tiers = [t for t in self._tiers if t < self.capacity] + \
            [self.capacity]
        return tiers[sum(r_max > t for t in tiers[:-1])]

    def _solve(self, c, a_buf, rhs_buf, x, y, act, t: int, n_act: int):
        """Solve min c.x s.t. a_buf[:, :t] x <= rhs_buf[:, :t], box, with the
        decoder's backend, for the ``n_act`` lanes of ``act``. Returns
        (x, y[:, :t], err)."""
        if self.lp_backend == "ipm":
            warm = {"x0": x, "y0": y[:, :t]} if self.ipm_warm else {}
            return ipm_box_lp(c, a_buf[:, :t], rhs_buf[:, :t],
                              iters=self.ipm_iters, tol=self.ipm_tol,
                              check_every=self.ipm_check_every, active=act,
                              matvec_backend=self.ipm_matvec_backend,
                              factor_backend=self.ipm_factor_backend,
                              graphs=self.ipm_graphs, **warm)
        args = (c, a_buf[:, :t], rhs_buf[:, :t], x, y[:, :t],
                self.lp_max_iters)
        kw = dict(tol=self.lp_tol, check_every=self.lp_iters, active=act,
                  stall_ratio=self.stall_ratio)
        if self.lp_backend == "xla" or t % 128 != 0:
            return pdhg_box_lp(*args, **kw)
        return pdhg_box_lp_fused(*args, lanes=n_act, **kw)

    @spanned("alp.round")
    def _round_body(self, state: dict) -> dict:
        """One cut round (search + append + re-solve) over a state dict.
        The buffers in ``state`` are updated in place."""
        c, x, y = state["c"], state["x"], state["y"]
        count, done = state["count"], state["done"]
        viol, viol_prev = state["viol"], state["viol_prev"]
        # per-lane diagnostic: rounds in which this lane actually worked
        lane_rounds = state["rounds"] + (~done).to(torch.int32)
        eligible = ~done & (count < self.max_rows)
        # snap near-integral coordinates to exactly 0/1 for the cut search
        # only: a first-order solve leaves ~1e-2 noise that accumulates
        # over a cut row's support and masks violated cuts
        x_s = torch.where(x < self.snap_tol, 0.0,
                          torch.where(x > 1.0 - self.snap_tol, 1.0, x))
        rows, rhs, add = alp_cut_candidates(self.sup, x_s, self.cut_tol)
        add_h = add & eligible[:, None]
        a_buf, rhs_buf, count, n_h, _, drop_h, hstate = append_cuts(
            state["a"], state["rhs"], count, rows, rhs, add_h,
            hash_state=(state["h1"], state["h2"]),
            cand_hashes=cut_hashes(rows, self.hash_w1, self.hash_w2))
        COUNTS["reads.append"] += 1
        dropped = state["dropped"] + drop_h
        n_added, cum_g = n_h, state["cum_g"]
        if self.use_gauss:
            # gauss cuts only for lanes that added no H cut this round (the
            # reference's short-circuit, agc_alp.h:99-101); one host read
            # skips the elimination when no lane needs it
            need = eligible & (n_h == 0)
            COUNTS["reads.need"] += 1
            if bool(need.any()):
                g_sup = self._gauss_sup(x_s, need)
                # gauss_margin relaxes the threshold of the dense gauss rows
                g_rows, g_rhs, g_add = alp_cut_candidates(
                    g_sup, x_s, self.cut_tol - self.gauss_margin)
                a_buf, rhs_buf, count, n_g, _, drop_g, hstate = append_cuts(
                    a_buf, rhs_buf, count, g_rows, g_rhs,
                    g_add & need[:, None], hash_state=hstate,
                    cand_hashes=cut_hashes(g_rows, self.hash_w1,
                                           self.hash_w2))
                COUNTS["reads.append_g"] += 1
                n_added = n_h + n_g
                cum_g = cum_g + n_g
                dropped = dropped + drop_g
        # a lane is finished when its search yields no NEW cut and its LP
        # solve is as good as it will get: converged (error <= lp_tol) or
        # plateaued (error stopped improving across rounds)
        stalled = viol >= self.stall_ratio * viol_prev
        done = done | ((n_added == 0) & ((viol <= self.lp_tol) | stalled))
        act = ~done
        with span("alp.tier_read"):
            r_max, n_act = torch.stack([torch.where(done, 0, count).max(),
                                        act.sum(dtype=torch.int32)]).tolist()
        COUNTS["reads.tier"] += 1
        COUNTS["lanes"] += done.shape[0]
        COUNTS["solve_lanes"] += n_act
        if n_act > 0:
            # re-solve on the smallest row tier covering every working
            # lane's cuts (rows >= count are zero and would only cost
            # bandwidth); frozen lanes keep their x, y
            t = self._tier(r_max)
            x_new, y_t, viol_new = self._solve(c, a_buf, rhs_buf, x, y, act,
                                               t, n_act)
            keep = done[:, None]
            x = torch.where(keep, x, x_new)
            y[:, :t] = torch.where(keep, y[:, :t], y_t)
        else:   # JAX's solve would pass every lane through unchanged
            viol_new = viol
        # viol_prev stays inert (inf) until two real solves exist: a lane's
        # first worked round enters with the trivial 0 of the box optimum
        viol_prev = torch.where(lane_rounds == 1, float("inf"), viol)
        viol = torch.where(done, 0.0, viol_new)
        done = done | (lane_rounds >= self.max_rounds)
        return {"c": c, "x": x, "y": y, "a": a_buf, "rhs": rhs_buf,
                "count": count, "done": done, "viol": viol,
                "viol_prev": viol_prev, "dropped": dropped,
                "rounds": lane_rounds, "cum_h": state["cum_h"] + n_h,
                "cum_g": cum_g, "h1": hstate[0], "h2": hstate[1]}

    def _check_device(self, llrs: torch.Tensor) -> None:
        if llrs.device != self.h.device:
            raise ValueError(f"llrs on {llrs.device}, decoder on "
                             f"{self.h.device}")

    @spanned("alp.done_read")
    def _all_done(self, st: dict) -> bool:
        """Whether every lane is done: one host read."""
        COUNTS["reads.done"] += 1
        return bool(st["done"].all())

    def _run_loop(self, llrs: torch.Tensor) -> dict:
        self._check_device(llrs)
        state = self._init_state(llrs)
        while not self._all_done(state):
            state = self._round_body(state)
        return state

    def _finish(self, st: dict) -> DecodeResult:
        x = st["x"]
        bits = (x > 0.5).to(torch.uint8)
        integral = ((x < self.int_tol) | (x > 1.0 - self.int_tol)).all(-1)
        success = integral & is_codeword(self.h, bits)
        return DecodeResult(bits=bits, success=success,
                            iterations=st["rounds"], dropped=st["dropped"])

    @spanned("alp.decode")
    def decode_batch(self, llrs: torch.Tensor) -> DecodeResult:
        """(B, n) float32 LLRs on the decoder's device -> DecodeResult
        (``iterations`` = cut rounds worked, ``dropped`` = cuts lost to
        the capacity)."""
        return self._finish(self._run_loop(llrs))

    # ------------------------------------------------------------------
    # Streaming protocol (harness.experiment.run_streaming_experiment): one
    # chunk is one cut round; finished lanes are drained between rounds and
    # their slots refilled from the trial stream, so a lane that spins to
    # the round budget no longer holds the whole batch.
    def stream_init(self, llrs: torch.Tensor) -> dict:
        self._check_device(llrs)
        return self._init_state(llrs)

    def stream_chunk(self, st: dict) -> dict:
        """One cut round; nothing when every lane is done (one host
        read)."""
        if self._all_done(st):
            return st
        return self._round_body(st)

    def stream_done(self, st: dict) -> torch.Tensor:
        return st["done"]

    def stream_finish(self, st: dict) -> DecodeResult:
        return self._finish(st)

    def stats(self, llrs: torch.Tensor) -> dict:
        """Cut-loop telemetry: per-lane final active-cut count, rounds
        worked, integrality, done flag, error, drops and cuts appended."""
        st = self._run_loop(llrs)
        x = st["x"]
        integral = ((x < self.int_tol) | (x > 1.0 - self.int_tol)).all(-1)
        return {"count": st["count"], "rounds": st["rounds"],
                "integral": integral, "done": st["done"],
                "viol": st["viol"], "dropped": st["dropped"],
                "cum_h": st["cum_h"], "cum_g": st["cum_g"]}


class ALPDecoder(_AdaptiveLPBase):
    """Adaptive LP decoder (``ALPDecoder``, ``alp.h:99-138``). The reference
    has no row cap for plain ALP; ``max_rows`` defaults to ``max(512, 2m)``
    (one round can add up to m cuts, so a cap below ~2m binds on larger
    codes). The inner solve runs 64-step chunks up to 2048 steps.
    ``prefer_streaming`` is False: ``run_experiment``'s ``streaming="auto"``
    keeps ALP on the batched runner, as the JAX package does
    (``alp.py:480``); ``streaming=True`` streams it."""

    use_gauss = False
    prefer_streaming = False

    def __init__(self, h, max_rounds: int = 64, lp_iters: int = 64,
                 int_tol: float = 3e-2, max_rows: int | None = None,
                 cut_tol: float = 1e-3, lp_backend: str = "auto",
                 device: torch.device | str = "cuda"):
        if max_rows is None:
            max_rows = max(512, 2 * int(np.asarray(h).shape[0]))
        super().__init__(h, max_rows=max_rows, max_rounds=max_rounds,
                         lp_iters=lp_iters, int_tol=int_tol, cut_tol=cut_tol,
                         lp_backend=lp_backend, device=device)
        self.lp_max_iters = 2048
        self.name = "ALP"
