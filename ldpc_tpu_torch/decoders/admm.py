"""Batched penalized QP-ADMM LDPC decoding (paper arXiv:1910.12712;
counterpart of ``ldpc_tpu/decoders/admm.py``).

The per-trial sparse problem of the reference (``ConstructADMMProblem``,
``qp_admm.h:13-102``) depends only on H, so it is built once on the host as
padded index and coefficient tables (:class:`ADMMStructure`). The iteration
(``qp_admm.h:130-163``) is gathers and elementwise updates over a
``(B, n_var)`` / ``(B, n_con)`` batch, with the scalar code's early
``break`` (``sum2 < eps_stop``) as a per-lane done mask: a done lane is
frozen, so each lane gives what the scalar code gives.

Cascade construction (``qp_admm.h:58-93``):

* degree-1 check on x:            x <= 0
* degree-2 check on (x_i, x_j):   x_i - x_j <= 0 and x_j - x_i <= 0
* degree-d (d >= 3): a chain of d-2 three-variable parity constraints
  through d-3 auxiliary variables; each 3-variable check (i, j, h) gives
  the four inequalities (+,-,-) <= 0, (-,+,-) <= 0, (-,-,+) <= 0,
  (+,+,+) <= 2 (``add_three``, ``qp_admm.h:34-57``).

The certificate is True whenever the precondition ``min(e) * mu > alpha``
holds; otherwise the whole batch fails with the all-zero word
(``qp_admm.h:108-114,166``).

:func:`decode_qp_admm_population` decodes P candidate matrices at once,
each over its own tables padded to shared capacities (the matrix
optimizer's population; JAX ``vmap``s the single decode over them), each
candidate held to its own precondition. The single decode is its P = 1
case.

Each iteration runs in :func:`..ops.admm_kernel.admm_iterate`: on the card
one launch of the hand-written kernel (``csrc/admm_iterate.cu``) per decode
or per stream chunk, in which every (lane, candidate) pair iterates in
shared memory to its own stop, and the host reads nothing inside it; on
the CPU its plain twin (``ops/admm_ref.py``), which runs in blocks of
``CHECK_EVERY`` (32) iterations with one host read of ``all(done)`` before
each, never past ``max_iter``. Running iterations past a pair's stop would
change nothing: a done pair is frozen and its count is not advanced. Sums
are taken in the JAX package's order: each variable's ``k_max`` slots one
after another in slot order (padding slots add exact zeros), each
constraint's three slots likewise.

While a profiler records, a decode is the span ``admm.decode`` and the
stream's methods are ``admm.init``, ``admm.chunk`` (the kernel's launch)
and ``admm.finish``. :data:`COUNTS` counts the decoder's work on the host,
from shapes and calls alone: ``decodes``, ``chunks`` (calls of
``stream_chunk``, on the card one launch each) and ``lanes_started`` (the
rows handed to a decode or to ``stream_init``). Neither reads the device.
"""
from __future__ import annotations

from collections import Counter
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from .. import _native
from ..ops.admm_kernel import admm_iterate, pack_tables
from ..ops.admm_ref import CHECK_EVERY, lane_param
from ..utils.profiling import spanned
from .base import DecodeResult, resolve_device

__all__ = ["ADMMStructure", "COUNTS", "QPADMMDecoder", "decode_qp_admm",
           "decode_qp_admm_population"]

# the decoder's work (the module's docstring), summed over the process
COUNTS: Counter = Counter()

# ADMMStructure's tables, in the order the decoders stack them
TABLES = ("con_var", "con_coef", "b", "var_con", "var_coef", "e")


def _structure_caps(h: np.ndarray) -> tuple[int, int, int]:
    """Exact (n_var, n_con, k_max) for the cascade of H, vectorised."""
    h = np.asarray(h, dtype=np.uint8) % 2
    n = h.shape[1]
    deg = h.sum(axis=1).astype(np.int64)
    n_aux = int(np.maximum(deg - 3, 0).sum())
    n_con = int(np.where(deg >= 3, 4 * np.maximum(deg - 2, 0),
                         np.where(deg == 2, 2, deg)).sum())
    # per-variable constraint-entry counts: a variable in a degree-d check
    # gains 4 (d >= 3 cascade), 2 (d == 2) or 1 (d == 1) entries; each
    # auxiliary variable gains 8
    contrib = np.where(deg >= 3, 4, np.where(deg == 2, 2, 1))
    k_var = (h.astype(np.int64) * contrib[:, None]).sum(axis=0)
    k_max = int(k_var.max(initial=0))
    if (deg >= 4).any():
        k_max = max(k_max, 8)
    return n + n_aux, n_con, max(k_max, 1)


@dataclass(frozen=True)
class ADMMStructure:
    """Static constraint structure of the cascaded parity polytope (host)."""

    n: int                    # codeword length
    n_var: int                # n + auxiliary variables
    n_con: int                # constraint rows
    con_var: np.ndarray       # (n_con, 3) int32 var index per slot; pad n_var
    con_coef: np.ndarray      # (n_con, 3) float32; pad 0
    b: np.ndarray             # (n_con,) float32 right-hand sides
    var_con: np.ndarray       # (n_var, k_max) int32 con index; pad n_con
    var_coef: np.ndarray      # (n_var, k_max) float32; pad 0
    e: np.ndarray             # (n_var,) float32: sum of squared coefficients

    @staticmethod
    def from_h(h: np.ndarray, n_var_cap: int | None = None,
               n_con_cap: int | None = None,
               k_max_cap: int | None = None) -> "ADMMStructure":
        """Build the cascade from H. Optional caps pad the tables to fixed
        capacities, so that structures of different H with the same caps
        stack. The host core (``_native``) builds the tables when the caps
        cover the cascade, as in the JAX package; otherwise, or when
        ``LDPC_TPU_NO_NATIVE`` is set, :func:`_from_h_numpy` does, which
        gives the same tables and raises ``ValueError`` on caps below the
        cascade."""
        h = np.asarray(h, dtype=np.uint8) % 2
        need = _structure_caps(h)
        caps = [c or c_min for c, c_min in
                zip((n_var_cap, n_con_cap, k_max_cap), need)]
        if all(c >= c_min for c, c_min in zip(caps, need)):
            out = _native.admm_build(h, *caps)
            if out is not None:
                return ADMMStructure(n=h.shape[1], n_var=caps[0],
                                     n_con=caps[1],
                                     **{k: out[k] for k in TABLES})
        return _from_h_numpy(h, n_var_cap, n_con_cap, k_max_cap)

    @property
    def e_min(self) -> float:
        """min(e) over the real variables (phantom capacity rows have
        e == 0)."""
        real = self.e[self.e > 0]
        return float(real.min()) if real.size else float("inf")


def _from_h_numpy(h: np.ndarray, n_var_cap: int | None = None,
                  n_con_cap: int | None = None,
                  k_max_cap: int | None = None) -> ADMMStructure:
    """``ADMMStructure.from_h`` in NumPy."""
    h = np.asarray(h, dtype=np.uint8) % 2
    m, n = h.shape
    cons: list[tuple[list[int], list[float], float]] = []

    def add(varids, coefs, rhs):
        cons.append((list(varids), list(coefs), float(rhs)))

    def add_three(i, j, k):
        add([i, j, k], [1.0, -1.0, -1.0], 0.0)
        add([i, j, k], [-1.0, 1.0, -1.0], 0.0)
        add([i, j, k], [-1.0, -1.0, 1.0], 0.0)
        add([i, j, k], [1.0, 1.0, 1.0], 2.0)

    pos = n
    for i in range(m):
        idx = np.nonzero(h[i])[0].tolist()
        if not idx:
            continue
        if len(idx) == 1:
            add([idx[0]], [1.0], 0.0)
            continue
        if len(idx) == 2:
            add([idx[0], idx[1]], [1.0, -1.0], 0.0)
            add([idx[0], idx[1]], [-1.0, 1.0], 0.0)
            continue
        last = idx[0]
        for j in range(1, len(idx) - 2):
            aux = pos
            pos += 1
            add_three(last, idx[j], aux)
            last = aux
        add_three(last, idx[-2], idx[-1])

    n_var = pos
    n_con = len(cons)
    nv = n_var_cap or n_var
    nc = n_con_cap or n_con
    if nv < n_var or nc < n_con:
        raise ValueError(f"caps ({nv}, {nc}) below the cascade's "
                         f"({n_var}, {n_con})")

    con_var = np.full((nc, 3), nv, dtype=np.int32)
    con_coef = np.zeros((nc, 3), dtype=np.float32)
    b = np.zeros((nc,), dtype=np.float32)
    per_var: list[list[tuple[int, float]]] = [[] for _ in range(nv)]
    for ci, (vids, cfs, rhs) in enumerate(cons):
        b[ci] = rhs
        for s, (vi, cf) in enumerate(zip(vids, cfs)):
            con_var[ci, s] = vi
            con_coef[ci, s] = cf
            per_var[vi].append((ci, cf))

    k_max = k_max_cap or max((len(p) for p in per_var), default=1)
    if any(len(p) > k_max for p in per_var):
        raise ValueError(f"k_max cap {k_max} below the cascade's")
    var_con = np.full((nv, k_max), nc, dtype=np.int32)
    var_coef = np.zeros((nv, k_max), dtype=np.float32)
    e = np.zeros((nv,), dtype=np.float32)
    for vi, plist in enumerate(per_var):
        for s, (ci, cf) in enumerate(plist):
            var_con[vi, s] = ci
            var_coef[vi, s] = cf
            e[vi] += cf * cf
    # capacity-padded phantom variables get e == 0; e_min leaves them out
    return ADMMStructure(n=n, n_var=nv, n_con=nc, con_var=con_var,
                         con_coef=con_coef, b=b, var_con=var_con,
                         var_coef=var_coef, e=e)


def _objective(llrs: torch.Tensor, n_var: int) -> torch.Tensor:
    """q: (B, P, n) LLRs padded with zeros for each candidate's auxiliary
    variables, as a (B, P * n_var) row per lane."""
    llrs = llrs.to(torch.float32)
    bsz, p, n = llrs.shape
    return torch.cat([llrs, llrs.new_zeros((bsz, p, n_var - n))],
                     dim=2).view(bsz, p * n_var)


def _feasible_lanes(e: torch.Tensor, alpha, mu) -> torch.Tensor:
    """(B, P) bool: the precondition ``min(e) * mu > alpha``
    (``qp_admm.h:108-114``) per lane and candidate, ``min(e)`` over each
    candidate's own real (``e > 0``) entries of ``e`` (P, nv), in float32
    as the JAX package evaluates it."""
    inf = torch.full((), float("inf"), dtype=torch.float32, device=e.device)
    e_min = torch.where(e > 0, e, inf).amin(dim=-1)
    return e_min[None, :] * mu > alpha


def decode_qp_admm_population(tables: dict, n: int, llrs: torch.Tensor,
                              alpha, mu, max_iter: int,
                              eps_stop: float) -> DecodeResult:
    """QP-ADMM decode of P candidate structures at once: ``tables`` as
    :func:`..ops.admm_ref.admm_iterate_ref`'s, with a leading candidate axis
    (each candidate padded to shared caps by ``ADMMStructure.from_h(h,
    **caps)``; on the card it may carry the kernel's packed copy,
    :func:`..ops.admm_kernel.pack_tables`), ``llrs`` (P, T, n) float32.
    ``alpha`` and ``mu`` are scalars or (T,) tensors. Returns bits (P, T,
    n), success (P, T) and iterations (P, T); each (candidate, lane) pair
    gives what ``decode_qp_admm`` gives on its candidate's tables alone
    (the JAX package ``vmap``s that decode over the candidates,
    ``apps/optimize_h.py:90-98``). On the card the iterations are one
    launch of the kernel."""
    p_count, bsz = llrs.shape[:2]
    dev = llrs.device
    n_var, n_con = tables["var_con"].shape[1], tables["con_var"].shape[1]
    q = _objective(llrs.transpose(0, 1), n_var)          # (T, P * nv)
    v = (q > 0.0).to(torch.float32)                     # qp_admm.h:116-119
    z = q.new_zeros((bsz, p_count * n_con))
    yl = q.new_zeros((bsz, p_count * n_con))
    done = torch.zeros((bsz, p_count), dtype=torch.bool, device=dev)
    it = torch.zeros((bsz, p_count), dtype=torch.int32, device=dev)
    # from fresh pairs the final count is JAX's done_it: j + 1 for a pair
    # that converged at loop index j, else max_iter
    v, _, _, _, it = admm_iterate(q, v, z, yl, done, it, tables, alpha, mu,
                                  eps_stop, max_iter, max_iter,
                                  check_every=CHECK_EVERY)
    ok = _feasible_lanes(tables["e"], lane_param(alpha, bsz, dev),
                         lane_param(mu, bsz, dev))       # (T, P)
    bits = (v.view(bsz, p_count, n_var)[:, :, :n] > 0.5) & ok[:, :, None]
    return DecodeResult(bits=bits.to(torch.uint8).transpose(0, 1
                                                          ).contiguous(),
                        success=ok.t().contiguous(),
                        iterations=it.t().contiguous())


def _one(tables: dict) -> dict:
    """One structure's tables as a population of one."""
    return {name: t[None] for name, t in tables.items()}


def decode_qp_admm(tables: dict, n: int, llrs: torch.Tensor, alpha, mu,
                   max_iter: int, eps_stop: float) -> DecodeResult:
    """QP-ADMM decode of a (B, n) float32 batch over one structure's
    tensors (:func:`decode_qp_admm_population`'s without the candidate
    axis): the population decode with P = 1. ``alpha`` and ``mu`` are
    scalars or (B,) tensors: each lane runs with its own pair and its own
    precondition."""
    res = decode_qp_admm_population(_one(tables), n, llrs[None], alpha, mu,
                                    max_iter, eps_stop)
    return DecodeResult(bits=res.bits[0], success=res.success[0],
                        iterations=res.iterations[0])


class QPADMMDecoder(nn.Module):
    """Penalised-objective ADMM decoder specialised to one H, its structure
    tables as buffers.

    Defaults are the reference's OPTIMAL configuration: alpha = 1.2,
    mu = 0.55, max_iter = 10000, eps_stop = 1e-5 (``main.cpp:30-34``).
    """

    # the streaming protocol (harness.experiment.run_streaming_experiment):
    # chunks of stream_chunk_iters iterations; finished lanes are refilled
    # between chunks, so a batch no longer waits on its slowest lane
    stream_chunk_iters = 512

    def __init__(self, h, alpha: float = 1.2, mu: float = 0.55,
                 max_iter: int = 10000, eps_stop: float = 1e-5,
                 structure: ADMMStructure | None = None,
                 device: torch.device | str = "cuda"):
        super().__init__()
        device = resolve_device(device)
        self.name = "QP-ADMM"
        self.structure = s = structure or ADMMStructure.from_h(np.asarray(h))
        self.n = s.n
        self.alpha = float(alpha)
        self.mu = float(mu)
        self.max_iter = int(max_iter)
        self.eps_stop = float(eps_stop)
        for name in ("con_var", "con_coef", "b", "var_con", "var_coef", "e"):
            self.register_buffer(name, torch.from_numpy(
                np.ascontiguousarray(getattr(s, name))).to(device))
        self._pop = None

    @property
    def tables(self) -> dict:
        return {"con_var": self.con_var, "con_coef": self.con_coef,
                "b": self.b, "var_con": self.var_con,
                "var_coef": self.var_coef, "e": self.e}

    def _population(self) -> dict:
        """The tables as a population of one; on the card with the
        kernel's packed copy, made at first use (and again if the buffers
        moved)."""
        if self._pop is None or self._pop["e"].device != self.e.device:
            tables = _one(self.tables)
            self._pop = (pack_tables(tables) if self.e.device.type == "cuda"
                         else tables)
        return self._pop

    def _check(self, llrs: torch.Tensor) -> None:
        if llrs.device != self.e.device:
            raise ValueError(f"llrs on {llrs.device}, decoder on "
                             f"{self.e.device}")

    @spanned("admm.decode")
    def decode_batch(self, llrs: torch.Tensor) -> DecodeResult:
        """(B, n) float32 LLRs on the decoder's device -> DecodeResult."""
        return self._decode(llrs, self.alpha, self.mu)

    @spanned("admm.decode")
    def decode_batch_params(self, llrs: torch.Tensor, alpha,
                            mu) -> DecodeResult:
        """Decode with per-call (alpha, mu): scalars, or (B,) tensors giving
        each lane its own pair (the grid search's cells as a batch axis)."""
        return self._decode(llrs, alpha, mu)

    def _decode(self, llrs: torch.Tensor, alpha, mu) -> DecodeResult:
        self._check(llrs)
        COUNTS["decodes"] += 1
        COUNTS["lanes_started"] += llrs.shape[0]
        res = decode_qp_admm_population(self._population(), self.n,
                                        llrs[None], alpha, mu,
                                        self.max_iter, self.eps_stop)
        return DecodeResult(bits=res.bits[0], success=res.success[0],
                            iterations=res.iterations[0])

    # ------------------------------------------------------------------

    @spanned("admm.init")
    def stream_init(self, llrs: torch.Tensor) -> dict:
        """Fresh per-lane solver state for a batch of LLRs."""
        self._check(llrs)
        bsz, dev = llrs.shape[0], llrs.device
        COUNTS["lanes_started"] += bsz
        q = _objective(llrs[:, None], self.structure.n_var)
        n_con = self.structure.n_con
        return {"q": q, "v": (q > 0.0).to(torch.float32),
                "z": q.new_zeros((bsz, n_con)),
                "yl": q.new_zeros((bsz, n_con)),
                "done": torch.zeros((bsz,), dtype=torch.bool, device=dev),
                "it": torch.zeros((bsz,), dtype=torch.int32, device=dev)}

    @spanned("admm.chunk")
    def stream_chunk(self, state: dict) -> dict:
        """Up to ``stream_chunk_iters`` iterations of the lanes that are not
        done: on the card one launch of the kernel, which updates the
        state's tensors in place; on the CPU the twin, in blocks of
        ``CHECK_EVERY`` with one host read of ``all(done)`` before each (so
        a chunk of done lanes costs one read and no iteration).

        A lane is done when it converged (``sum2 < eps_stop``) or its own
        iteration count reached ``max_iter``; the counts are per lane, so a
        refilled lane starts from 0.
        """
        q = state["q"]
        COUNTS["chunks"] += 1
        v, z, yl, done, it = admm_iterate(
            q, state["v"], state["z"], state["yl"], state["done"][:, None],
            state["it"][:, None], self._population(), self.alpha, self.mu,
            self.eps_stop, self.max_iter, self.stream_chunk_iters,
            check_every=CHECK_EVERY)
        return {"q": q, "v": v, "z": z, "yl": yl, "done": done[:, 0],
                "it": it[:, 0]}

    def stream_done(self, state: dict) -> torch.Tensor:
        return state["done"]

    @spanned("admm.finish")
    def stream_finish(self, state: dict) -> DecodeResult:
        v = state["v"]
        bsz, dev = v.shape[0], v.device
        ok = _feasible_lanes(self.e[None], lane_param(self.alpha, bsz, dev),
                             lane_param(self.mu, bsz, dev))[:, 0]
        bits = ((v[:, :self.n] > 0.5) & ok[:, None]).to(torch.uint8)
        return DecodeResult(bits=bits, success=ok, iterations=state["it"])
