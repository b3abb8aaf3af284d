"""Python wrapper of QP-ADMM's hand-written iteration kernel
(``csrc/admm_iterate.cu``).

It has no Pallas counterpart: in ``ldpc_tpu/decoders/admm.py`` XLA fuses the
iteration (``iter_fn``, ``:249-262``) inside the decode's ``while_loop``
(``:184-197``) and the stream's (``:351-365``). :func:`admm_iterate` picks by
the device of ``q``: a CPU tensor goes to the plain twin
:func:`.admm_ref.admm_iterate_ref`, a CUDA tensor to the kernel, anything
else raises; nothing falls back. On CUDA it checks the state (dtypes,
shapes, contiguity, device), takes the launch layout from
:func:`admm_plan` (which raises for a pair too large for one block),
packs the tables (:func:`pack_tables`, unless given packed) and launches
once on the current stream without synchronising: every pair runs to its
own stop or to ``iters`` inside the launch, and the host reads nothing.
The kernel updates v, z, yl, done and it in place and the wrapper returns
them; the twin returns new tensors. Callers use the returned state either
way.

``ITERATE_LAUNCHES`` counts the kernel's launches, so a run can show that
its main path went through it.
"""
from __future__ import annotations

import torch

from .admm_ref import CHECK_EVERY, admm_iterate_ref, lane_param
from .gemv_kernel import _launch

ITERATE_LAUNCHES = 0
THREADS = 256          # kThreads of the source
MAX_SMEM = 232448      # the H100's opt-in shared memory per block
MAX_INDEX = 32766      # an index + 1 must fit an int16 code
BAD = -32768           # the code of an entry outside the kernel's contract
PACKED = ("var_code", "var_len", "con_code")

__all__ = ["ITERATE_LAUNCHES", "admm_iterate", "admm_plan", "pack_tables"]


def admm_plan(n_var: int, n_con: int) -> dict:
    """The kernel's launch layout for pairs of ``n_var`` variables and
    ``n_con`` constraints, as ``csrc/admm_iterate.cu`` computes it: one
    block of ``threads`` per pair, its q, v and inv_coef and its t, z and yl
    in ``smem_bytes`` of shared memory. Raises ``ValueError`` when a pair
    does not fit one block (at most 227 KB: n_var + n_con up to about
    19,370) or an index does not fit the int16 codes."""
    smem = 4 * (3 * n_var + 3 * n_con + THREADS // 32)
    if (n_var < 1 or n_con < 1 or max(n_var, n_con) > MAX_INDEX
            or smem > MAX_SMEM):
        raise ValueError(f"admm_plan: a pair of {n_var} variables and "
                         f"{n_con} constraints does not fit the kernel "
                         f"({smem} shared bytes of at most {MAX_SMEM}; "
                         f"indices below {MAX_INDEX})")
    return {"threads": THREADS, "smem_bytes": smem}


def _codes(idx: torch.Tensor, coef: torch.Tensor, pad: int) -> torch.Tensor:
    """int16 codes of a table's slots: +(index + 1) for coefficient +1,
    -(index + 1) for -1, 0 for padding (index ``pad``, coefficient 0),
    ``BAD`` for anything else."""
    idx = idx.to(torch.int32)
    real = (idx >= 0) & (idx < pad)
    code = torch.full_like(idx, BAD)
    code = torch.where(real & (coef == 1), idx + 1, code)
    code = torch.where(real & (coef == -1), -(idx + 1), code)
    code = torch.where((idx == pad) & (coef == 0), 0, code)
    return code.to(torch.int16)


def pack_tables(tables: dict) -> dict:
    """``tables`` (as :func:`admm_iterate`'s) with the kernel's packed copy
    added: ``var_code`` (P, k, n_var) and ``con_code`` (P, 3, n_con) int16,
    slot-major (:func:`_codes`), and ``var_len`` (P, n_var) int16, each
    variable's slots up to its last real one (at least 1). Plain tensor
    ops on the tables' device; the host reads nothing. The kernel traps on
    a ``BAD`` code."""
    var_con, con_var = tables["var_con"], tables["con_var"]
    n_var, k = var_con.shape[1:]
    n_con = con_var.shape[1]
    var_code = _codes(var_con, tables["var_coef"], n_con)
    slots = torch.arange(1, k + 1, dtype=torch.int32, device=var_con.device)
    var_len = ((var_code != 0) * slots).amax(dim=-1).clamp_min(1)
    return {**tables,
            "var_code": var_code.transpose(1, 2).contiguous(),
            "var_len": var_len.to(torch.int16).contiguous(),
            "con_code": _codes(con_var, tables["con_coef"], n_var
                               ).transpose(1, 2).contiguous()}


def _check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"admm_iterate: {name} is on {t.device}, not "
                         f"{device}")
    if t.dtype != dtype:
        raise TypeError(f"admm_iterate: {name} must be {dtype}, got "
                        f"{t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"admm_iterate: {name} must have shape "
                         f"{tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"admm_iterate: {name} must be contiguous")


def admm_iterate(q, v, z, yl, done, it, tables, alpha, mu, eps_stop: float,
                 max_iter: int, iters: int, sum2=None,
                 check_every: int = CHECK_EVERY):
    """Up to ``iters`` QP-ADMM iterations of every (lane, candidate) pair
    that is not done: :func:`.admm_ref.admm_iterate_ref`'s contract (its
    shapes, stop rule and ``sum2``). On CUDA ``tables`` may carry the packed
    copy of :func:`pack_tables` (else it is packed here), alpha and mu are
    made (B,) float32, the state is updated in place and returned, and
    ``check_every`` is not used: the host reads nothing."""
    global ITERATE_LAUNCHES
    dev = q.device
    if dev.type == "cpu":
        return admm_iterate_ref(q, v, z, yl, done, it, tables, alpha, mu,
                                eps_stop, max_iter, iters, sum2,
                                check_every)
    if dev.type != "cuda":
        raise ValueError(f"admm_iterate: no implementation for {dev}")
    if done.dim() != 2:
        raise ValueError(f"admm_iterate: done must be (B, P), got "
                         f"{tuple(done.shape)}")
    bsz, p_count = done.shape
    if not all(key in tables for key in PACKED):
        tables = pack_tables(tables)
    k, n_var = tables["var_code"].shape[1:]
    n_con = tables["con_code"].shape[2]
    plan = admm_plan(n_var, n_con)
    i16, f32 = torch.int16, torch.float32
    for name, t, dtype, shape in (
            ("q", q, f32, (bsz, p_count * n_var)),
            ("v", v, f32, (bsz, p_count * n_var)),
            ("z", z, f32, (bsz, p_count * n_con)),
            ("yl", yl, f32, (bsz, p_count * n_con)),
            ("done", done, torch.bool, (bsz, p_count)),
            ("it", it, torch.int32, (bsz, p_count)),
            ("var_code", tables["var_code"], i16, (p_count, k, n_var)),
            ("var_len", tables["var_len"], i16, (p_count, n_var)),
            ("con_code", tables["con_code"], i16, (p_count, 3, n_con)),
            ("b", tables["b"], f32, (p_count, n_con)),
            ("e", tables["e"], f32, (p_count, n_var))) + (
            () if sum2 is None else
            (("sum2", sum2, f32, (bsz, p_count)),)):
        _check(name, t, dtype, shape, dev)
    alpha_l = lane_param(alpha, bsz, dev).reshape(-1).contiguous()
    mu_l = lane_param(mu, bsz, dev).reshape(-1).contiguous()
    if bsz:
        _launch("admm_iterate", "ldpc_admm_iterate", q, v, z, yl, done, it,
                tables["var_code"], tables["var_len"], tables["con_code"],
                tables["b"], tables["e"], alpha_l, mu_l,
                0 if sum2 is None else sum2, bsz, p_count, n_var, n_con, k,
                float(eps_stop), int(max_iter), int(iters), plan["threads"],
                plan["smem_bytes"])
        ITERATE_LAUNCHES += 1
    return v, z, yl, done, it
