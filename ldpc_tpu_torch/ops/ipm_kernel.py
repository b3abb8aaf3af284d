"""Python wrappers of the IPM Newton step's two hand-written kernels
(``csrc/ipm_step.cu``): the step lengths and the masked update.

They have no Pallas counterpart: in ``ldpc_tpu/ops/ipm_solver.py`` XLA fuses
this elementwise work (``:222-267``). Each wrapper picks by the device of its
first tensor: a CPU tensor goes to its plain twin in :mod:`.ipm_ref`, a CUDA
tensor to the kernel, anything else raises; nothing falls back. On CUDA a
wrapper checks its inputs (float32, contiguous, the shapes of one solve) and
launches on the current stream without synchronising.

``ipm_update`` on CUDA writes the new state into the state's own tensors
and returns them; its twin returns new tensors. Callers use the returned
state either way.

``STEP_LEN_LAUNCHES`` and ``UPDATE_LAUNCHES`` count each kernel's launches,
so a run can show that its main path went through them.
"""
from __future__ import annotations

import torch

from .gemv_kernel import _launch
from .ipm_ref import FLOOR, FRAC, ipm_step_len_ref, ipm_update_ref

STEP_LEN_LAUNCHES = 0
UPDATE_LAUNCHES = 0

__all__ = ["ipm_step_len", "ipm_update"]


def _on_cpu(fn: str, v: torch.Tensor) -> bool:
    if v.device.type == "cpu":
        return True
    if v.device.type != "cuda":
        raise ValueError(f"{fn}: no implementation for {v.device}")
    return False


def _check(fn: str, named, bsz: int, t: int, n: int,
           device: torch.device) -> None:
    """Each (name, tensor, "T" or "n") must be a contiguous float32 (B, T)
    or (B, n) tensor on ``device``."""
    for name, v, width in named:
        shape = (bsz, t if width == "T" else n)
        if v.device != device:
            raise ValueError(f"{fn}: {name} is on {v.device}, not {device}")
        if v.dtype != torch.float32:
            raise TypeError(f"{fn}: {name} must be torch.float32, got "
                            f"{v.dtype}")
        if tuple(v.shape) != shape:
            raise ValueError(f"{fn}: {name} must have shape {shape}, got "
                             f"{tuple(v.shape)}")
        if not v.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")


def ipm_step_len(s, ds, x, dx, w, y, dy, zl, dzl, zu, dzu,
                 frac: float = FRAC):
    """(ap, ad), each (B,): the primal step length keeping s, x and w
    interior along (ds, dx, -dx), the dual one keeping y, zl, zu interior
    along (dy, dzl, dzu); s, ds, y, dy (B, T), the rest (B, n)."""
    global STEP_LEN_LAUNCHES
    if _on_cpu("ipm_step_len", s):
        return ipm_step_len_ref(s, ds, x, dx, w, y, dy, zl, dzl, zu, dzu,
                                frac)
    if s.dim() != 2 or x.dim() != 2:
        raise ValueError(f"ipm_step_len: s and x must be 2-D, got "
                         f"{tuple(s.shape)} and {tuple(x.shape)}")
    (bsz, t), n = s.shape, x.shape[1]
    _check("ipm_step_len", (
        ("s", s, "T"), ("ds", ds, "T"), ("x", x, "n"), ("dx", dx, "n"),
        ("w", w, "n"), ("y", y, "T"), ("dy", dy, "T"), ("zl", zl, "n"),
        ("dzl", dzl, "n"), ("zu", zu, "n"), ("dzu", dzu, "n")),
        bsz, t, n, s.device)
    ap = torch.empty((bsz,), dtype=torch.float32, device=s.device)
    ad = torch.empty_like(ap)
    if bsz:
        _launch("ipm_step_len", "ldpc_ipm_step_len", s, ds, x, dx, w, y, dy,
                zl, dzl, zu, dzu, ap, ad, bsz, t, n, float(frac))
        STEP_LEN_LAUNCHES += 1
    return ap, ad


def ipm_update(state, dirs, ap, ad):
    """One Newton update of ``state`` (x, w, s, y, zl, zu, ax) along
    ``dirs`` (dx, dy, ds, dzl, dzu, adx) by the step lengths ``ap``, ``ad``
    (B,); a lane whose dx or dy is not finite keeps its iterate, and every
    lane is clamped strictly interior with w = 1 - x. On CUDA the state's
    tensors are updated in place and returned."""
    global UPDATE_LAUNCHES
    x, w, s, y, zl, zu, ax = state
    dx, dy, ds, dzl, dzu, adx = dirs
    if _on_cpu("ipm_update", x):
        return ipm_update_ref(state, dirs, ap, ad)
    if s.dim() != 2 or x.dim() != 2:
        raise ValueError(f"ipm_update: s and x must be 2-D, got "
                         f"{tuple(s.shape)} and {tuple(x.shape)}")
    (bsz, t), n = s.shape, x.shape[1]
    _check("ipm_update", (
        ("x", x, "n"), ("w", w, "n"), ("s", s, "T"), ("y", y, "T"),
        ("zl", zl, "n"), ("zu", zu, "n"), ("ax", ax, "T"), ("dx", dx, "n"),
        ("dy", dy, "T"), ("ds", ds, "T"), ("dzl", dzl, "n"),
        ("dzu", dzu, "n"), ("adx", adx, "T")), bsz, t, n, x.device)
    for name, v in (("ap", ap), ("ad", ad)):
        if (v.device != x.device or v.dtype != torch.float32
                or tuple(v.shape) != (bsz,) or not v.is_contiguous()):
            raise ValueError(f"ipm_update: {name} must be a contiguous "
                             f"float32 ({bsz},) tensor on {x.device}")
    if bsz:
        # the floor and the top of the box as float32, as torch converts
        # clamp's scalar bounds (1.0 - 1e-12 rounds to 1.0f)
        _launch("ipm_update", "ldpc_ipm_update", x, w, s, y, zl, zu, ax, dx,
                dy, ds, dzl, dzu, adx, ap, ad, bsz, t, n, FLOOR,
                1.0 - FLOOR)
        UPDATE_LAUNCHES += 1
    return state
