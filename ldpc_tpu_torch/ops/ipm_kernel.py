"""Python wrappers of the IPM Newton step's two hand-written kernels
(``csrc/ipm_step.cu``): the step lengths and the masked update.

They have no Pallas counterpart: in ``ldpc_tpu/ops/ipm_solver.py`` XLA fuses
this elementwise work (``:222-267``). Each wrapper picks by the device of its
first tensor (:func:`._launch.on_cpu`): a CPU tensor goes to its plain twin
in :mod:`.ipm_ref`, a CUDA tensor to the kernel. On CUDA a wrapper checks
its inputs (float32, contiguous, the shapes of one solve), takes the launch
layout of :func:`ipm_step_plan` and launches (:func:`._launch.launch`) on
the current stream without synchronising (a test or a timer that launches
by a plan of its own calls ``launch`` with the entry point's arguments).

``ipm_update`` on CUDA writes the new state into the state's own tensors
and returns them; its twin returns new tensors. Callers use the returned
state either way.

``STEP_LEN_LAUNCHES`` and ``UPDATE_LAUNCHES`` count each kernel's launches,
so a run can show that its main path went through them.
"""
from __future__ import annotations

import torch

from ._launch import counter, expect, launch, on_cpu
from .ipm_ref import FLOOR, FRAC, ipm_step_len_ref, ipm_update_ref

STEP_LEN_LAUNCHES = 0
UPDATE_LAUNCHES = 0
_STEP_LEN = counter(__name__, "STEP_LEN_LAUNCHES")
_UPDATE = counter(__name__, "UPDATE_LAUNCHES")

MAX_THREADS = 1024   # a block
PER_THREAD = 4       # floats of each of a lane's arrays a thread holds a pass

__all__ = ["empty_kernel", "ipm_step_len", "ipm_step_plan", "ipm_update",
           "step_len_bytes", "update_bytes"]


def ipm_step_plan(bsz: int, t: int, n: int, aligned: bool) -> dict:
    """The launch layout of both kernels for ``bsz`` lanes of ``t`` rows
    and ``n`` columns, as ``csrc/ipm_step.cu`` takes it (its entry points
    refuse a layout that is not legal for the shape and pointers):

    * ``vec``: 4 (16-byte loads and stores) when ``aligned`` (every array
      starts on 16 bytes) and T and n are multiples of 4, else 1;
    * ``threads``: threads of the lane's block, the fewest warps (up to
      ``MAX_THREADS``) that give each thread ``PER_THREAD`` floats of each
      array;
    * ``passes``: the passes of ``PER_THREAD * threads`` floats a thread
      makes over its lane (1 up to T and n of 4096);
    * ``blocks``: the grid, one block a lane.

    Raises ``ValueError`` for an empty shape."""
    if bsz < 1 or t < 1 or n < 1:
        raise ValueError(f"ipm_step_plan: empty shape, {bsz} lanes of "
                         f"{t} rows and {n} columns")
    width = max(t, n)
    threads = min(MAX_THREADS, 32 * -(-width // (32 * PER_THREAD)))
    vec = 4 if aligned and t % 4 == 0 and n % 4 == 0 else 1
    return {"vec": vec, "threads": threads,
            "passes": -(-width // (PER_THREAD * threads)), "blocks": bsz}


def step_len_bytes(bsz: int, t: int, n: int) -> int:
    """Bytes the step lengths must move: s, ds, y, dy (B, T) and x, dx, w,
    zl, dzl, zu, dzu (B, n) read once, ap and ad (B,) written once."""
    return 4 * bsz * (4 * t + 7 * n) + 8 * bsz


def update_bytes(bsz: int, t: int, n: int) -> int:
    """Bytes the update must move: ax, adx, s, ds, y, dy (B, T), x, dx, zl,
    dzl, zu, dzu (B, n) and ap, ad (B,) read once; ax, s, y (B, T) and x,
    w, zl, zu (B, n) written once."""
    return 4 * bsz * (9 * t + 10 * n) + 8 * bsz


def _aligned(tensors) -> bool:
    return all(v.data_ptr() % 16 == 0 for v in tensors)


def _check(fn: str, named, bsz: int, t: int, n: int,
           device: torch.device) -> None:
    """Each (name, tensor, "T" or "n") must be a contiguous float32 (B, T)
    or (B, n) tensor on ``device``."""
    for name, v, width in named:
        expect(fn, name, v, torch.float32, (bsz, t if width == "T" else n),
               device)


def empty_kernel(plan: dict, device: torch.device) -> None:
    """An empty kernel of ``plan``'s grid and blocks on the current stream
    of ``device``: the launch floor that the two kernels are timed against.
    Needs a card."""
    launch("empty_kernel", "ldpc_ipm_empty", device, plan["blocks"],
           plan["threads"])


def ipm_step_len(s, ds, x, dx, w, y, dy, zl, dzl, zu, dzu,
                 frac: float = FRAC):
    """(ap, ad), each (B,): the primal step length keeping s, x and w
    interior along (ds, dx, -dx), the dual one keeping y, zl, zu interior
    along (dy, dzl, dzu); s, ds, y, dy (B, T), the rest (B, n)."""
    if on_cpu("ipm_step_len", s):
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
    arrays = (s, ds, x, dx, w, y, dy, zl, dzl, zu, dzu)
    plan = ipm_step_plan(bsz, t, n, _aligned(arrays)) if bsz else None
    ap = torch.empty((bsz,), dtype=torch.float32, device=s.device)
    ad = torch.empty_like(ap)
    if bsz:
        launch("ipm_step_len", "ldpc_ipm_step_len", s.device, *arrays, ap, ad,
               bsz, t, n, float(frac), plan["vec"], plan["threads"])
        _STEP_LEN()
    return ap, ad


def ipm_update(state, dirs, ap, ad):
    """One Newton update of ``state`` (x, w, s, y, zl, zu, ax) along
    ``dirs`` (dx, dy, ds, dzl, dzu, adx) by the step lengths ``ap``, ``ad``
    (B,); a lane whose dx or dy is not finite keeps its iterate, and every
    lane is clamped strictly interior with w = 1 - x. On CUDA the state's
    tensors are updated in place and returned."""
    x, w, s, y, zl, zu, ax = state
    dx, dy, ds, dzl, dzu, adx = dirs
    if on_cpu("ipm_update", x):
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
    expect("ipm_update", "ap", ap, torch.float32, (bsz,), x.device)
    expect("ipm_update", "ad", ad, torch.float32, (bsz,), x.device)
    if bsz:
        plan = ipm_step_plan(bsz, t, n, _aligned((*state, *dirs)))
        # the floor and the top of the box as float32, as torch converts
        # clamp's scalar bounds (1.0 - 1e-12 rounds to 1.0f)
        launch("ipm_update", "ldpc_ipm_update", x.device, *state, *dirs, ap,
               ad, bsz, t, n, FLOOR, 1.0 - FLOOR, plan["vec"],
               plan["threads"])
        _UPDATE()
    return state
