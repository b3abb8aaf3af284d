"""Python wrappers of the IPM Newton step's three hand-written kernels
(``csrc/ipm_step.cu``): the prep, the predict and the correct; and of its
right-hand side, the A^T y kernel's epilogue (:func:`newton_rhs`).

They have no Pallas counterpart: in ``ldpc_tpu/ops/ipm_solver.py`` XLA fuses
this elementwise and per-lane work (``newton``, ``:165-267``). A Newton
step (:func:`.ipm_solver._newton`) launches A^T y, :func:`ipm_prep`, the
normal matrix, its factor, then for the predictor the right-hand side
(A^T v with its epilogue, :func:`newton_rhs`), the solve, A dx
and :func:`ipm_predict`, and the same three for the corrector and
:func:`ipm_correct`: twelve launches.

Each wrapper picks by the device of the iterate (:func:`._launch.on_cpu`):
a CPU tensor goes to its plain twin in :mod:`.ipm_ref`, a CUDA tensor to
the kernel. On CUDA a wrapper checks its inputs (float32, contiguous, the
shapes of one solve), allocates its outputs, takes the launch layout of
:func:`ipm_step_plan` and launches (:func:`._launch.launch`) on the current
stream without synchronising or reading anything back, so a CUDA graph
captures it (a test or a timer that launches by a plan of its own calls
``launch`` with the entry point's arguments).

``ipm_correct`` on CUDA writes the new iterate into the state's own
tensors and returns them; its twin returns new tensors. Callers use the
returned state either way.

``PREP_LAUNCHES``, ``PREDICT_LAUNCHES`` and ``CORRECT_LAUNCHES`` count each
kernel's launches (one each a Newton step), so a run can show that its main
path went through them.
"""
from __future__ import annotations

import torch

from ._launch import counter, expect, launch, on_cpu
from .gemv_kernel import check_packed, gemv_t_launch
from .gemv_ref import gemv_t_ref, unpack_rows
from .ipm_ref import (DIAG_HI, DIAG_LO, FLOOR, FRAC, MU_FLOOR, Terms,
                      ipm_correct_ref, ipm_predict_ref, ipm_prep_ref,
                      newton_rhs_ref)

PREP_LAUNCHES = 0
PREDICT_LAUNCHES = 0
CORRECT_LAUNCHES = 0
_PREP = counter(__name__, "PREP_LAUNCHES")
_PREDICT = counter(__name__, "PREDICT_LAUNCHES")
_CORRECT = counter(__name__, "CORRECT_LAUNCHES")

MAX_THREADS = 1024   # a block
PER_THREAD = 4       # floats of each of a lane's arrays a thread holds a pass

__all__ = ["correct_bytes", "empty_kernel", "ipm_correct", "ipm_predict",
           "ipm_prep", "ipm_step_plan", "newton_rhs", "predict_bytes",
           "prep_bytes"]

_F32 = torch.float32


def ipm_step_plan(bsz: int, t: int, n: int, aligned: bool) -> dict:
    """The launch layout of the three kernels for ``bsz`` lanes of ``t``
    rows and ``n`` columns, as ``csrc/ipm_step.cu`` takes it (its entry
    points refuse a layout that is not legal for the shape and pointers):

    * ``vec``: 4 (16-byte loads and stores along the rows) when ``aligned``
      (every row array starts on 16 bytes) and T and n are multiples of 4,
      else 1;
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


def prep_bytes(bsz: int, t: int, n: int) -> int:
    """Bytes the prep must move: ax, s, be, y (B, T) and x, w, zl, zu, cs,
    A^T y (B, n) read once; rp, dy_s, ry, v (B, T), rd, dxl, dxu, dxx, rl,
    ru (B, n) and mu (B,) written once."""
    return 4 * bsz * (8 * t + 12 * n + 1)


def predict_bytes(bsz: int, t: int, n: int) -> int:
    """Bytes the predict must move: s, y, rp, dy_s, ry, A dx (B, T), x, w,
    zl, zu, dx, dxl, dxu, rl, ru (B, n) and mu (B,) read once; ry, v
    (B, T), rl, ru (B, n) and ap, ad, mu_aff (B,) written once."""
    return 4 * bsz * (8 * t + 11 * n + 4)


def correct_bytes(bsz: int, t: int, n: int) -> int:
    """Bytes the correct must move: s, y, ax, rp, dy_s, ry, A dx (B, T), x,
    w, zl, zu, dx, dxl, dxu, rl, ru (B, n) read once; s, y, ax (B, T), x,
    w, zl, zu (B, n) and ap, ad (B,) written once."""
    return 4 * bsz * (10 * t + 13 * n + 2)


def _aligned(tensors) -> bool:
    return all(v.data_ptr() % 16 == 0 for v in tensors)


def _shape(fn: str, state) -> tuple[int, int, int]:
    """(B, T, n) of a state (x, w, s, y, zl, zu, ax)."""
    x, s = state[0], state[2]
    if s.dim() != 2 or x.dim() != 2:
        raise ValueError(f"{fn}: s and x must be 2-D, got "
                         f"{tuple(s.shape)} and {tuple(x.shape)}")
    return s.shape[0], s.shape[1], x.shape[1]


def _check(fn: str, named, bsz: int, t: int, n: int,
           device: torch.device) -> None:
    """Each (name, tensor, "T", "n" or "B") must be a contiguous float32
    (B, T), (B, n) or (B,) tensor on ``device``."""
    dims = {"T": (bsz, t), "n": (bsz, n), "B": (bsz,)}
    for name, v, width in named:
        expect(fn, name, v, _F32, dims[width], device)


def _state_named(state, with_ax: bool = True):
    names = ("x", "w", "s", "y", "zl", "zu", "ax")[:7 if with_ax else 6]
    return tuple((k, v, "T" if k in ("s", "y", "ax") else "n")
                 for k, v in zip(names, state))


def _terms_named(terms: Terms, fields):
    widths = {"rp": "T", "rd": "n", "mu": "B", "dy_s": "T", "dxl": "n",
              "dxu": "n", "dxx": "n", "ry": "T", "rl": "n", "ru": "n",
              "v": "T"}
    return tuple((k, getattr(terms, k), widths[k]) for k in fields)


def empty_kernel(plan: dict, device: torch.device) -> None:
    """An empty kernel of ``plan``'s grid and blocks on the current stream
    of ``device``: the launch floor that the three kernels are timed
    against. Needs a card."""
    launch("empty_kernel", "ldpc_ipm_empty", device, plan["blocks"],
           plan["threads"])


def ipm_prep(state, aty, cs, be, n_compl) -> Terms:
    """A Newton step's residuals, mu, diagonal scalings and predictor's
    targets (:class:`.ipm_ref.Terms`) from ``state`` (x, w, s, y, zl, zu,
    ax), A^T y (B, n), the scaled objective ``cs`` (B, n), the rhs ``be``
    (B, T) and ``n_compl`` (a 0-d tensor on the device: R + 2n)."""
    if on_cpu("ipm_prep", state[0]):
        return ipm_prep_ref(state, aty, cs, be, n_compl)
    bsz, t, n = _shape("ipm_prep", state)
    dev = state[0].device
    _check("ipm_prep", (*_state_named(state), ("aty", aty, "n"),
                        ("cs", cs, "n"), ("be", be, "T")), bsz, t, n, dev)
    expect("ipm_prep", "n_compl", n_compl, _F32, (), dev)
    widths = (t, n, None, t, n, n, n, t, n, n, t)
    out = Terms(*(torch.empty((bsz,) if w is None else (bsz, w), dtype=_F32,
                              device=dev) for w in widths))
    if bsz:
        s, y, ax = state[2], state[3], state[6]
        plan = ipm_step_plan(bsz, t, n, _aligned(
            (s, y, ax, be, out.rp, out.dy_s, out.ry, out.v)))
        launch("ipm_prep", "ldpc_ipm_prep", dev, *state, aty, cs, be,
               n_compl, *out, bsz, t, n, DIAG_LO, DIAG_HI, plan["vec"],
               plan["threads"])
        _PREP()
    return out


def newton_rhs(a: torch.Tensor, v: torch.Tensor, rd: torch.Tensor,
               rl: torch.Tensor, ru: torch.Tensor, n: int) -> torch.Tensor:
    """A Newton direction's right-hand side -rd - A^T v + rl - ru per lane:
    a the (B, T, n_pad) int8 copy from :func:`.gemv_kernel.pack_rows` of a
    slice with ``n`` columns, v (B, T), rd, rl, ru (B, n) float32 -> (B, n).
    On CUDA one launch of the A^T y kernel, which forms it in its epilogue
    (counted as an A^T y launch); on the CPU its twin
    (:func:`.ipm_ref.newton_rhs_ref` of A^T v)."""
    cpu = on_cpu("newton_rhs", a)
    bsz, t, _ = check_packed("newton_rhs", a, n)
    expect("newton_rhs", "v", v, _F32, (bsz, t), a.device)
    _check("newton_rhs", (("rd", rd, "n"), ("rl", rl, "n"), ("ru", ru, "n")),
           bsz, t, n, a.device)
    if cpu:
        return newton_rhs_ref(rd, gemv_t_ref(unpack_rows(a, n), v), rl, ru)
    return gemv_t_launch("newton_rhs", a, v, n, (rd, rl, ru))


def ipm_predict(state, terms: Terms, dx, adx, n_compl):
    """The predictor's directions from its solve ``dx`` (B, n) and A dx
    (B, T), its step lengths, mu_aff and the corrector's targets. Returns
    (``terms`` with the corrector's ry, rl, ru and v, ap, ad, mu_aff)."""
    if on_cpu("ipm_predict", state[0]):
        return ipm_predict_ref(state, terms, dx, adx, n_compl)
    bsz, t, n = _shape("ipm_predict", state)
    dev = state[0].device
    _check("ipm_predict", (
        *_state_named(state, False),
        *_terms_named(terms, ("rp", "dy_s", "dxl", "dxu", "ry", "rl", "ru",
                              "mu")),
        ("dx", dx, "n"), ("adx", adx, "T")), bsz, t, n, dev)
    expect("ipm_predict", "n_compl", n_compl, _F32, (), dev)
    ap, ad, mu_aff = (torch.empty((bsz,), dtype=_F32, device=dev)
                      for _ in range(3))
    ry, v = torch.empty_like(terms.ry), torch.empty_like(terms.v)
    rl, ru = torch.empty_like(terms.rl), torch.empty_like(terms.ru)
    if bsz:
        plan = ipm_step_plan(bsz, t, n, _aligned(
            (state[2], state[3], terms.rp, terms.dy_s, terms.ry, adx, ry, v)))
        launch("ipm_predict", "ldpc_ipm_predict", dev, *state[:6], terms.rp,
               terms.dy_s, terms.dxl, terms.dxu, terms.ry, terms.rl,
               terms.ru, dx, adx, terms.mu, n_compl, ap, ad, mu_aff, ry, rl,
               ru, v, bsz, t, n, FRAC, MU_FLOOR, plan["vec"],
               plan["threads"])
        _PREDICT()
    return terms._replace(ry=ry, rl=rl, ru=ru, v=v), ap, ad, mu_aff


def ipm_correct(state, terms: Terms, dx, adx):
    """The corrector's directions from its solve ``dx`` (B, n) and A dx
    (B, T) and ``terms`` (its targets), its step lengths and the masked
    update of ``state`` (x, w, s, y, zl, zu, ax): a lane whose dx or dy is
    not finite keeps its iterate, and every lane is clamped strictly
    interior with w = 1 - x. Returns (the new state, ap, ad); on CUDA the
    state's tensors are updated in place and returned."""
    if on_cpu("ipm_correct", state[0]):
        return ipm_correct_ref(state, terms, dx, adx)
    bsz, t, n = _shape("ipm_correct", state)
    dev = state[0].device
    _check("ipm_correct", (
        *_state_named(state),
        *_terms_named(terms, ("rp", "dy_s", "dxl", "dxu", "ry", "rl",
                              "ru")),
        ("dx", dx, "n"), ("adx", adx, "T")), bsz, t, n, dev)
    ap = torch.empty((bsz,), dtype=_F32, device=dev)
    ad = torch.empty_like(ap)
    if bsz:
        plan = ipm_step_plan(bsz, t, n, _aligned(
            (state[2], state[3], state[6], terms.rp, terms.dy_s, terms.ry,
             adx)))
        # the floor and the top of the box as float32, as torch converts
        # clamp's scalar bounds (1.0 - 1e-12 rounds to 1.0f)
        launch("ipm_correct", "ldpc_ipm_correct", dev, *state, terms.rp,
               terms.dy_s, terms.dxl, terms.dxu, terms.ry, terms.rl,
               terms.ru, dx, adx, ap, ad, bsz, t, n, FRAC, FLOOR,
               1.0 - FLOOR, plan["vec"], plan["threads"])
        _CORRECT()
    return state, ap, ad
