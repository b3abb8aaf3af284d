"""Python wrappers of the Cholesky kernels: the diagonal-block kernel
(``csrc/chol_diag_inv.cu``) and the fused factor and solve
(``csrc/chol_fused.cu``).

Replaces ``ldpc_tpu/ops/pallas/chol_kernel.py`` (``_diag_inv_kernel``,
called by ``_chol_diag_inv``). :func:`chol_diag_inv` picks by the device of
``d`` (:func:`._launch.on_cpu`): a CPU tensor goes to the plain twin
:func:`..ops.chol_ref.chol_diag_inv_ref`, a CUDA tensor to the kernel. On
CUDA the wrapper checks its input, allocates the outputs and launches
(:func:`._launch.launch`) on the current stream without synchronising.

The kernel runs one warp per lane, two lanes per block (a constant of the
source, chosen from variant builds timed on the H100, ``PERF.md``), and
takes blocks of at most 64 x 64 (the blocked Cholesky's ``nb``); a larger
``nb`` is refused on the card.

:func:`chol_factor` and :func:`chol_solve` are the whole blocked factor
and each of its solves in one launch, one block of 256 threads per lane
(the IPM's Newton system at n <= ``FUSED_MAX_N``; ``ops/chol.py`` chooses
them by n). They pick by device as :func:`chol_diag_inv` does: a CPU tensor
goes to the twins :func:`..ops.chol_ref.chol_factor_ref` and
:func:`..ops.chol_ref.chol_solve_ref`. The results are the blocked factor's
(``ops/chol.py`` ``CholFactors``: L padded to n_pad = n rounded up to 64,
the inverted 64 x 64 diagonal blocks).

``LAUNCHES`` counts the diagonal kernel's launches, ``FACTOR_LAUNCHES`` and
``SOLVE_LAUNCHES`` the fused kernels', and ``FACTOR_SHAPE_LAUNCHES`` the
fused factor's by (lanes, n), so a run can show that its main path went
through the kernels (declared with :func:`._launch.counter`, so
``ops/ipm_graph.py`` adds them at each graph replay).
"""
from __future__ import annotations

from collections import Counter

import torch

from ._launch import counter, expect, launch, on_cpu
from .chol_ref import chol_diag_inv_ref, chol_factor_ref, chol_solve_ref

LAUNCHES = 0
FACTOR_LAUNCHES = 0
SOLVE_LAUNCHES = 0
FACTOR_SHAPE_LAUNCHES: Counter = Counter()
_DIAG = counter(__name__, "LAUNCHES")
_FACTOR = counter(__name__, "FACTOR_LAUNCHES", "FACTOR_SHAPE_LAUNCHES")
_SOLVE = counter(__name__, "SOLVE_LAUNCHES")
_MAX_NB = 64  # csrc/chol_diag_inv.cu kNb
FUSED_NB = 64  # csrc/chol_fused.cu kNb
FUSED_MAX_N = 320  # csrc/chol_fused.cu kMaxN

__all__ = ["FUSED_MAX_N", "FUSED_NB", "chol_diag_inv", "chol_factor",
           "chol_solve"]


def chol_diag_inv(d: torch.Tensor):
    """(B, nb, nb) float32 SPD blocks -> (L, L^{-1}), both (B, nb, nb),
    lower triangular, zero above the diagonal. A lane that is not SPD is
    NaN in that lane only."""
    if on_cpu("chol_diag_inv", d):
        return chol_diag_inv_ref(d)
    if d.dim() != 3 or d.shape[1] != d.shape[2] or d.shape[1] < 1:
        raise ValueError(f"chol_diag_inv: d must be (B, nb, nb), got "
                         f"{tuple(d.shape)}")
    expect("chol_diag_inv", "d", d, torch.float32, d.shape, d.device)
    bsz, nb, _ = d.shape
    if nb > _MAX_NB:
        raise ValueError(f"chol_diag_inv: the kernel factors blocks of at "
                         f"most {_MAX_NB} x {_MAX_NB}, got {nb} x {nb}")
    l_out = torch.empty_like(d)
    inv_out = torch.empty_like(d)
    if bsz:
        launch("chol_diag_inv", "ldpc_chol_diag_inv", d.device, d, l_out,
               inv_out, bsz, nb)
        _DIAG()
    return l_out, inv_out


def _fused_n(fn: str, n: int) -> int:
    """n_pad for a fused kernel's n, which must lie in 1..FUSED_MAX_N."""
    if not 1 <= n <= FUSED_MAX_N:
        raise ValueError(f"{fn}: the fused kernels take n in 1.."
                         f"{FUSED_MAX_N}, got {n}")
    return -(-n // FUSED_NB) * FUSED_NB


def chol_factor(m: torch.Tensor):
    """(B, n, n) float32 SPD matrices -> (L (B, n_pad, n_pad), the inverted
    diagonal blocks (n_pad / 64, B, 64, 64)), both lower triangular. A lane
    that is not SPD is NaN in that lane only. One launch on a CUDA tensor;
    the twin on a CPU tensor."""
    if m.dim() != 3 or m.shape[1] != m.shape[2]:
        raise ValueError(f"chol_factor: m must be (B, n, n), got "
                         f"{tuple(m.shape)}")
    if on_cpu("chol_factor", m):
        return chol_factor_ref(m.to(torch.float32), FUSED_NB)
    bsz, n, _ = m.shape
    n_pad = _fused_n("chol_factor", n)
    expect("chol_factor", "m", m, torch.float32, m.shape, m.device)
    l = m.new_empty((bsz, n_pad, n_pad))
    inv = m.new_empty((n_pad // FUSED_NB, bsz, FUSED_NB, FUSED_NB))
    if bsz:
        launch("chol_factor", "ldpc_chol_factor", m.device, m, l, inv, bsz,
               n, n_pad)
        _FACTOR((bsz, n))
    return l, inv


def chol_solve(l: torch.Tensor, inv_diag: torch.Tensor, r: torch.Tensor,
               n: int) -> torch.Tensor:
    """Solve M x = r for each lane from :func:`chol_factor`'s results:
    r (B, n) float32 -> x (B, n). One launch on a CUDA tensor; the twin on
    a CPU tensor."""
    if on_cpu("chol_solve", r):
        return chol_solve_ref(l, inv_diag, r, n)
    n_pad = _fused_n("chol_solve", n)
    bsz, dev = r.shape[0], r.device
    expect("chol_solve", "r", r, torch.float32, (bsz, n), dev)
    expect("chol_solve", "l", l, torch.float32, (bsz, n_pad, n_pad), dev)
    expect("chol_solve", "inv_diag", inv_diag, torch.float32,
           (n_pad // FUSED_NB, bsz, FUSED_NB, FUSED_NB), dev)
    x = r.new_empty((bsz, n))
    if bsz:
        launch("chol_solve", "ldpc_chol_solve", dev, l, inv_diag, r, x, bsz,
               n, n_pad)
        _SOLVE()
    return x
