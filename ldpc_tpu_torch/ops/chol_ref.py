"""Plain PyTorch twins of the Cholesky kernels (the diagonal-block kernel
``csrc/chol_diag_inv.cu``, the fused factor and solve of
``csrc/chol_fused.cu``), and the NaN rule both IPM factor paths share.

The TPU kernel ``_diag_inv_kernel`` (``ldpc_tpu/ops/pallas/chol_kernel.py``)
factors every lane's SPD (nb, nb) diagonal block and inverts the triangle.
A lane that is not SPD comes out NaN, in that lane only: the IPM freezes such
a lane instead of letting it poison the batch (``ops.ipm_solver``).

``jnp.linalg.cholesky`` NaN-fills a lane whose factorization fails;
``torch.linalg.cholesky`` raises instead, and ``cholesky_ex`` returns a
partial factor with ``info > 0``. :func:`cholesky_nan` therefore writes NaN
into the lower triangle of exactly the lanes with ``info != 0``, without
reading ``info`` on the host (``check_errors=False``, no stream sync).
"""
from __future__ import annotations

import torch

from .gemv_ref import gemv_ref, gemv_t_ref

__all__ = ["chol_diag_inv_ref", "chol_factor_ref", "chol_solve_ref",
           "cholesky_nan"]


def cholesky_nan(m: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of each (.., n, n) lane; a lane that is not SPD
    is NaN on and below its diagonal, as ``jnp.linalg.cholesky`` gives it."""
    l, info = torch.linalg.cholesky_ex(m, check_errors=False)
    lower = torch.ones(m.shape[-2:], dtype=torch.bool,
                       device=m.device).tril()
    # masked_fill, not torch.where with a number: capturable in a CUDA graph
    return l.masked_fill((info != 0)[..., None, None] & lower, float("nan"))


def chol_diag_inv_ref(d: torch.Tensor):
    """(B, nb, nb) SPD blocks -> (L, L^{-1}), both (B, nb, nb) float32 and
    lower triangular; a non-SPD lane is NaN in both."""
    l = cholesky_nan(d)
    eye = torch.eye(d.shape[-1], dtype=d.dtype, device=d.device)
    inv = torch.linalg.solve_triangular(l, eye.expand_as(l), upper=False)
    return l, inv


def chol_factor_ref(m: torch.Tensor, nb: int = 64):
    """(B, n, n) SPD -> (L (B, n_pad, n_pad), the inverted diagonal blocks
    (P, B, nb, nb)), n_pad = n rounded up to ``nb`` = P nb, as the fused
    factor computes them: left-looking by block column over M padded with
    an identity tail, each panel's diagonal block factored and inverted
    and the rows below it solved against it (L_iq = P_iq L_qq^{-T}). L is
    zero above the diagonal; a lane that is not SPD is NaN in that lane
    only."""
    bsz, n, _ = m.shape
    p_cnt = -(-n // nb)
    n_pad = p_cnt * nb
    mp = torch.eye(n_pad, dtype=torch.float32, device=m.device).repeat(
        bsz, 1, 1)
    mp[:, :n, :n] = m
    l = torch.zeros_like(mp)
    inv = mp.new_empty((p_cnt, bsz, nb, nb))
    eye = torch.eye(nb, dtype=torch.float32, device=m.device).expand(
        bsz, nb, nb)
    for q in range(p_cnt):
        qs, qe = q * nb, (q + 1) * nb
        panel = mp[:, qs:, qs:qe]
        if q:
            panel = panel - l[:, qs:, :qs] @ l[:, qs:qe, :qs].transpose(1, 2)
        ld = cholesky_nan(panel[:, :nb])
        l[:, qs:qe, qs:qe] = ld
        inv[q] = torch.linalg.solve_triangular(ld, eye, upper=False)
        if qe < n_pad:
            l[:, qe:, qs:qe] = torch.linalg.solve_triangular(
                ld, panel[:, nb:].transpose(1, 2), upper=False).transpose(1, 2)
    return l, inv


def chol_solve_ref(l: torch.Tensor, inv_diag: torch.Tensor, r: torch.Tensor,
                   n: int) -> torch.Tensor:
    """Solve M x = r for each lane, r (B, n) -> x (B, n), from a blocked
    factor (L (B, n_pad, n_pad), the inverted diagonal blocks (P, B, nb,
    nb)): forward then backward block substitution against the inverted
    blocks, so no sequential triangular solve."""
    nb = inv_diag.shape[-1]
    n_pad = l.shape[1]
    z = r.new_zeros((r.shape[0], n_pad), dtype=torch.float32)
    z[:, :n] = r
    for q in range(n_pad // nb):                     # L z = r
        qs, qe = q * nb, (q + 1) * nb
        acc = z[:, qs:qe]
        if q:
            acc = acc - gemv_ref(l[:, qs:qe, :qs], z[:, :qs])
        z[:, qs:qe] = gemv_ref(inv_diag[q], acc)
    for q in range(n_pad // nb - 1, -1, -1):         # L^T x = z
        qs, qe = q * nb, (q + 1) * nb
        acc = z[:, qs:qe]
        if qe < n_pad:
            acc = acc - gemv_t_ref(l[:, qe:, qs:qe], z[:, qe:])
        z[:, qs:qe] = gemv_t_ref(inv_diag[q], acc)
    return z[:, :n]
