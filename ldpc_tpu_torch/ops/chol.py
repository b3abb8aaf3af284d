"""Batched blocked Cholesky factor and solve for the IPM's Newton step
(counterpart of ``ldpc_tpu/ops/pallas/chol_kernel.py``: ``CholFactors``,
``blocked_cholesky``, ``blocked_cho_solve``).

Left-looking by block column of ``nb`` (64) columns. The matrix is padded
with an identity tail so that every block is full size (n = 280 -> 320, five
blocks). The panel updates and the block matvecs are ``torch.bmm`` glue; the
sequential part, factoring a diagonal block and inverting its triangle, is
:func:`..ops.chol_kernel.chol_diag_inv` (the CUDA kernel on a CUDA tensor,
its twin :mod:`..ops.chol_ref` on a CPU tensor). The solve uses the inverted
diagonal blocks, so ``cho_solve`` becomes block matvecs with no sequential
triangular solve.

A lane that is not SPD comes out NaN in that lane only (the diagonal step's
rule), which the IPM's NaN-freeze relies on.

JAX subtracts the earlier block columns one at a time; here each panel
update is one ``bmm`` over all of them (fewer launches; float32 sums in
another order, so the two agree to rounding).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .chol_kernel import chol_diag_inv
from .gemv_ref import gemv_ref, gemv_t_ref

__all__ = ["CholFactors", "blocked_cho_solve", "blocked_cholesky"]


@dataclass
class CholFactors:
    """Blocked factorization of SPD M = L L^T.

    ``l``: (B, n_pad, n_pad) lower-triangular factor (dense, padded);
    ``inv_diag``: (P, B, nb, nb) inverted diagonal blocks of L;
    ``nb``/``n``: block size and original (unpadded) dimension.
    """
    l: torch.Tensor
    inv_diag: torch.Tensor
    nb: int
    n: int


def blocked_cholesky(m: torch.Tensor, nb: int = 64) -> CholFactors:
    """Batched blocked Cholesky of SPD ``m`` (B, n, n) -> CholFactors."""
    if m.dim() != 3 or m.shape[1] != m.shape[2]:
        raise ValueError(f"blocked_cholesky: m must be (B, n, n), got "
                         f"{tuple(m.shape)}")
    bsz, n, _ = m.shape
    p_cnt = -(-n // nb)
    n_pad = p_cnt * nb
    m = m.to(torch.float32)
    if n_pad != n:
        mp = m.new_zeros((bsz, n_pad, n_pad))
        mp[:, :n, :n] = m
        # a fill of the diagonal's view, not an index_put of a number
        # (which copies the number to the card: not capturable)
        mp.diagonal(dim1=1, dim2=2)[:, n:].fill_(1.0)
        m = mp
    l_full = m.new_zeros((bsz, n_pad, n_pad))
    inv_diag = m.new_empty((p_cnt, bsz, nb, nb))
    for q in range(p_cnt):
        qs, qe = q * nb, (q + 1) * nb
        acc = m[:, qs:, qs:qe]                     # (B, n_pad - qs, nb)
        if q:
            acc = acc - torch.bmm(l_full[:, qs:, :qs],
                                  l_full[:, qs:qe, :qs].transpose(1, 2))
        l_d, v_d = chol_diag_inv(acc[:, :nb].contiguous())
        inv_diag[q] = v_d
        l_full[:, qs:qe, qs:qe] = l_d
        if qe < n_pad:
            l_full[:, qe:, qs:qe] = torch.bmm(acc[:, nb:], v_d.transpose(1, 2))
    return CholFactors(l=l_full, inv_diag=inv_diag, nb=nb, n=n)


def blocked_cho_solve(fac: CholFactors, r: torch.Tensor) -> torch.Tensor:
    """Solve M x = r for each lane given ``blocked_cholesky`` factors:
    r (B, n) -> x (B, n). Forward then backward block substitution against
    the pre-inverted diagonal blocks."""
    nb, n, l = fac.nb, fac.n, fac.l
    n_pad = l.shape[1]
    p_cnt = n_pad // nb
    z = r.new_zeros((r.shape[0], n_pad), dtype=torch.float32)
    z[:, :n] = r
    for q in range(p_cnt):                        # L z = r
        qs, qe = q * nb, (q + 1) * nb
        acc = z[:, qs:qe]
        if q:
            acc = acc - gemv_ref(l[:, qs:qe, :qs], z[:, :qs])
        z[:, qs:qe] = gemv_ref(fac.inv_diag[q], acc)
    for q in range(p_cnt - 1, -1, -1):            # L^T x = z
        qs, qe = q * nb, (q + 1) * nb
        acc = z[:, qs:qe]
        if qe < n_pad:
            acc = acc - gemv_t_ref(l[:, qe:, qs:qe], z[:, qe:])
        z[:, qs:qe] = gemv_t_ref(fac.inv_diag[q], acc)
    return z[:, :n]
