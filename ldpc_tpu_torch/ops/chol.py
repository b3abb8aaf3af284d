"""Batched blocked Cholesky factor and solve for the IPM's Newton step
(counterpart of ``ldpc_tpu/ops/pallas/chol_kernel.py``: ``CholFactors``,
``blocked_cholesky``, ``blocked_cho_solve``).

Left-looking by block column of ``nb`` (64) columns. The matrix is padded
with an identity tail so that every block is full size (n = 280 -> 320, five
blocks). The solve uses the inverted diagonal blocks, so ``cho_solve``
becomes block matvecs with no sequential triangular solve.

Two implementations, chosen by what the input shows: at ``nb`` 64 and n up
to :data:`..ops.chol_kernel.FUSED_MAX_N` (320) the fused kernels of
:mod:`..ops.chol_kernel` (``csrc/chol_fused.cu``): the whole factor in one
launch and each solve in one, one block per lane (on a CPU tensor their
twins, ``chol_factor_ref`` and ``chol_solve_ref`` of :mod:`..ops.chol_ref`).
Any other shape (H02's n = 640) takes the chain: the panel updates are
``torch.bmm`` glue and the sequential part, factoring a diagonal block and
inverting its triangle, is :func:`..ops.chol_kernel.chol_diag_inv` (the
CUDA kernel on a CUDA tensor, its twin on a CPU tensor); its solve is the
twin's block substitution. Both give the same :class:`CholFactors`.

A lane that is not SPD comes out NaN in that lane only (the diagonal step's
rule), which the IPM's NaN-freeze relies on.

JAX subtracts the earlier block columns one at a time; here each panel
update is one ``bmm`` (the chain) or one sum in column order (the fused
kernel), and the fused kernel solves the rows below a diagonal block
against it rather than multiplying by its inverse: float32 sums in another
order, so the paths agree to rounding.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .chol_kernel import (FUSED_MAX_N, FUSED_NB, chol_diag_inv, chol_factor,
                          chol_solve)
from .chol_ref import chol_solve_ref

__all__ = ["CholFactors", "blocked_cho_solve", "blocked_cholesky",
           "chain_cholesky", "fused"]


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


def fused(n: int, nb: int) -> bool:
    """Whether the fused kernels factor and solve this shape."""
    return nb == FUSED_NB and 1 <= n <= FUSED_MAX_N


def blocked_cholesky(m: torch.Tensor, nb: int = 64) -> CholFactors:
    """Batched blocked Cholesky of SPD ``m`` (B, n, n) -> CholFactors."""
    if m.dim() != 3 or m.shape[1] != m.shape[2]:
        raise ValueError(f"blocked_cholesky: m must be (B, n, n), got "
                         f"{tuple(m.shape)}")
    n = m.shape[1]
    if fused(n, nb):
        l, inv_diag = chol_factor(m.to(torch.float32).contiguous())
        return CholFactors(l=l, inv_diag=inv_diag, nb=nb, n=n)
    return chain_cholesky(m, nb)


def chain_cholesky(m: torch.Tensor, nb: int = 64) -> CholFactors:
    """The chain: ``bmm`` panels around :func:`chol_diag_inv`, for any n
    (``blocked_cholesky`` takes it past the fused kernels' limit)."""
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
    if fused(fac.n, fac.nb):
        return chol_solve(fac.l, fac.inv_diag,
                          r.to(torch.float32).contiguous(), fac.n)
    return chol_solve_ref(fac.l, fac.inv_diag, r, fac.n)
