"""GF(2) linear algebra on the host (NumPy) and on the device (torch).

Counterpart of ``ldpc_tpu/codes/gf2.py``. The host routines run once per
experiment, or once per candidate of the matrix optimizer.
``gf2_nullspace`` follows the reference's ``GetOrtogonal``
(``utils/codeword.h:97-128``: first-nonzero pivot, ``(None, False)`` on a
row that reduces to zero). When n > m it runs the bit-packed host core
(``_native``), as the JAX package does; ``_nullspace_numpy`` is the same
routine in NumPy, taken when n <= m or when ``LDPC_TPU_NO_NATIVE`` is set.
``gf2_rank`` and ``gf2_matmul`` stay NumPy, as in the JAX package, though
the core binds both.

Device side: ``syndrome`` / ``is_codeword``. CUDA matmuls take no integer
tensors, so the product runs in float32 on 0/1 values, which is exact while a
row sum stays below 2**24.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import _native

__all__ = ["gf2_matmul", "gf2_nullspace", "gf2_rank", "syndrome",
           "is_codeword"]


def gf2_matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """GF(2) matrix product (host)."""
    a = np.asarray(a, dtype=np.uint8)
    b = np.asarray(b, dtype=np.uint8)
    return (a.astype(np.int32) @ b.astype(np.int32)) % 2


def gf2_rank(h: np.ndarray) -> int:
    """Rank of a GF(2) matrix via row reduction (host)."""
    h = np.array(h, dtype=np.uint8) % 2
    m, n = h.shape
    rank = 0
    for col in range(n):
        if rank >= m:
            break
        pivots = np.nonzero(h[rank:, col])[0]
        if pivots.size == 0:
            continue
        piv = rank + pivots[0]
        if piv != rank:
            h[[rank, piv]] = h[[piv, rank]]
        mask = h[:, col].copy().astype(bool)
        mask[rank] = False
        h[mask] ^= h[rank]
        rank += 1
    return rank


def gf2_nullspace(h: np.ndarray) -> tuple[np.ndarray | None, bool]:
    """Generator matrix G whose rows span the nullspace of H over GF(2).

    For each row i the pivot is the *first* nonzero column; if any row
    reduces to zero the matrix is declared singular and ``(None, False)`` is
    returned. On success returns ``(G, True)`` with ``G`` of shape
    ``(n - m, n)`` and ``H @ G.T == 0 (mod 2)``. The host core computes it
    when n > m, NumPy otherwise; both give the same G.
    """
    h = np.array(h, dtype=np.uint8) % 2
    out = _native.nullspace(h)
    return out if out is not None else _nullspace_numpy(h)


def _nullspace_numpy(h: np.ndarray) -> tuple[np.ndarray | None, bool]:
    """``gf2_nullspace`` in NumPy."""
    h = np.array(h, dtype=np.uint8) % 2
    m, n = h.shape
    pos = np.full(m, -1, dtype=np.int64)
    is_main = np.zeros(n, dtype=bool)
    for i in range(m):
        nz = np.nonzero(h[i])[0]
        if nz.size == 0:
            return None, False
        p = nz[0]
        pos[i] = p
        mask = h[:, p].astype(bool).copy()
        mask[i] = False
        h[mask] ^= h[i]
        is_main[p] = True
    free_cols = np.nonzero(~is_main)[0]
    g = np.zeros((n - m, n), dtype=np.uint8)
    for idx, j in enumerate(free_cols):
        g[idx, j] = 1
        rows = np.nonzero(h[:, j])[0]
        g[idx, pos[rows]] = 1
    return g, True


def syndrome(h: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """``bits @ H^T mod 2``: ``h`` (m, n) 0/1, ``bits`` (..., n) 0/1 ->
    (..., m) uint8, on the tensors' device."""
    prod = bits.to(torch.float32) @ h.to(torch.float32).T
    return prod.remainder(2.0).to(torch.uint8)


def is_codeword(h: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """Batched validity check ``H c == 0``: (..., n) -> (...,) bool."""
    return (syndrome(h, bits) == 0).all(dim=-1)
