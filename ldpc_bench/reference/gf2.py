"""GF(2) for the reference: the generator matrix of a code and its
codewords.

``nullspace`` is the reference decoder's ``GetOrtogonal``
(acg-alp-ldpc ``utils/codeword.h:97-128``): Gauss-Jordan with the first
nonzero column of each row as its pivot; the free columns give G's rows.
"""
from __future__ import annotations

import numpy as np
import torch


def read_matrix(path: str) -> np.ndarray:
    """A comma-separated 0/1 matrix, one row per line, as uint8."""
    with open(path) as f:
        rows = [[c == "1" for c in tok.split(",") if c]
                for tok in f.read().split()]
    return np.array(rows, dtype=np.uint8)


def nullspace(h: np.ndarray) -> np.ndarray:
    """G (n - m, n) uint8 with H G^T = 0 over GF(2); raises when a row of
    H reduces to zero."""
    h = np.array(h, dtype=np.uint8) % 2
    m, n = h.shape
    pivot = np.zeros(m, dtype=np.int64)
    is_pivot = np.zeros(n, dtype=bool)
    for i in range(m):
        nz = np.nonzero(h[i])[0]
        if nz.size == 0:
            raise ValueError(f"row {i} of H reduces to zero")
        p = nz[0]
        pivot[i] = p
        rows = h[:, p].astype(bool)
        rows[i] = False
        h[rows] ^= h[i]
        is_pivot[p] = True
    free = np.nonzero(~is_pivot)[0]
    g = np.zeros((n - m, n), dtype=np.uint8)
    for r, j in enumerate(free):
        g[r, j] = 1
        g[r, pivot[np.nonzero(h[:, j])[0]]] = 1
    return g


def codewords(coeffs: torch.Tensor, g: np.ndarray) -> torch.Tensor:
    """(T, n) uint8 codewords: 0/1 coefficient rows (T, k) times G mod 2,
    exact in float64."""
    g_t = torch.as_tensor(g, dtype=torch.float64, device=coeffs.device)
    return (coeffs.to(torch.float64) @ g_t).remainder(2.0).to(torch.uint8)


def syndrome_zero(h: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """(B,) bool: H bits = 0 over GF(2), exact in float64."""
    prod = bits.to(torch.float64) @ h.to(torch.float64).T
    return (prod.remainder(2.0) == 0).all(dim=-1)
