"""Quasi-cyclic parity-check matrix representation (counterpart of
``ldpc_tpu/codes/qc.py``).

The reference's ``PermutationsMatrix`` (``optimize_H.cpp:27-86``): H is a
grid of z x z blocks, each either zero or a cyclically shifted identity.
Host-side NumPy; the matrix optimizer mutates these between evaluations on
the device. Every random draw comes from a ``np.random.Generator`` in the
JAX package's order, so a seed gives the same proposals in both packages.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .gf2 import gf2_nullspace

__all__ = ["QCMatrix"]


@dataclass
class QCMatrix:
    z: int                      # block size (20 in the reference)
    present: np.ndarray         # (R, C) bool
    shifts: np.ndarray          # (R, C) int, valid where present

    @staticmethod
    def from_dense(h: np.ndarray, z: int) -> "QCMatrix":
        """Validate and decode a dense QC matrix (``optimize_H.cpp:32-51``)."""
        h = np.asarray(h, dtype=np.uint8)
        m, n = h.shape
        if m % z or n % z:
            raise ValueError("matrix dims not divisible by block size")
        rb, cb = m // z, n // z
        present = np.zeros((rb, cb), bool)
        shifts = np.zeros((rb, cb), np.int64)
        for i in range(rb):
            for j in range(cb):
                blk = h[i * z:(i + 1) * z, j * z:(j + 1) * z]
                ks, ls = np.nonzero(blk)
                if ks.size == 0:
                    continue
                s = (ls - ks) % z
                if not (s == s[0]).all() or ks.size != z:
                    raise ValueError(f"block ({i},{j}) is not a shifted "
                                     f"identity")
                present[i, j] = True
                shifts[i, j] = s[0]
        qc = QCMatrix(z, present, shifts)
        if not (qc.to_dense() == h).all():
            raise ValueError("QC round-trip failed")
        return qc

    def to_dense(self) -> np.ndarray:
        """``H[i*z+k, j*z+(s+k)%z] = 1`` (``optimize_H.cpp:53-68``)."""
        rb, cb = self.present.shape
        z = self.z
        h = np.zeros((rb * z, cb * z), np.uint8)
        k = np.arange(z)
        for i in range(rb):
            for j in range(cb):
                if self.present[i, j]:
                    h[i * z + k, j * z + (self.shifts[i, j] + k) % z] = 1
        return h

    def random_mutation(self, rng: np.random.Generator) -> "QCMatrix":
        """One local-move proposal (``optimize_H.cpp:70-80``): pick a random
        block; toggle its presence (always when absent, with probability 1/2
        when present); draw a new shift."""
        rb, cb = self.present.shape
        i = int(rng.integers(rb))
        j = int(rng.integers(cb))
        present = self.present.copy()
        shifts = self.shifts.copy()
        if not present[i, j] or rng.integers(2) == 0:
            present[i, j] = ~present[i, j]
        shifts[i, j] = int(rng.integers(self.z))
        return QCMatrix(self.z, present, shifts)

    @staticmethod
    def random(rng: np.random.Generator, z: int, rb: int, cb: int,
               require_regular: bool = True) -> "QCMatrix":
        """Rejection-sample a random QC matrix whose dense form admits a
        generator matrix (``optimize_H.cpp:106-122``)."""
        while True:
            present = rng.integers(0, 2, (rb, cb)).astype(bool)
            shifts = rng.integers(0, z, (rb, cb))
            qc = QCMatrix(z, present, shifts)
            if not require_regular:
                return qc
            _, ok = gf2_nullspace(qc.to_dense())
            if ok:
                return qc
