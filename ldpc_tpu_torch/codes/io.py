"""Parity-check / generator matrix file I/O.

Format-compatible with the reference's comma-separated 0/1 text files
(``utils/parse_data.h:6-25`` for reading, ``:44-54`` for writing), so the
committed ``data/*.txt`` assets load unchanged. Counterpart of
``ldpc_tpu/codes/io.py``.
"""
from __future__ import annotations

import numpy as np

__all__ = ["read_pcm", "save_matrix", "read_codewords"]


def read_pcm(path: str) -> np.ndarray:
    """Read a comma-separated 0/1 matrix (one row per line) as uint8.

    Whitespace-separated tokens, each token a comma-separated list of bits; a
    trailing comma is tolerated.
    """
    rows = []
    with open(path) as f:
        for tok in f.read().split():
            rows.append([c == "1" for c in tok.split(",") if c != ""])
    arr = np.array(rows, dtype=np.uint8)
    if arr.ndim != 2:
        raise ValueError(f"ragged or empty matrix in {path}")
    return arr


def save_matrix(h: np.ndarray, path: str) -> None:
    """Write a 0/1 matrix in the reference CSV-ish format."""
    h = np.asarray(h, dtype=np.uint8)
    with open(path, "w") as f:
        for row in h:
            f.write(",".join("1" if b else "0" for b in row))
            f.write("\n")


def read_codewords(path: str) -> np.ndarray:
    """Read the ``data/codewords.txt`` format: a count line then one 0/1
    string per codeword.

    The reference's ``read_codewords`` (``utils/parse_data.h:28-42``) maps
    ``'0' -> true``, an inversion bug in dead code. The bits are read
    *uninverted* here, as in the JAX package.
    """
    with open(path) as f:
        toks = f.read().split()
    n = int(toks[0])
    words = [[c == "1" for c in t] for t in toks[1 : 1 + n]]
    return np.array(words, dtype=np.uint8)
