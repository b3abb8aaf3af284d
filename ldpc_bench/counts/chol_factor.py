"""``chol_factor`` (``csrc/chol_fused.cu``): the IPM's Newton matrix of
each lane of a launch factored, M = L L^T, and the 64 x 64 diagonal blocks
of L inverted, in one launch.

Counted at the unpadded n, as the work the factor needs whatever
implements it (the kernel pads n to a multiple of 64 with an identity
tail; the padding is not counted).

Operations, per lane: the Cholesky factor, n^3 / 3 (n^3 / 6 multiply-adds,
two operations each), and each diagonal block's triangular inverse,
w^3 / 3 for a block of w columns below n (64, and n mod 64 in the last
block), against the float32 peak outside the tensor cores (the kernel sums
in full float32 FMAs).

Bytes, per lane: M read once (n^2 floats), L's lower triangle written once
(n (n + 1) / 2 floats) and each inverted block's lower triangle written once
(w (w + 1) / 2 floats).
"""
from __future__ import annotations

NB = 64


def _widths(n: int) -> list[int]:
    return [min(NB, n - qs) for qs in range(0, n, NB)]


def flops(lanes: int, n: int) -> float:
    return lanes * (n ** 3 / 3.0 + sum(w ** 3 / 3.0 for w in _widths(n)))


def bytes_moved(lanes: int, n: int) -> float:
    tri = n * n + n * (n + 1) / 2.0 + sum(w * (w + 1) / 2.0
                                          for w in _widths(n))
    return 4.0 * lanes * tri
