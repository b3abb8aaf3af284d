"""``gf2_gauss`` (``csrc/gf2_gauss.cu``): each lane's (m, n) 0/1 matrix,
its columns in the lane's order, row-reduced over GF(2); a lane not active
is copied through.

Bytes, per lane, active or not: its m n bytes read once and m n bytes
written once, and its active flag read.

Operations: integer (a 32-bit XOR takes 32 rows of a column at once) and not
counted, as BP's syndrome test is not; the launch's bound is its bytes.
What the kernel's time is set by instead, a chain of up to n dependent
column steps a lane, is the design's (``csrc/gf2_gauss.cu``), not the
roofline's.
"""
from __future__ import annotations


def flops(active_lanes: int, m: int, n: int) -> float:
    return 0.0


def bytes_moved(lanes: int, m: int, n: int) -> float:
    return float(lanes * (2 * m * n + 1))
