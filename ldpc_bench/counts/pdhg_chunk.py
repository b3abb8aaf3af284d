"""``pdhg_chunk`` (``csrc/pdhg_chunk.cu``): ``steps`` preconditioned PDHG
steps per lane on a (T, n) slice of dense cut rows, then the lane's error.

Operations, per active lane and step: the two products A^T y and
A (2x' - x), two operations (a multiply and an add) an entry each, so 4 T n.
Inactive lanes pass through and are not counted.

Bytes, per launch: an active lane reads its rows once as they lie in device
memory (float32, 4 T n), c, tau and x (3 n floats), b, sigma and y (3 T),
and writes x, y, its error and its flag (n + T + 2); an inactive lane reads
and writes x and y.
"""
from __future__ import annotations


def flops(active_lanes: int, steps: int, t: int, n: int) -> float:
    return 4.0 * active_lanes * steps * t * n


def bytes_moved(active_lanes: int, lanes: int, t: int, n: int) -> float:
    active = 4.0 * (t * n + 3 * n + 3 * t + n + t + 2)
    passive = 4.0 * 2 * (n + t)
    return active_lanes * active + (lanes - active_lanes) * passive
