"""``admm_iterate`` (``csrc/admm_iterate.cu``): QP-ADMM's iterations, each
lane to its own stop inside one launch, its state updated in place.

Operations, per iteration a lane actually ran, from the reference's
arithmetic (``reference/qp-admm.py``) on the cascade's real rows: n_var
variables, n_con constraints and ``entries`` (constraint, coefficient)
entries, as many on the constraints' side as on the variables'. A product
with a coefficient of +-1 is a sign and not counted; every add, multiply
and bound of a clamp is one operation.

* each constraint: t = yl + mu (z - b) (3), r = b - its terms (one a
  term), max(0, r - yl) and max(0, yl - r) (4), d = z - r, d d and the
  stop's sum (3): 10, and one an entry;
* each variable: its terms' sum (one an entry, less one), q + alpha / 2
  and the sum added to it (2), the scaling and the clamp's two bounds (3):
  4, and one an entry.

That is 2 entries + 4 n_var + 10 n_con a lane-iteration: 39,920 on
optimalH's cascade (700, 2,320, 6,960), 40.9 M an iteration at 1,024
lanes. The stop's test is a compare and not counted.

Bytes, per launch: of each lane not done when it starts, q and v read
and v written (4 bytes a variable each), z and yl read and written (4 a
constraint each), its done flag (1) and count (4) read and written; the
tables read once: an index (4) and a coefficient (4) per entry on each
side, b and e.
"""
from __future__ import annotations


def ops_per_lane_iteration(n_var: int, n_con: int, entries: int) -> int:
    return 2 * entries + 4 * n_var + 10 * n_con


def flops(lane_iterations: int, n_var: int, n_con: int,
          entries: int) -> float:
    """Operations of one launch whose lanes ran ``lane_iterations``
    iterations in all."""
    return float(lane_iterations) * ops_per_lane_iteration(n_var, n_con,
                                                           entries)


def bytes_moved(lanes: int, n_var: int, n_con: int, entries: int) -> float:
    state = 12 * n_var + 16 * n_con + 2 * (1 + 4)
    tables = 2 * 8 * entries + 4 * n_con + 4 * n_var
    return float(lanes * state + tables)
