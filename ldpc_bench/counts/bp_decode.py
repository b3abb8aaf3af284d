"""``bp_decode`` (``csrc/bp_decode.cu``): flooding sum-product BP with
early exit, one codeword per block, messages held on the chip.

Operations, per edge and iteration a lane actually ran: the check node's
|v2c|, phi (a half-scale, tanh and log), the row sum, the self-exclusion,
phi again and the sign product (10), and the variable node's column sum and
extrinsic difference (2): 12, each transcendental counted as one operation.
The syndrome test is integer work and not counted.

Bytes, per launch: the LLRs read (4 bytes a bit), the bits written (1), the
success flag (1) and iteration count (4) of each lane, the two edge tables
read once (4 bytes an entry).
"""
from __future__ import annotations

OPS_PER_EDGE_ITERATION = 12


def flops(lane_iterations: int, edges: int) -> float:
    """Operations of one launch whose lanes ran ``lane_iterations``
    iterations in all, on a code of ``edges`` edges."""
    return float(OPS_PER_EDGE_ITERATION) * lane_iterations * edges


def bytes_moved(lanes: int, n: int, m: int, dc: int, dv: int) -> float:
    return float(lanes * (n * 4 + n + 1 + 4) + (m * dc + n * dv) * 4)
