"""``normal_build`` (``csrc/normal_build.cu``): the IPM's normal matrix
M = A^T diag(d) A + diag(dxx) + delta I of each lane of a launch, on the
tensor cores.

Operations, per lane: the products of A^T diag(d) A over the T rows of the
launch's slice (every row it is handed: zero rows are read and multiplied
like the others), on and above the diagonal only (M is symmetric, and the
kernel computes a tile only once), T n (n + 1) / 2 multiply-adds. d is
float32, and bfloat16 products are exact only on its three planes (hi, mid,
lo: ``gemv_ref.split_planes``), so each multiply-add is three, two
operations each: 3 T n (n + 1), against the dense bfloat16 tensor-core
peak. The diagonal's two adds are not counted.

Bytes, per lane: A's packed int8 copy read once (T n_pad, n_pad = n rounded
up to 16), d (T floats) and dxx (n floats) read, and M written (n^2 floats:
both triangles).
"""
from __future__ import annotations

# NVIDIA H100 SXM5 80 GB data sheet: dense bfloat16 on the tensor cores
TENSOR_BF16_FLOPS = {"NVIDIA H100 80GB HBM3": 989.4e12}
PAD = 16


def flops(lanes: int, t: int, n: int) -> float:
    return 3.0 * lanes * t * n * (n + 1)


def bytes_moved(lanes: int, t: int, n: int) -> float:
    n_pad = -(-n // PAD) * PAD
    return float(lanes * (t * n_pad + 4 * t + 4 * n + 4 * n * n))


def bound_s(ops: float, nbytes: float, tensor_flops: float,
            hbm_bytes_s: float) -> tuple[float, str]:
    """(seconds, what binds): the larger of operations over the tensor
    cores' peak and bytes over the memory bandwidth."""
    t_ops, t_mem = ops / tensor_flops, nbytes / hbm_bytes_s
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")
