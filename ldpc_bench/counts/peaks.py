"""Published peaks by device name (``torch.cuda.get_device_name()``).

NVIDIA H100 SXM5 80 GB data sheet, dense rates at the full 700 W: 67 TFLOP/s
in float32 outside the tensor cores, 3.35 TB/s of HBM3 bandwidth. A card set
below 700 W (``nvidia-smi --query-gpu=power.limit``) runs below them; the
benchmark prints the limit beside every share of a peak.
"""
from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"fp32_flops": 67e12, "hbm_bytes_s": 3.35e12},
}


def peaks(device_name: str) -> dict | None:
    """The device's peaks, or None for a device the table does not hold."""
    return PEAKS.get(device_name)


def bound_s(flops: float, nbytes: float, peak: dict) -> tuple[float, str]:
    """(seconds, what binds): the larger of the two times."""
    t_ops = flops / peak["fp32_flops"]
    t_mem = nbytes / peak["hbm_bytes_s"]
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")
