"""Layer: the device. The share of the traced slice's wall time in which
no operation ran on the device: 1 - (union of the intervals of kernels,
copies and fills) / (the slice's wall time)."""


def read(ctx, s):
    if s["window_us"] <= 0 or s["busy_us"] <= 0:
        return None
    return 1.0 - s["busy_us"] / s["window_us"]
