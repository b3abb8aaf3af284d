"""Layer: the IPM's Newton-system Cholesky (``ops/chol.py`` ->
``ops/chol_kernel.py`` -> ``csrc/chol_fused.cu``), the fused factor. Its
bound time over its device time in the traced slice, in %.

The launches and their shapes come from the wrapper's counter by (lanes,
n) (``chol_kernel.FACTOR_SHAPE_LAUNCHES``, which the IPM graphs' replays add
to), differenced over the slice; each launch's bound from
``counts/chol_factor.py`` at the unpadded n: operations over the float32
peak or bytes over the memory bandwidth, the larger. The fused solve
kernel's device seconds and launches go to the notes. A program without
the counter (the blocked chain) gives nothing to read."""
from collections import Counter

from ldpc_bench.counts import chol_factor
from ldpc_bench.counts.peaks import bound_s

KEY = "chol_factor_roofline"


def _kernels():
    """The wrappers' module, or None where it has no fused factor."""
    from ldpc_tpu_torch.ops import chol_kernel
    if not hasattr(chol_kernel, "FACTOR_SHAPE_LAUNCHES"):
        return None
    return chol_kernel


def _device_s(s, name):
    return sum(us for op, us in s["device_us_by_name"].items()
               if name in op) / 1e6


def install(ctx):
    mod = _kernels()
    if mod is None or KEY in ctx.records:
        return
    ctx.records[KEY] = [(Counter(mod.FACTOR_SHAPE_LAUNCHES),
                         mod.SOLVE_LAUNCHES)]


def read(ctx, s):
    mod, start = _kernels(), ctx.records.get(KEY)
    kernel_s = _device_s(s, "chol_factor")
    if mod is None or not start or kernel_s <= 0 or ctx.peaks is None:
        return None
    shapes = Counter(mod.FACTOR_SHAPE_LAUNCHES)
    shapes.subtract(start[0][0])
    shapes = +shapes
    total, by = 0.0, {}
    for (lanes, n), launches in shapes.items():
        b, what = bound_s(chol_factor.flops(lanes, n),
                          chol_factor.bytes_moved(lanes, n), ctx.peaks)
        total += launches * b
        by[what] = by.get(what, 0.0) + launches * b
    if not by:
        return None
    ctx.notes[KEY] = {
        "bound_s": total, "kernel_s": kernel_s,
        "binds": max(by, key=by.get), "launches": sum(shapes.values()),
        "launches_by_shape": {f"{lanes}x{n}": c for (lanes, n), c
                              in sorted(shapes.items())},
        "solve_s": _device_s(s, "chol_solve"),
        "solve_launches": mod.SOLVE_LAUNCHES - start[0][1]}
    return 100.0 * total / kernel_s
