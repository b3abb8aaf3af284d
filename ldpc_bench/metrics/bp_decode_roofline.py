"""Layer: the BP kernel (``ops/bp_kernel.py`` -> ``csrc/bp_decode.cu``).
The kernel's bound time over its device time in the traced slice, in %.
The bound of each launch counts the iterations its lanes actually ran
(``counts/bp_decode.py``); the launch's own outputs give them."""
import torch

from ldpc_bench.counts import bp_decode
from ldpc_bench.counts.peaks import bound_s


def install(ctx):
    from ldpc_tpu_torch.ops import bp_kernel
    inner = bp_kernel.bp_decode

    def counted(llr, row_col, col_from_row, max_iter):
        out = inner(llr, row_col, col_from_row, max_iter)
        ctx.record("bp_decode", (out[2], llr.shape, row_col.shape,
                                 col_from_row.shape))
        return out

    bp_kernel.bp_decode = counted


def read(ctx, s):
    recs = ctx.records.get("bp_decode")
    kernel_us = sum(us for name, us in s["device_us_by_name"].items()
                    if "bp_decode" in name)
    if not recs or kernel_us <= 0 or ctx.peaks is None:
        return None
    its = torch.stack([r[0].sum(dtype=torch.int64) for r in recs]).tolist()
    edges = ctx.config["code_shape"]["edges"]
    total, by = 0.0, {}
    for it, (_, (lanes, n), (m, dc), (_, dv)) in zip(its, recs):
        t, what = bound_s(bp_decode.flops(it, edges),
                          bp_decode.bytes_moved(lanes, n, m, dc, dv),
                          ctx.peaks)
        total += t
        by[what] = by.get(what, 0.0) + t
    ctx.notes["bp_decode_roofline"] = {
        "bound_s": total, "kernel_s": kernel_us / 1e6,
        "binds": max(by, key=by.get), "launches": len(recs)}
    return 100.0 * total / (kernel_us / 1e6)
