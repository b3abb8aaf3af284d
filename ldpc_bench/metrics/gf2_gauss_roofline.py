"""Layer: the GF(2) elimination kernel (``ops/gauss_kernel.py`` ->
``csrc/gf2_gauss.cu``), AGC-ALP's second cut source. The kernel's bound
time over its device time in the traced slice, in %. Each launch's work
comes from its own arguments: its lanes and their (m, n) matrices
(``counts/gf2_gauss.py``); the lanes it is told are active are summed on
the device after the slice, for the notes."""
import torch

from ldpc_bench.counts import gf2_gauss
from ldpc_bench.counts.peaks import bound_s

KEY = "gf2_gauss_roofline"


def install(ctx):
    from ldpc_tpu_torch.ops import gf2_gauss as program
    inner = program.gf2_eliminate

    def counted(h_perm, active):
        out = inner(h_perm, active)
        ctx.record(KEY, (active, tuple(h_perm.shape)))
        return out

    program.gf2_eliminate = counted


def read(ctx, s):
    recs = ctx.records.get(KEY)
    kernel_us = sum(us for name, us in s["device_us_by_name"].items()
                    if "gf2_gauss" in name)
    if not recs or kernel_us <= 0 or ctx.peaks is None:
        return None
    active = torch.stack([a.sum(dtype=torch.int64) for a, _ in recs]).tolist()
    total, by = 0.0, {}
    for n_act, (_, (lanes, m, n)) in zip(active, recs):
        b, what = bound_s(gf2_gauss.flops(n_act, m, n),
                          gf2_gauss.bytes_moved(lanes, m, n), ctx.peaks)
        total += b
        by[what] = by.get(what, 0.0) + b
    ctx.notes[KEY] = {
        "bound_s": total, "kernel_s": kernel_us / 1e6,
        "binds": max(by, key=by.get), "launches": len(recs),
        "active_lanes": sum(active),
        "lanes": sum(shape[0] for _, shape in recs)}
    return 100.0 * total / (kernel_us / 1e6)
