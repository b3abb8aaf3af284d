"""Layer: QP-ADMM's iteration kernel (``ops/admm_kernel.py`` ->
``csrc/admm_iterate.cu``), one launch a stream chunk. The kernel's bound
time over its device time in the traced slice, in %. Each launch's work is
the lane-iterations it really ran and the lanes that worked in it
(``metrics/_admm.py``), on the cascade's real rows
(``counts/admm_iterate.py``). The launches, lane-iterations, the kernel's
seconds and the program's chunk count go to the run's notes; a program
without QP-ADMM's counters gives nothing to read."""
from ldpc_bench.counts import admm_iterate
from ldpc_bench.counts.peaks import bound_s
from ldpc_bench.metrics import _admm

KEY = "admm_iterate_roofline"


def install(ctx):
    _admm.install(ctx)


def read(ctx, s):
    got = _admm.chunks(ctx)
    kernel_us = sum(us for name, us in s["device_us_by_name"].items()
                    if "admm_iterate" in name)
    if got is None or kernel_us <= 0 or ctx.peaks is None:
        return None
    recs, grown = got
    n_var, n_con, entries = _admm.rows(ctx)
    total, by = 0.0, {}
    for _, active, work in recs:
        b, what = bound_s(
            admm_iterate.flops(work, n_var, n_con, entries),
            admm_iterate.bytes_moved(active, n_var, n_con, entries),
            ctx.peaks)
        total += b
        by[what] = by.get(what, 0.0) + b
    ctx.notes[KEY] = {
        "bound_s": total, "kernel_s": kernel_us / 1e6,
        "binds": max(by, key=by.get), "launches": len(recs),
        "chunks": grown.get("chunks", 0),
        "lane_iterations": sum(w for _, _, w in recs),
        "rows": [n_var, n_con, entries]}
    return 100.0 * total / (kernel_us / 1e6)
