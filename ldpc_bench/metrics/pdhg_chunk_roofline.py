"""Layer: the PDHG kernel (``ops/pdhg_kernel.py`` -> ``csrc/pdhg_chunk.cu``).
The kernel's bound time over its device time in the traced slice, in %.
Each launch's work comes from its own arguments: the lanes it is told are
active, its steps, and its slice's T and n (``counts/pdhg_chunk.py``); the
active counts are summed on the device after the slice."""
import torch

from ldpc_bench.counts import pdhg_chunk
from ldpc_bench.counts.peaks import bound_s


def install(ctx):
    from ldpc_tpu_torch.ops import lp_solver
    inner = lp_solver.pdhg_chunk

    def counted(c, a, b, tau, sigma, x, y, iters, active=None,
                average=False):
        out = inner(c, a, b, tau, sigma, x, y, iters, active=active,
                    average=average)
        ctx.record("pdhg_chunk", (active, int(iters), a.shape))
        return out

    lp_solver.pdhg_chunk = counted


def read(ctx, s):
    recs = ctx.records.get("pdhg_chunk")
    kernel_us = sum(us for name, us in s["device_us_by_name"].items()
                    if "pdhg_chunk" in name)
    if not recs or kernel_us <= 0 or ctx.peaks is None:
        return None
    act = torch.stack([
        a.sum(dtype=torch.int64) if a is not None
        else torch.tensor(shape[0], device=ctx.device)
        for a, _, shape in recs]).tolist()
    total, by = 0.0, {}
    for n_act, (_, steps, (lanes, t, n)) in zip(act, recs):
        b, what = bound_s(pdhg_chunk.flops(n_act, steps, t, n),
                          pdhg_chunk.bytes_moved(n_act, lanes, t, n),
                          ctx.peaks)
        total += b
        by[what] = by.get(what, 0.0) + b
    ctx.notes["pdhg_chunk_roofline"] = {
        "bound_s": total, "kernel_s": kernel_us / 1e6,
        "binds": max(by, key=by.get), "launches": len(recs)}
    return 100.0 * total / (kernel_us / 1e6)
