"""Layer: the IPM's normal-matrix kernel (``ops/gemv_kernel.py`` ->
``csrc/normal_build.cu``). The kernel's bound time over its device time in
the traced slice, in %.

The solve runs as CUDA graphs, whose replays skip the kernel's Python
wrapper, so the launches are taken from each call of ``ipm_box_lp``, which
runs on every solve, graphs or not: its lanes, its row tier T and n, and
its Newton steps, the growth of the solver's ``COUNTS["chunks"]`` over the
call times ``check_every``, one launch each (``counts/normal_build.py``).
They are checked against the kernel's launch count by T
(``gemv_kernel.NORMAL_TIER_LAUNCHES``, which the replays add to), in the
notes, beside the device seconds of each of the IPM's hand-written kernels.
A program without the solver's counters gives nothing to read."""
from collections import Counter

import torch

from ldpc_bench.counts import normal_build

KEY = "normal_build_roofline"
# the hand-written kernels of the IPM and the elimination, whose device
# seconds go to the notes beside the bound (the breakdown keeps ten names)
IPM_KERNELS = ("normal_build", "chol_diag_inv", "gemv_fwd", "gemv_tr",
               "ipm_step_len", "ipm_update", "gf2_gauss")


def _modules():
    from ldpc_tpu_torch.decoders import alp
    from ldpc_tpu_torch.ops import gemv_kernel, ipm_solver
    if not hasattr(ipm_solver, "COUNTS"):
        return None
    return alp, gemv_kernel, ipm_solver


def _tensor_peak(device):
    """The device's dense bfloat16 tensor-core peak, or None."""
    if device.type != "cuda":
        return None
    return normal_build.TENSOR_BF16_FLOPS.get(torch.cuda.get_device_name(
        device))


def install(ctx):
    mods = _modules()
    if mods is None or KEY + ".tiers" in ctx.records:
        return
    alp, gemv_kernel, ipm_solver = mods
    ctx.records[KEY + ".tiers"] = [Counter(gemv_kernel.NORMAL_TIER_LAUNCHES)]
    inner = alp.ipm_box_lp

    def counted(c, a_rows, b, *args, **kwargs):
        chunks = ipm_solver.COUNTS["chunks"]
        out = inner(c, a_rows, b, *args, **kwargs)
        ctx.record(KEY, (tuple(a_rows.shape),
                         ipm_solver.COUNTS["chunks"] - chunks,
                         kwargs.get("check_every", 5)))
        return out

    alp.ipm_box_lp = counted


def read(ctx, s):
    recs = ctx.records.get(KEY)
    mods = _modules()
    kernel_us = sum(us for name, us in s["device_us_by_name"].items()
                    if "normal_build" in name)
    tensor = _tensor_peak(ctx.device)
    if not recs or mods is None or kernel_us <= 0 or ctx.peaks is None \
            or tensor is None:
        return None
    total, by, launches = 0.0, {}, Counter()
    for (lanes, t, n), chunks, every in recs:
        steps = chunks * every
        b, what = normal_build.bound_s(
            normal_build.flops(lanes, t, n), normal_build.bytes_moved(
                lanes, t, n), tensor, ctx.peaks["hbm_bytes_s"])
        total += steps * b
        by[what] = by.get(what, 0.0) + steps * b
        launches[t] += steps
    counted = Counter(mods[1].NORMAL_TIER_LAUNCHES)
    counted.subtract(ctx.records[KEY + ".tiers"][0])
    counted = +counted
    ctx.notes[KEY] = {
        "bound_s": total, "kernel_s": kernel_us / 1e6,
        "binds": max(by, key=by.get) if by else None,
        "launches": sum(launches.values()), "solves": len(recs),
        "launches_by_tier": dict(sorted(launches.items())),
        "kernel_launches_by_tier": dict(sorted(counted.items())),
        "agree": launches == counted,
        "ipm_kernels_s": {k: sum(us for name, us in
                                 s["device_us_by_name"].items() if k in name)
                          / 1e6 for k in IPM_KERNELS}}
    if not by:
        return None
    return 100.0 * total / (kernel_us / 1e6)
