"""The IPM Newton step's two kernels (``csrc/ipm_step.cu``) on one CUDA
device: device time per call at every AGC-ALP row tier and at H02's.

Calls ``ops.ipm_kernel.ipm_step_len`` and ``ipm_update`` through their
public wrappers, which every tree with the kernels has, so that the same
script also times another tree: run it with that tree's package first on
``PYTHONPATH`` (``PYTHONPATH=<tree> python <this file>``). At each of
``SHAPES`` (128 lanes at optimalH's eight row tiers, T = 128 ... 1408 and
n = 280; 256 lanes at T = 1408; 128 lanes at H02's deepest tier, T = 2176
and n = 640) the inputs are interior values and Newton directions from a
seed; both kernels are held to their twins (``ops/ipm_ref.py``) bit for bit
and then timed as CUDA graphs of calls, the median over ``ROUNDS`` graphs
of ``REPLAYS`` replays each: warm (``CALLS`` calls on the same inputs, the
data in L2, as on the solve's path, where the Newton step has just written
it) and cold (one call on each of enough copies of the inputs to fill
twice the 50 MB L2, so that the data comes from HBM). Where the tree has
``ipm_step_plan`` it also prints each plan, the launch floor (an empty
kernel of the plan's grid, timed warm) and the bytes bound
(``step_len_bytes`` / ``update_bytes`` over 3.35 TB/s, which the cold time
is held against); ``--variants`` then times other layouts of ``VARIANTS``
(threads, passes, width 1) through the kernel library's launcher
(``ops/_launch.py`` ``launch``), held to the twins the same way. Exits
non-zero when a kernel differs from its twin. The last line is one JSON
object with every figure and the card (``nvidia-smi``'s name and power
limit).

    python -m scripts.torch_ipm_step_speed [--variants] [--label parent]
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys

import torch

from ldpc_tpu_torch import bench
from ldpc_tpu_torch.ops import ipm_kernel
from ldpc_tpu_torch.ops.ipm_ref import ipm_step_len_ref, ipm_update_ref

AGC_TIERS = (128, 256, 384, 512, 640, 896, 1152, 1408)
SHAPES = (*((128, t, 280) for t in AGC_TIERS), (256, 1408, 280),
          (128, 2176, 640))
CALLS = 8
REPLAYS = 20
ROUNDS = 3
HBM_BYTES_PER_S = 3.35e12
L2_BYTES = 50 * 2 ** 20


def _layout(bsz, vec, threads):
    return {"vec": vec, "threads": threads, "blocks": bsz}


# (lanes, T, n, layout): the plan's alternatives at the path's shapes and
# at one lane: more threads than the plan's, width 1 on aligned arrays,
# fewer threads and several passes
VARIANTS = (
    (128, 128, 280, _layout(128, 4, 96)),
    (128, 128, 280, _layout(128, 4, 128)),
    (128, 128, 280, _layout(128, 4, 256)),
    (128, 1408, 280, _layout(128, 4, 352)),
    (128, 1408, 280, _layout(128, 1, 352)),
    (128, 1408, 280, _layout(128, 4, 512)),
    (128, 1408, 280, _layout(128, 4, 96)),
    (128, 2176, 640, _layout(128, 4, 544)),
    (128, 2176, 640, _layout(128, 4, 288)),
    (1, 1408, 280, _layout(1, 4, 352)),
)


def _inputs(bsz, t, n, seed):
    """(step-length arguments, state, dirs, (ap, ad)) on the card: interior
    values, random directions, step lengths in [0, 1.2)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rand(w, lo, hi):
        return torch.rand((bsz, w), generator=gen, device="cuda") * (
            hi - lo) + lo

    def normal(w):
        return torch.randn((bsz, w), generator=gen, device="cuda") * 2.0

    x = rand(n, 1e-3, 1.0 - 1e-3)
    s, y, zl, zu = rand(t, 1e-3, 5.0), rand(t, 1e-3, 5.0), rand(
        n, 1e-3, 5.0), rand(n, 1e-3, 5.0)
    dx, dy, ds, dzl, dzu, adx = (normal(n), normal(t), normal(t), normal(n),
                                 normal(n), normal(t))
    w, ax = 1.0 - x, normal(t)
    ap = torch.rand(bsz, generator=gen, device="cuda") * 1.2
    ad = torch.rand(bsz, generator=gen, device="cuda") * 1.2
    return ((s, ds, x, dx, w, y, dy, zl, dzl, zu, dzu),
            (x, w, s, y, zl, zu, ax), (dx, dy, ds, dzl, dzu, adx), (ap, ad))


def _graph_ms(fn, calls) -> float:
    """Device ms per call of ``fn(*c)`` for c in ``calls``: the calls
    captured in a CUDA graph (after a warm-up call), replayed REPLAYS
    times; the median of ROUNDS such graphs."""
    fn(*calls[0])
    torch.cuda.synchronize()
    times = []
    for _ in range(ROUNDS):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for c in calls:
                fn(*c)
        graph.replay()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(REPLAYS):
            graph.replay()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / (REPLAYS * len(calls)))
    return statistics.median(times)


def _tensors(call):
    for a in call:
        yield from (a if isinstance(a, tuple) else (a,))


def _rotation(call) -> list:
    """``call`` and copies of its tensors that, with it, fill twice the
    L2."""
    nbytes = sum(u.numel() * u.element_size() for u in _tensors(call))

    def clone(a):
        return (tuple(u.clone() for u in a) if isinstance(a, tuple)
                else a.clone())
    return [call] + [tuple(clone(a) for a in call)
                     for _ in range(-(-2 * L2_BYTES // nbytes))]


def _same(got, want) -> bool:
    return all(torch.equal(g.view(torch.int32), w.view(torch.int32))
               for g, w in zip(got, want))


def _bounds_ms(bsz, t, n):
    """Each kernel's bytes bound in ms, or None for a tree without the
    byte counts."""
    if not hasattr(ipm_kernel, "step_len_bytes"):
        return None
    return {"ipm_step_len": ipm_kernel.step_len_bytes(bsz, t, n)
            / HBM_BYTES_PER_S * 1e3,
            "ipm_update": ipm_kernel.update_bytes(bsz, t, n)
            / HBM_BYTES_PER_S * 1e3}


def _measure(bsz, t, n, seed, step_len, update, bad, label) -> dict:
    """Both kernels (``step_len(args) -> (ap, ad)``, ``update(state, dirs,
    ap, ad)`` in place) against their twins, then timed warm and cold."""
    args, state, dirs, aps = _inputs(bsz, t, n, seed)
    out = tuple(v.clone() for v in state)
    got = step_len(args)
    update(out, dirs, *aps)
    torch.cuda.synchronize()
    exact = (_same(got, ipm_step_len_ref(*args)),
             _same(out, ipm_update_ref(state, dirs, *aps)))
    for name, ok in zip(("ipm_step_len", "ipm_update"), exact):
        if not ok:
            bad.append(f"{name} differs from its twin at {label}")
    row = {"bit_for_bit": all(exact)}
    for name, fn, call in (("ipm_step_len", step_len, (args,)),
                           ("ipm_update", update, (out, dirs, *aps))):
        row[name] = _graph_ms(fn, [call] * CALLS)
        cold = _rotation(call)
        row[name + "_cold"] = _graph_ms(fn, cold)
        del cold
    return row


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--variants", action="store_true")
    p.add_argument("--label", default="")
    args = p.parse_args(argv)
    dev = torch.device("cuda")
    planned = hasattr(ipm_kernel, "ipm_step_plan")
    rows, variants, bad = [], [], []
    for i, (bsz, t, n) in enumerate(SHAPES):
        label = f"{bsz}x{t}x{n}"
        row = {"shape": label, **_measure(
            bsz, t, n, 100 + i, lambda a: ipm_kernel.ipm_step_len(*a),
            ipm_kernel.ipm_update, bad, label)}
        row["bound_ms"] = _bounds_ms(bsz, t, n)
        if planned:
            plan = ipm_kernel.ipm_step_plan(bsz, t, n, True)
            row["plan"] = plan
            row["floor_ms"] = _graph_ms(
                lambda: ipm_kernel.empty_kernel(plan, dev), [()] * CALLS)
        print(" ".join(f"{k} {v}" for k, v in row.items()), flush=True)
        rows.append(row)
    if args.variants:
        from ldpc_tpu_torch.ops._launch import launch
        from ldpc_tpu_torch.ops.ipm_ref import FLOOR
        for i, (bsz, t, n, plan) in enumerate(VARIANTS):
            label = f"{bsz}x{t}x{n} {plan}"

            def step_len(a, plan=plan, shape=(bsz, t, n)):
                ap = torch.empty(a[0].shape[0], device=dev)
                ad = torch.empty_like(ap)
                launch("ipm_step_len", "ldpc_ipm_step_len", dev, *a, ap, ad,
                       *shape, 0.995, plan["vec"], plan["threads"])
                return ap, ad

            def update(state, dirs, ap, ad, plan=plan, shape=(bsz, t, n)):
                launch("ipm_update", "ldpc_ipm_update", dev, *state, *dirs,
                       ap, ad, *shape, FLOOR, 1.0 - FLOOR, plan["vec"],
                       plan["threads"])

            row = {"shape": f"{bsz}x{t}x{n}", "plan": plan, **_measure(
                bsz, t, n, 200 + i, step_len, update, bad, label),
                "floor_ms": _graph_ms(
                    lambda plan=plan: ipm_kernel.empty_kernel(plan, dev),
                    [()] * CALLS)}
            print(" ".join(f"{k} {v}" for k, v in row.items()), flush=True)
            variants.append(row)
    print(json.dumps({"ipm_step_speed": rows, "variants": variants,
                      "label": args.label, "card": bench.card_stamp(dev)}),
          flush=True)
    for msg in bad:
        print(f"FAILED: {msg}", file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
