"""What the readers of the program's own spans and counters share.

The program names its steps with ``record_function`` ranges while a
profiler records (``ldpc_tpu_torch.utils.profiling.SPANS``); added to the
slice's spans, they name the idle gaps (``trace._gaps``) and the device
time under them (``busy_under_us``). Its counters are host integers in the
modules where the work happens (``COUNTS`` of ``decoders/alp.py``,
``ops/lp_solver.py`` and ``harness/experiment.py``, and
``ops/pdhg_kernel.LAUNCHES``): snapshotted when the readers are installed,
before the slice, and differenced after it. A program without them gives
nothing to read, and no error.
"""


def spans():
    """The program's span names, or None where it opens none."""
    from ldpc_tpu_torch.utils import profiling
    return getattr(profiling, "SPANS", None)


def install_spans(ctx) -> None:
    names = spans()
    if names:
        ctx.spans |= names


def idle_share(s: dict, prefixes: tuple):
    """Device idle time in gaps whose innermost span starts with one of
    ``prefixes``, over the slice's wall time; None without a device trace
    or without the program's spans."""
    if not spans() or s["busy_us"] <= 0 or s["window_us"] <= 0:
        return None
    idle = sum(us for label, us in s["idle_by_host"]
               if label.split(" > ")[0].startswith(prefixes))
    return idle / s["window_us"]


def counts():
    """{owner: copy of its counters}, or None where the program has none."""
    from ldpc_tpu_torch.decoders import alp
    from ldpc_tpu_torch.harness import experiment
    from ldpc_tpu_torch.ops import lp_solver, pdhg_kernel
    owners = {"alp": alp, "lp": lp_solver, "harness": experiment}
    if not all(hasattr(m, "COUNTS") for m in owners.values()):
        return None
    out = {key: dict(m.COUNTS) for key, m in owners.items()}
    out["pdhg_kernel"] = {"launches": pdhg_kernel.LAUNCHES}
    return out


def install_counts(ctx) -> None:
    if "program.counts" not in ctx.records:
        ctx.records["program.counts"] = [counts()]


def deltas(ctx):
    """Each counter's growth since ``install_counts``, or None."""
    start = ctx.records.get("program.counts")
    now = counts()
    if not start or start[0] is None or now is None:
        return None
    return {key: {name: value - start[0][key].get(name, 0)
                  for name, value in now[key].items()} for key in now}
