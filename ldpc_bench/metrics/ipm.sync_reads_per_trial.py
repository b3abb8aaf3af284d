"""Layer: the decoder (``decoders/alp.py``'s cut loop as AGC-ALP runs it,
its IPM solver ``ops/ipm_solver.py`` and the streamed runner that feeds
it). Host reads per trial finished, as the program counts them at each
site (``reads.*`` of ``COUNTS`` in those three modules) over the traced
slice, over the slice's ``trials`` (a streamed runner hands no batch to
``decode_batch``); each read waits for the device. The split by site, the
solves and chunks per trial and the IPM's graph captures in the slice go
to the run's notes. A program without the solver's counters gives nothing
to read."""
from ldpc_bench.metrics import _program

KEY = "ipm.sync_reads_per_trial"


def _ipm():
    """(the solver's counters, graph captures so far), or None."""
    from ldpc_tpu_torch.ops import ipm_graph, ipm_solver
    counts = getattr(ipm_solver, "COUNTS", None)
    if counts is None:
        return None
    return dict(counts), ipm_graph.CAPTURES


def install(ctx):
    _program.install_counts(ctx)
    if KEY not in ctx.records:
        ctx.records[KEY] = [_ipm()]


def read(ctx, s):
    d = _program.deltas(ctx)
    start, now = ctx.records.get(KEY), _ipm()
    trials = s.get("trials", 0)
    if d is None or not start or start[0] is None or now is None or \
            trials <= 0:
        return None
    d["ipm"] = {k: v - start[0][0].get(k, 0) for k, v in now[0].items()}
    sites = {f"{owner}.{name}": value / trials
             for owner in ("alp", "ipm", "harness")
             for name, value in sorted(d[owner].items())
             if name.startswith("reads.")}
    ctx.notes[KEY] = {
        "trials": trials, "per_trial": sites,
        "solves_per_trial": d["ipm"].get("solves", 0) / trials,
        "chunks_per_trial": d["ipm"].get("chunks", 0) / trials,
        "graph_captures": now[1] - start[0][1]}
    return sum(sites.values())
