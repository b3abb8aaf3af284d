"""Layer: the decoder (``decoders/alp.py``, its LP solver and the harness
that runs it). Host reads per batch decoded, as the program counts them at
each site (``reads.*`` of ``COUNTS`` in ``decoders/alp.py``,
``ops/lp_solver.py`` and ``harness/experiment.py``) over the traced slice,
over the batches the harness decoded there; each read waits for the
device. The split by site goes to the run's notes."""
from ldpc_bench.metrics import _program


def install(ctx):
    _program.install_counts(ctx)


def read(ctx, s):
    d = _program.deltas(ctx)
    if d is None or not d["harness"].get("batches"):
        return None
    batches = d["harness"]["batches"]
    sites = {f"{owner}.{name}": value / batches
             for owner in ("alp", "lp", "harness")
             for name, value in sorted(d[owner].items())
             if name.startswith("reads.")}
    ctx.notes["alp.sync_reads_per_batch"] = {"batches": batches,
                                             "per_batch": sites}
    return sum(sites.values())
