"""Layer: the decoder (``decoders/alp.py``, the batched cut loop). The
share of a batch's lane slots that re-solve in its average round: the
working lanes each round reads with its row tier (``COUNTS["solve_lanes"]``)
over the batch's lanes, once a round (``COUNTS["lanes"]``), summed over the
traced slice. The loop's useful work over what it holds."""
from ldpc_bench.metrics import _program


def install(ctx):
    _program.install_counts(ctx)


def read(ctx, s):
    d = _program.deltas(ctx)
    if d is None or not d["alp"].get("lanes"):
        return None
    return d["alp"].get("solve_lanes", 0) / d["alp"]["lanes"]
