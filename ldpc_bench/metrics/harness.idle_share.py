"""Layer: the harness (``harness/experiment.py``). Device idle time in the
gaps whose innermost span is one of the program's ``harness.*`` spans (the
block, the channel, the classification, the synchronises, the streamed
refill), over the traced slice's wall time."""
from ldpc_bench.metrics import _program


def install(ctx):
    _program.install_spans(ctx)


def read(ctx, s):
    return _program.idle_share(s, ("harness.",))
