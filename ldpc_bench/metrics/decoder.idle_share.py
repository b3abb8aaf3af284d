"""Layer: the decoder (``decoders/*.py`` and the LP solvers of
``ops/lp_solver.py``, ``ops/ipm_solver.py``). Device idle time in the gaps
whose innermost span is one of the program's ``bp.*``, ``alp.*``,
``agc.*`` or ``lp.*`` spans (the decode, the cut round and its steps, the
host reads, the solves and their chunk polls), over the traced slice's
wall time."""
from ldpc_bench.metrics import _program


def install(ctx):
    _program.install_spans(ctx)


def read(ctx, s):
    return _program.idle_share(s, ("bp.", "alp.", "agc.", "lp."))
