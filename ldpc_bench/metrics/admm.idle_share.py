"""Layer: the decoder (``decoders/admm.py``). Device idle time in the gaps
whose innermost span is one of the program's ``admm.*`` spans (the
batched decode, and the stream's start, chunk launches and finish), over
the traced slice's wall time. A program that opens no ``admm.*`` span
gives nothing to read."""
from ldpc_bench.metrics import _program


def install(ctx):
    _program.install_spans(ctx)


def read(ctx, s):
    names = _program.spans()
    if not names or not any(n.startswith("admm.") for n in names):
        return None
    return _program.idle_share(s, ("admm.",))
