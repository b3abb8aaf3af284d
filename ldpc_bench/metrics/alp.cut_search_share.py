"""Layer: the decoder's cut search (``alp_cut_candidates`` and
``cut_hashes`` in ``decoders/alp.py``, each under the program's span
``alp.cut_search``). Device time under that span over the device's busy
time. ``append_cuts`` is not counted in it: it has its own span,
``alp.append``."""
from ldpc_bench.metrics import _program

SPAN = "alp.cut_search"


def install(ctx):
    _program.install_spans(ctx)


def read(ctx, s):
    inside = s["busy_under_us"].get(SPAN)
    if inside is None or s["busy_us"] <= 0:
        return None
    return inside / s["busy_us"]
