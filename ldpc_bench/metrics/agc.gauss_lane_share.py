"""Layer: the decoder (``decoders/agc_alp.py``, the cut loop's second cut
source). The lanes that ran the GF(2) elimination, those that may still
add cuts and gained no H cut in their round (the ``need`` mask handed to
the decoder's ``_gauss_sup``, summed on the device after the slice), over
the lane-rounds the loop held (the growth of ``COUNTS["lanes"]`` of
``decoders/alp.py``): how much work the second cut source does."""
import torch

from ldpc_bench.metrics import _program

KEY = "agc.gauss_lane_share"


def install(ctx):
    _program.install_counts(ctx)
    dec = ctx.decoder
    if dec is None or not getattr(dec, "use_gauss", False) or \
            KEY in ctx.records:
        return
    ctx.records[KEY] = []
    inner = dec._gauss_sup

    def counted(x, need=None):
        if ctx.tracing:
            ctx.records[KEY].append(
                torch.full((), x.shape[0], device=x.device) if need is None
                else need.sum(dtype=torch.int64))
        return inner(x, need)

    dec._gauss_sup = counted


def read(ctx, s):
    d = _program.deltas(ctx)
    recs = ctx.records.get(KEY)
    if d is None or recs is None or not d["alp"].get("lanes"):
        return None
    lanes = int(torch.stack(recs).sum()) if recs else 0
    ctx.notes[KEY] = {"gauss_lanes": lanes, "lane_rounds": d["alp"]["lanes"],
                      "calls": len(recs)}
    return lanes / d["alp"]["lanes"]
