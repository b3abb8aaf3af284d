"""Layer: the decoder's cut search (``alp_cut_candidates``, ``cut_hashes``,
``append_cuts`` in ``decoders/alp.py``). Device time under the benchmark's
span around those three calls over the device's busy time."""


def install(ctx):
    from ldpc_tpu_torch.decoders import alp
    wrap = ctx.span("cut_search")
    for name in ("alp_cut_candidates", "cut_hashes", "append_cuts"):
        setattr(alp, name, wrap(getattr(alp, name)))


def read(ctx, s):
    inside = s["busy_under_us"].get("bench.cut_search")
    if inside is None or s["busy_us"] <= 0:
        return None
    return inside / s["busy_us"]
