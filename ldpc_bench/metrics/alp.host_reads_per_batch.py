"""Layer: the decoder (``decoders/alp.py``, the cut loop). Device-to-host
copies in the traced slice per batch decoded; each waits for the stream."""


def read(ctx, s):
    if not s["batches"] or s["busy_us"] <= 0:
        return None
    return s["host_reads"] / s["batches"]
