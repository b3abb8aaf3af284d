"""Layer: the harness (``harness/experiment.py``: the channel, the LLR
scaling, the classification and counters). Device time per batch outside
the benchmark's span around ``decoder.decode_batch``, in ms."""


def read(ctx, s):
    inside = s["busy_under_us"].get("bench.decode")
    if inside is None or not s["batches"]:
        return None
    return (s["busy_us"] - inside) / s["batches"] / 1e3
