"""Layer: the harness (``harness/experiment.py``'s channel step, over
``ops/channel_kernel.py`` -> ``csrc/awgn_channel.cu``). Launches of the
channel kernel per batch handed to the decoder over the traced slice
(the growth of ``channel_kernel.LAUNCHES`` over that of
``experiment.COUNTS["batches"]``): 1 where each batch's channel is one
launch, 0 where it ran as plain tensor ops. A program without the kernel
gives nothing to read."""

KEY = "harness.channel_kernel_share"


def _counts():
    """(kernel launches, batches) so far, or None."""
    try:
        from ldpc_tpu_torch.ops import channel_kernel
    except ImportError:
        return None
    from ldpc_tpu_torch.harness import experiment
    if not hasattr(channel_kernel, "LAUNCHES") or \
            not hasattr(experiment, "COUNTS"):
        return None
    return channel_kernel.LAUNCHES, experiment.COUNTS["batches"]


def install(ctx):
    if KEY not in ctx.records:
        ctx.records[KEY] = [_counts()]


def read(ctx, s):
    start = ctx.records.get(KEY)
    now = _counts()
    if not start or start[0] is None or now is None:
        return None
    batches = now[1] - start[0][1]
    if batches <= 0:
        return None
    return (now[0] - start[0][0]) / batches
