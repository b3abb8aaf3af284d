"""Layer: the IPM Newton step's hand-written kernels (``ops/ipm_kernel.py``
-> ``csrc/ipm_step.cu``), the fused step. The correct kernel's launches
(``ipm_kernel.CORRECT_LAUNCHES``, which the IPM graphs' replays add to)
over the slice's Newton steps (the solver's ``COUNTS["chunks"]`` times the
decoder's ``ipm_check_every``), both differenced over the traced slice:
1.0 where every Newton step ran its elementwise work in the three fused
kernels, 0 where it ran as PyTorch ops. A program without the counter
gives nothing to read."""
KEY = "ipm.fused_step_share"


def _state():
    """(fused correct launches, Newton-step chunks run), or None."""
    from ldpc_tpu_torch.ops import ipm_kernel, ipm_solver
    if not hasattr(ipm_kernel, "CORRECT_LAUNCHES") or \
            not hasattr(ipm_solver, "COUNTS"):
        return None
    return ipm_kernel.CORRECT_LAUNCHES, ipm_solver.COUNTS["chunks"]


def install(ctx):
    if KEY not in ctx.records:
        ctx.records[KEY] = [_state()]


def read(ctx, s):
    start, now = ctx.records.get(KEY), _state()
    every = getattr(ctx.decoder, "ipm_check_every", None)
    if not start or start[0] is None or now is None or not every:
        return None
    steps = (now[1] - start[0][1]) * every
    if steps <= 0:
        return None
    launches = now[0] - start[0][0]
    ctx.notes[KEY] = {"correct_launches": launches, "newton_steps": steps}
    return launches / steps
