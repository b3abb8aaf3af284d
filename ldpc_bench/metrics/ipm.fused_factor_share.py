"""Layer: the IPM's Newton-system Cholesky (``ops/chol.py`` ->
``csrc/chol_fused.cu``). The fused factor's launches
(``chol_kernel.FACTOR_LAUNCHES``, which the IPM graphs' replays add to)
over the slice's Newton steps (the solver's ``COUNTS["chunks"]`` times the
decoder's ``ipm_check_every``), both differenced over the traced slice:
1.0 where every Newton step factored in the one fused launch, 0 where the
blocked chain ran. A program without the counter gives nothing to read."""
KEY = "ipm.fused_factor_share"


def _state():
    """(fused factor launches, Newton-step chunks run), or None."""
    from ldpc_tpu_torch.ops import chol_kernel, ipm_solver
    if not hasattr(chol_kernel, "FACTOR_LAUNCHES") or \
            not hasattr(ipm_solver, "COUNTS"):
        return None
    return chol_kernel.FACTOR_LAUNCHES, ipm_solver.COUNTS["chunks"]


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
    ctx.notes[KEY] = {"factor_launches": launches, "newton_steps": steps}
    return launches / steps
