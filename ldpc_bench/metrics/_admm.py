"""What the readers of QP-ADMM's stream share (``admm_iterate_roofline``,
``admm.lane_iter_share``).

While tracing, a wrapper of the decoder's ``stream_chunk`` (one launch of
``admm_iterate`` on the card) keeps each chunk's lanes, the lanes not done
at its start and the lane-iterations it ran: the growth of the state's
per-lane counts ``it``, summed on the device, the sum before taken before
the in-place launch. Nothing is read back until the slice has ended. The
program's counters (``COUNTS`` of ``decoders/admm.py``) are snapshotted when
the readers are installed and differenced after the slice; a program
without them gives nothing to read, and no error.
"""
import numpy as np
import torch

from ldpc_bench.cell import BENCH, ROOT, load_module

KEY = "admm.chunks"


def program_counts():
    """A copy of the QP-ADMM decoder's counters, or None where the program
    has none."""
    from ldpc_tpu_torch.decoders import admm
    counts = getattr(admm, "COUNTS", None)
    return None if counts is None else dict(counts)


def install(ctx) -> None:
    """Once a run: the counters' snapshot and the wrapper."""
    if KEY in ctx.records:
        return
    ctx.records[KEY] = []
    ctx.records[KEY + ".counts"] = [program_counts()]
    dec = ctx.decoder
    if ctx.records[KEY + ".counts"][0] is None or dec is None or \
            not hasattr(dec, "stream_chunk"):
        return
    inner = dec.stream_chunk

    def counted(st):
        if not ctx.tracing:
            return inner(st)
        it = st["it"]
        before = it.sum(dtype=torch.int64)
        active = (~st["done"]).sum(dtype=torch.int64)
        out = inner(st)
        ctx.records[KEY].append(
            (it.shape[0], active, out["it"].sum(dtype=torch.int64) - before))
        return out

    dec.stream_chunk = counted


def chunks(ctx):
    """(records, the counters' growth) over the slice, each record (lanes,
    lanes not done at the start, lane-iterations) as host integers; None
    where the program has no counters or the slice ran no chunk."""
    recs = ctx.records.get(KEY)
    start = ctx.records.get(KEY + ".counts")
    now = program_counts()
    if not recs or not start or start[0] is None or now is None:
        return None
    sums = torch.stack([torch.stack([a, w]) for _, a, w in recs]).tolist()
    out = [(lanes, active, work)
           for (lanes, _, _), (active, work) in zip(recs, sums)]
    grown = {k: v - start[0].get(k, 0) for k, v in now.items()}
    return out, grown


def rows(ctx) -> tuple:
    """(n_var, n_con, entries) of the cascade of the configuration's code,
    as the plain reference builds it."""
    ref = load_module(BENCH / "reference" / "qp-admm.py",
                      "ldpc_bench.reference.qp_admm")
    from ldpc_bench.reference.gf2 import read_matrix
    n_var, cons, _ = ref.cascade(
        np.asarray(read_matrix(str(ROOT / ctx.config["code"]))))
    return n_var, len(cons), sum(len(c[0]) for c in cons)
