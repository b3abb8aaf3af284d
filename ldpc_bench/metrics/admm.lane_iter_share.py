"""Layer: the decoder (``decoders/admm.py``'s stream as the harness's
streamed runner drives it). The lane-iterations the stream's chunks ran
(``metrics/_admm.py``) over the lane slots its chunks offered: the growth
of the program's ``COUNTS["chunks"]`` times the lanes a chunk holds times
``stream_chunk_iters``. The share of the slots that did work: the drain at
a block's end lowers it, and so do lanes that stop early in a chunk and
wait for the next refill. The harness's refill and poll reads per trial
finished, the lanes started and the chunks that ran no lane-iteration (a
stream polled after its last lane finished) go to the run's notes; a
program without QP-ADMM's counters gives nothing to read."""
from ldpc_bench.metrics import _admm, _program

KEY = "admm.lane_iter_share"


def install(ctx):
    _program.install_counts(ctx)
    _admm.install(ctx)


def read(ctx, s):
    got = _admm.chunks(ctx)
    per = getattr(ctx.decoder, "stream_chunk_iters", None)
    if got is None or not per:
        return None
    recs, grown = got
    lanes = max(r[0] for r in recs)
    slots = grown.get("chunks", 0) * lanes * per
    if slots <= 0:
        return None
    work = sum(w for _, _, w in recs)
    d = _program.deltas(ctx)
    trials = s.get("trials", 0)
    harness = d["harness"] if d else {}
    ctx.notes[KEY] = {
        "lane_iterations": work, "chunks": grown.get("chunks", 0),
        "launches_seen": len(recs), "lanes": lanes,
        "empty_chunks": sum(1 for _, _, w in recs if w == 0),
        "chunk_iters": per, "lanes_started": grown.get("lanes_started", 0),
        "per_trial": {name: harness.get(name, 0) / trials
                      for name in ("reads.refill", "reads.poll")}
        if trials > 0 else None}
    return work / slots
