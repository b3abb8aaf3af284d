"""What the decoder was given and what it gave back, trial by trial, in the
sampled blocks of the window, from either runner of the program's
``harness/experiment.py``.

The trial ids are the runner's own. Each runner makes LLRs with one call of
its channel step, ``channel(codewords, trials, seed, sigma, scale)``, whose
``trials`` are the block's trial ids of the rows it makes. The recorder
wraps that step where the runners call it (``experiment.channel``), and the
decoder's methods that take those LLRs and give the outputs:

* batched: ``decode_batch`` takes the last channel call's LLRs (the same
  tensor), and every row is a trial finished, under that call's ids;
* streamed: after its start and after each refill the runner makes the
  LLRs of every slot in one channel call, so the last call's ids say which
  trial each slot holds, and ``stream_init`` takes those rows for the slots
  it fills. A trial finishes in the chunk in which its slot's
  ``stream_done`` turns true: the runner starts a trial not done, and marks
  a slot past the last trial done before the next chunk. Its outputs are
  ``stream_finish``'s after that chunk.

Nothing is read back while the blocks run: the rows are written on the
device with ``index_copy_`` into buffers of one row per trial and one spare
row (where slots that did not finish go), allocated before the window, and a
count of writes per trial is kept beside them. After the window,
:meth:`Recorder.whole` reads the counts: every trial written exactly once.
"""
from __future__ import annotations

import contextlib

import torch

FIELDS = ("bits", "success", "iterations", "dropped")


class Recorder:
    """Records the trials of one block at a time into one of ``slots``
    buffer sets (:meth:`block`), for a block of ``trials`` trials;
    otherwise the channel step is the program's own and the decoder's
    wrapped methods pass every call through. ``ctx.batches``
    counts the batches handed to ``decode_batch`` while ``ctx.tracing``."""

    def __init__(self, decoder, trials: int, slots: int, ctx):
        from ldpc_tpu_torch.harness import experiment
        self.trials = trials
        self.buffers = [None] * slots
        self.target = None        # the slot being written, or None
        self.last = None          # (trial ids, LLRs) of the last channel call
        self.open = None          # slots that held an unfinished trial
        self.faults = []
        self._experiment = experiment
        self._channel = channel = experiment.channel

        def channel_step(codewords, trial_idx, *args, **kwargs):
            out = channel(codewords, trial_idx, *args, **kwargs)
            self.last = (trial_idx, out[1])
            return out

        self._channel_step = channel_step

        decode = decoder.decode_batch

        def decode_batch(llrs):
            if ctx.tracing:
                ctx.batches += 1
            res = decode(llrs)
            if self.target is not None:
                if self.last is None or self.last[1] is not llrs:
                    self.faults.append("decode_batch took LLRs that the "
                                       "channel step did not make")
                else:
                    self._write(None, res)
            return res

        decoder.decode_batch = decode_batch
        if not hasattr(decoder, "stream_init"):
            return
        done, chunk, finish = (decoder.stream_done, decoder.stream_chunk,
                               decoder.stream_finish)

        def stream_chunk(st):
            if self.target is not None:
                self.open = ~done(st)
            return chunk(st)

        def stream_finish(st):
            res = finish(st)
            if self.target is not None:
                if self.open is None or self.last is None:
                    self.faults.append("stream_finish before a chunk")
                else:
                    self._write(done(st) & self.open, res)
            return res

        decoder.stream_chunk = stream_chunk
        decoder.stream_finish = stream_finish

    @contextlib.contextmanager
    def block(self, slot):
        """Record the block run inside into ``slot``, replacing what it
        held; with ``slot`` None, record nothing."""
        if slot is None:
            yield
            return
        self.target = slot
        if self.buffers[slot] is not None:
            self.buffers[slot]["count"].zero_()
        self._experiment.channel = self._channel_step
        try:
            yield
        finally:
            self._experiment.channel = self._channel
            self.target = self.last = self.open = None

    def allocate(self) -> None:
        """Every slot's buffers, laid out as the first slot's, which the
        first recorded block (the warm-up) allocated; their counts zero."""
        first = self.buffers[0]
        if first is None:
            raise RuntimeError("no recorded block to take the layout from")
        for slot, buf in enumerate(self.buffers):
            if buf is None:
                self.buffers[slot] = {k: torch.empty_like(v)
                                      for k, v in first.items()}
            self.buffers[slot]["count"].zero_()

    def _write(self, fin, res) -> None:
        """Rows of the last channel call and of ``res`` under their trial
        ids; with ``fin`` (streamed), the rows of slots not finished go to
        the spare row."""
        trial_idx, llrs = self.last
        if trial_idx.shape[0] != llrs.shape[0] or \
                res.bits.shape[0] != llrs.shape[0]:
            self.faults.append(f"{llrs.shape[0]} rows of LLRs, "
                               f"{trial_idx.shape[0]} trial ids, "
                               f"{res.bits.shape[0]} outputs")
            return
        rows = trial_idx if fin is None else \
            torch.where(fin, trial_idx, self.trials)
        values = {"llrs": llrs, **{k: getattr(res, k) for k in FIELDS}}
        buf = self.buffers[self.target]
        if buf is None:
            buf = self.buffers[self.target] = {
                k: v.new_empty((self.trials + 1, *v.shape[1:]))
                for k, v in values.items() if v is not None}
            buf["count"] = torch.zeros(self.trials + 1, dtype=torch.int32,
                                       device=llrs.device)
        for k, v in values.items():
            if (v is None) != (k not in buf):
                self.faults.append(f"{k} is given in some batches only")
            elif v is not None:
                buf[k].index_copy_(0, rows, v)
        buf["count"].index_add_(0, rows, torch.ones_like(
            rows, dtype=torch.int32))

    def whole(self, slots) -> bool:
        """Whether every trial of each of ``slots`` was written exactly
        once, and no call went unrecorded (one host read a slot)."""
        return not self.faults and all(
            self.buffers[s] is not None and
            bool((self.buffers[s]["count"][:self.trials] == 1).all())
            for s in slots)

    def rows(self, slot: int) -> dict:
        """{"llrs", "bits", "success", "iterations", "dropped"}: each a
        tensor with one row per trial of the block in ``slot``, in trial
        order (``dropped`` None where the decoder gives none)."""
        buf = self.buffers[slot]
        return {k: buf[k][:self.trials] if k in buf else None
                for k in ("llrs", *FIELDS)}
