"""A sampled block recorded and judged trial by trial (``record.py``), from
the streamed runner as from the batched one:

* ALP streamed (``prefer_streaming`` set on the decoder, so that
  ``run_experiment`` hands each block to ``run_streaming_experiment``) is
  recorded whole at a small size on the CPU, with ``llr_gap`` and
  ``classify_gap`` 0, and its traced slice counts every trial finished. A
  stream regroups ALP's lanes, which its batch-wide stops couple, so the
  rounds of some lanes differ from the reference's batches in trial order
  (``lanes_differ``); with one lane a batch nothing is coupled, and the run
  is correct;
* a trial's outputs filed under another trial's index, a finished trial
  never written, and a trial written twice each come out not correct, in a
  streamed run and in a batched one;
* recording adds no host read to a streamed block: the program's counters
  of reads (``COUNTS``) grow alike with and without it.

The harness's look for a chip is skipped (``device="cpu"``) but for the
case marked ``gpu``, which runs the streamed cell at its own batch.
"""
import contextlib
import json

import pytest
import torch

from ldpc_bench import record, run
from ldpc_bench.cell import Cell
from ldpc_bench.trace import Context

ALP = ["alp-optimalH-m3db", "alp-optimalH-0db"]
SIZES = {"alp-optimalH-m3db": {"batch": 4, "block_batches": 3},
         "alp-optimalH-0db": {"batch": 8, "block_batches": 3},
         "bp100-optimalH-m3db": {"batch": 64, "block_batches": 2}}
SEED = 2**31 + 43


def _stream(dec):
    if hasattr(dec, "lp_backend"):
        dec.lp_backend = "kernel"
        dec.prefer_streaming = True


def _run(cell, capsys, trace=0, device="cpu", sizes=None, seconds="0.01"):
    sz = {"check_blocks": 1, "trace_blocks": 1, **SIZES[cell],
          **(sizes or {})}
    rc = run.main(["--workload", cell, "--seed", str(SEED), "--seconds",
                   seconds, "--trace", str(trace)], device=device,
                  sizes=sz if device == "cpu" else sizes, prepare=_stream)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _counts():
    from ldpc_tpu_torch.decoders import alp
    from ldpc_tpu_torch.harness import experiment
    from ldpc_tpu_torch.ops import lp_solver
    return {f"{key}.{k}": v for key, mod in
            (("alp", alp), ("lp", lp_solver), ("harness", experiment))
            for k, v in mod.COUNTS.items()}


def _streamed(cell, capsys, **kw):
    before = _counts()
    out = _run(cell, capsys, **kw)
    after = _counts()
    assert after.get("harness.reads.refill", 0) > \
        before.get("harness.reads.refill", 0)       # the runner streamed
    assert out["failed"] == 0
    return out


@pytest.mark.parametrize("cell", ALP)
def test_streamed_run_is_recorded_exactly(cell, capsys):
    check = _streamed(cell, capsys)["check"]
    # None where a sampled block was not recorded whole
    assert check["llr_gap"]["value"] == 0, check
    assert check["classify_gap"]["value"] == 0, check


@pytest.mark.parametrize("cell", ALP)
def test_streamed_uncoupled_lanes_are_correct(cell, capsys):
    out = _streamed(cell, capsys, sizes={"batch": 1, "block_batches": 6})
    assert out["correct"] is True, out["check"]


def test_a_traced_streamed_slice_counts_its_trials(capsys):
    out = _streamed("alp-optimalH-m3db", capsys, trace=1)
    assert out["check"]["classify_gap"]["value"] == 0, out["check"]
    trace = out["about"]["trace"]
    assert trace["trials"] == out["attempted"] > 0
    assert trace["batches"] == 0            # no batch goes to decode_batch


def _first(fin, rows):
    """Positions of the finished rows (all rows where ``fin`` is None)."""
    if fin is None:
        return torch.arange(rows, device="cpu")
    return fin.nonzero().squeeze(1).cpu()


def _misfiled(real):
    def write(self, fin, res):
        ids, llrs = self.last
        done = _first(fin, ids.shape[0])
        if done.numel() >= 2:
            ids = ids.clone()
            ids[done[0]] = ids[done[1]]
            self.last = (ids, llrs)
        real(self, fin, res)
    return write


def _lost(real):
    def write(self, fin, res):
        rows = self.last[0].shape[0]
        keep = torch.ones(rows, dtype=torch.bool) if fin is None else fin
        done = _first(fin, rows)
        if done.numel():
            keep = keep.clone()
            keep[done[0]] = False
        real(self, keep.to(self.last[0].device), res)
    return write


def _twice(real):
    def write(self, fin, res):
        real(self, fin, res)
        done = _first(fin, self.last[0].shape[0])
        if done.numel():
            one = torch.zeros(self.last[0].shape[0], dtype=torch.bool,
                              device=self.last[0].device)
            one[done[0]] = True
            real(self, one, res)
    return write


FAULTS = {"misfiled": _misfiled, "lost": _lost, "twice": _twice}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", ["alp-optimalH-m3db",
                                  "bp100-optimalH-m3db"])
def test_a_trial_recorded_wrongly_is_not_correct(cell, fault, capsys,
                                                 monkeypatch):
    monkeypatch.setattr(record.Recorder, "_write",
                        FAULTS[fault](record.Recorder._write))
    out = _run(cell, capsys)
    assert out["correct"] is False


def _block(cell, device, trials):
    """The cell's decoder, code and a codeword table of ``trials`` rows."""
    from ldpc_tpu_torch.channel.awgn import gen_random_codewords
    from ldpc_tpu_torch.codes.gf2 import gf2_nullspace
    from ldpc_tpu_torch.codes.io import read_pcm
    from ldpc_tpu_torch.config import DecoderConfig
    from ldpc_tpu_torch.decoders import make_decoder
    c = Cell(cell)
    h = read_pcm(str(c.code_path))
    g, _ = gf2_nullspace(h)
    gen = torch.Generator(device=device).manual_seed(SEED)
    cw = gen_random_codewords(g, trials, gen, device)
    dec = make_decoder(c.config["decoder"], h,
                       DecoderConfig(**c.config["decoder_config"]),
                       device=device)
    _stream(dec)
    return c, h, cw, dec


def _reads_with_and_without(cell, device, batch, batches):
    """The growth of the program's read counters (and, on a card, of the
    device-to-host copies) over one streamed block, without a recorder and
    with one recording it. The runner polls every 128 chunks from the
    start, so that the chunks it runs do not depend on the host's clock."""
    from ldpc_tpu_torch.harness.experiment import run_streaming_experiment
    c, h, cw, dec = _block(cell, device, batch * batches)
    snr = float(c.traffic["snr_db"])
    out = []
    rec = None
    for recording in (False, True):
        if recording:
            rec = record.Recorder(dec, batch * batches, 1,
                                  Context(dec, c.config, device, None))
        before = _counts()
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof, \
                (rec.block(0) if recording else contextlib.nullcontext()):
            run_streaming_experiment(dec, h, cw, snr, 7, batch_size=batch,
                                     fetch_every=128, device=device,
                                     warmup=False)
        after = _counts()
        if recording:
            assert rec.whole([0])
        grown = {k: v - before.get(k, 0) for k, v in after.items()
                 if k.split(".")[1] == "reads" and v != before.get(k, 0)}
        grown["DtoH"] = sum(1 for e in prof.events()
                            if "DtoH" in e.name and
                            e.device_type == torch.autograd.DeviceType.CUDA)
        out.append(grown)
    return out


def test_recording_adds_no_host_read():
    bare, recorded = _reads_with_and_without("alp-optimalH-m3db", "cpu", 4, 3)
    assert bare == recorded and bare["harness.reads.refill"] > 0


@pytest.mark.gpu
def test_streamed_alp_on_the_card(capsys):
    """On a card, ALP streamed at the cell's own batch (256) and block
    (2,048): the LLRs and the classification exact, every trial of the
    sampled blocks recorded once, and the same reads with the recorder as
    without. Prints ``lanes_differ`` and ``counters_gap``: how far the
    stream's regrouping of coupled lanes moves the check."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = _run("alp-optimalH-m3db", capsys, device=None, seconds="2")
    check = {k: v["value"] for k, v in out["check"].items()}
    print("streamed alp-optimalH-m3db", json.dumps(check))
    assert check["llr_gap"] == 0 and check["classify_gap"] == 0, check
    assert out["failed"] == 0
    bare, recorded = _reads_with_and_without("alp-optimalH-m3db", "cuda:0",
                                            256, 8)
    print("reads without, with the recorder", bare, recorded)
    assert bare == recorded and bare["DtoH"] > 0
