"""A run at a small size on the CPU comes out correct when sound, and not
correct under the control and under each fault that these cells can have:

* a step that returns its state unchanged (BP's check-node update, ALP's
  PDHG chunk);
* half of the batch left out (the decode's second half copied from the
  first);
* an answer altered where it is produced (lane 0's certificate negated
  and a bit of its word flipped, in every batch).

The exchange between chips is not faulted: every cell runs on one chip.
The harness's look for a chip is skipped (``device="cpu"``); the decoder's
PDHG runs the program's fused loop, on its plain twin.
"""
import json

import pytest
import torch

from ldpc_bench import calibrate, run
from ldpc_bench.cell import Cell
from ldpc_bench.check import verdict

# small batches, so that the program's plain twin and the reference decode
# in seconds on the CPU; test_altered_answer_on_the_card runs the cells'
# own batch
SIZES = {"bp100-optimalH-m3db": {"batch": 64},
         "alp-optimalH-m3db": {"batch": 3},
         "alp-optimalH-0db": {"batch": 16}}
CELLS = sorted(SIZES)
# the control's channel gap is a largest gap over the bits checked, and its
# decode differs in few lanes at 0 dB: 256 lanes there, as in a quarter of
# the cell's sample
CONTROL_SIZES = {
    "bp100-optimalH-m3db": {"batch": 64, "block_batches": 2,
                            "check_blocks": 1},
    "alp-optimalH-m3db": {"batch": 12, "block_batches": 2, "check_blocks": 1},
    "alp-optimalH-0db": {"batch": 32, "block_batches": 4, "check_blocks": 2}}


def _sizes(cell):
    return {"block_batches": 2, "check_blocks": 1, "trace_blocks": 1,
            **SIZES[cell]}


def _kernel_path(dec):
    if hasattr(dec, "lp_backend"):
        dec.lp_backend = "kernel"


def _run(cell, capsys, seed=2**31 + 11, fault=None):
    def prepare(dec):
        _kernel_path(dec)
        if fault is not None:
            fault(dec)
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                   "0.01", "--trace", "0"], device="cpu",
                  sizes=_sizes(cell), prepare=prepare)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _wrap_decode(dec, change):
    inner = dec.decode_batch

    def decode_batch(llrs):
        return change(llrs, inner)
    dec.decode_batch = decode_batch


def _half(llrs, inner):
    """The batch's first half decoded; its answers stand for the rest."""
    b = llrs.shape[0]
    res = inner(llrs[:(b + 1) // 2])
    return type(res)(*(None if v is None else torch.cat([v, v])[:b]
                       for v in res))


def _alter(llrs, inner):
    """Lane 0's answer altered: its certificate negated, a bit flipped."""
    res = inner(llrs)
    bits, success = res.bits.clone(), res.success.clone()
    bits[0, 0] ^= 1
    success[0] = ~success[0]
    return res._replace(bits=bits, success=success)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell, capsys):
    out = _run(cell, capsys)
    assert out["correct"] is True, out["check"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "check"


@pytest.mark.parametrize("cell", CELLS)
def test_state_left_unchanged_is_not_correct(cell, capsys, monkeypatch):
    if cell.startswith("bp"):
        from ldpc_tpu_torch.ops import bp_ref
        monkeypatch.setattr(bp_ref, "check_update_rowlayout",
                            lambda v2c, *a, **k: torch.zeros_like(v2c))
    else:
        from ldpc_tpu_torch.ops import lp_solver

        def still(c, a, b, tau, sigma, x, y, iters, active=None,
                  average=False):
            return (x.clone(), y.clone(), torch.zeros_like(x[:, 0]),
                    torch.zeros_like(x[:, 0], dtype=torch.bool))
        monkeypatch.setattr(lp_solver, "pdhg_chunk", still)
    assert _run(cell, capsys)["correct"] is False


@pytest.mark.parametrize("cell", CELLS)
def test_half_batch_left_out_is_not_correct(cell, capsys):
    out = _run(cell, capsys, fault=lambda d: _wrap_decode(d, _half))
    assert out["correct"] is False


@pytest.mark.parametrize("cell", CELLS)
def test_altered_answer_is_not_correct(cell, capsys):
    out = _run(cell, capsys, fault=lambda d: _wrap_decode(d, _alter))
    assert out["correct"] is False


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    """The reference one precision step lower, in the program's place, on
    three seeds: not correct on any of them."""
    limits = Cell(cell).spec["limits"]
    readings = calibrate.control_readings(
        cell, [2**31 + 21, 2**31 + 22, 2**31 + 23], device="cpu",
        sizes=CONTROL_SIZES[cell])
    assert all(not verdict(r, limits)[0] for r in readings), readings


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["alp-optimalH-m3db", "alp-optimalH-0db"])
def test_altered_answer_on_the_card(cell, capsys):
    """On a card, at the cell's own batch and block: one lane's answer
    altered in every batch is not correct (certificates_differ)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rc = run.main(["--workload", cell, "--seed", "2147483659", "--seconds",
                   "1", "--trace", "0"],
                  prepare=lambda d: _wrap_decode(d, _alter))
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and out["correct"] is False, out["check"]
    assert out["check"]["certificates_differ"]["value"] > 0


@pytest.mark.gpu
def test_a_cell_on_the_card(capsys):
    """On a card: one short run of the BP cell at its own size is correct
    (``python -m pytest ldpc_bench/tests -m gpu``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rc = run.main(["--workload", "bp100-optimalH-m3db", "--seed", "17",
                   "--seconds", "1", "--trace", "0"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and out["correct"] is True, out["check"]
