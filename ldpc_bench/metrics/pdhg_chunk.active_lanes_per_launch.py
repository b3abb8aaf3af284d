"""Layer: the PDHG kernel (``ops/pdhg_kernel.py`` -> ``csrc/pdhg_chunk.cu``).
Working lanes per launch over the traced slice: the fused solver's
``pdhg_chunk`` calls (``COUNTS["chunks"]`` of ``ops/lp_solver.py``) and
the working lanes it counts at each (``COUNTS["lanes"]``, the round's as
ALP's cut loop gives them). On a card, each call is one launch of the
kernel (``pdhg_kernel.LAUNCHES``, in the notes beside the card's SMs); on
the CPU, one call of its plain twin. One block or cluster serves a lane."""
import torch

from ldpc_bench.metrics import _program


def install(ctx):
    _program.install_counts(ctx)


def read(ctx, s):
    d = _program.deltas(ctx)
    if d is None or not d["lp"].get("chunks"):
        return None
    calls = d["lp"]["chunks"]
    note = {"calls": calls, "kernel_launches": d["pdhg_kernel"]["launches"]}
    if ctx.device.type == "cuda":
        note["sms"] = torch.cuda.get_device_properties(
            ctx.device).multi_processor_count
    ctx.notes["pdhg_chunk.active_lanes_per_launch"] = note
    return d["lp"].get("lanes", 0) / calls
