"""The readings that a cell's limits are set from, in one process.

    python3 -m ldpc_bench.calibrate --workload <name> --seconds <s> \\
        --seeds <n> ... --control-seeds <n> ...

For each of ``--seeds``: one run of the cell (``run.main``, a window of
``--seconds``), whose numbers compared are the lower readings. For each of
``--control-seeds``: the control, the reference one precision step below the
configuration's (float32 Box-Muller for the channel; bfloat16 BP, or TF32
products in the PDHG solves) put in the program's place on as many blocks as
a run checks, at the cell's sizes, judged as a run is. Prints one JSON line
per reading, then the largest program reading and the smallest control
reading of each number.
"""
from __future__ import annotations

import argparse
import json
import sys

from . import run


def control_readings(workload: str, seeds: list, device=None,
                     sizes=None) -> list:
    """The numbers compared for the control, one dict per seed."""
    import torch

    from .cell import Cell
    from .check import control_blocks, judge
    from .reference.gf2 import read_matrix
    cell = Cell(workload)
    dev = torch.device(device or "cuda:0")
    sz = {"batch": cell.config["batch"],
          "block_batches": cell.traffic["block_batches"],
          "check_blocks": cell.spec["check_blocks"], **(sizes or {})}
    h = read_matrix(str(cell.code_path))
    snr = float(cell.traffic["snr_db"])
    ref = cell.reference()
    tables = ref.prepare(h, cell.reference_config(), dev)
    out = []
    for seed in seeds:
        noise = [run.block_seed(seed, k) for k in range(sz["check_blocks"])]
        blocks = control_blocks(ref, tables, h, seed, snr, noise,
                                sz["block_batches"], sz["batch"], dev)
        out.append(judge(ref, tables, h, seed, snr, blocks, sz["batch"],
                         dev))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = p.parse_args(argv)
    upper = {}
    for seed in args.seeds:
        print(f"calibrate: program seed {seed}", file=sys.stderr, flush=True)
        rc = run.main(["--workload", args.workload, "--seed", str(seed),
                       "--seconds", str(args.seconds), "--trace", "0"])
        if rc != 0:
            return rc
    for seed, numbers in zip(args.control_seeds, control_readings(
            args.workload, args.control_seeds)):
        print(json.dumps({"control_seed": seed, "numbers": numbers}),
              flush=True)
        for k, v in numbers.items():
            upper[k] = min(upper.get(k, float("inf")), v)
    print(json.dumps({"workload": args.workload, "control_min": upper}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
