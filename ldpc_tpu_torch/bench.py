"""Headline benchmark of the port: decoded codewords/s for BP (100
iterations, sum-product, the reference's config, ``main.cpp:29``) on
``data/optimalH.txt`` at SNR = -3 dB, 65,536 trials in batches of 8192, then
the same run at 50 iterations.

Run as ``python -m ldpc_tpu_torch.bench`` on a CUDA device; prints ONE JSON
line: {"metric", "value", "unit", "vs_baseline", "extra"}.

Baseline: the reference's committed report gives BP 13.08 ms/codeword at
SNR = -3 on one CPU thread (``reports/report_opt.csv:6``), 611 cw/s for its
8-thread harness (``main.cpp:23``). ``vs_baseline`` is this card's
throughput over that 8-thread aggregate.
"""
from __future__ import annotations

import json
import subprocess
from pathlib import Path

import torch

from .channel.awgn import gen_random_codewords
from .codes.gf2 import gf2_nullspace
from .codes.io import read_pcm
from .decoders.bp import BPDecoder
from .harness.experiment import run_experiment
from .harness.reference_data import REF_FER_OPT, SNR_GRID
from .ops import bp_kernel

MATRIX = Path(__file__).resolve().parents[1] / "data" / "optimalH.txt"
SEED = 239_239_239        # codeword coefficients; the noise uses SEED + 1
SNR = -3.0
TRIALS = 65_536
BATCH = 8192
BASELINE_CWS = 611.0      # 8-thread reference aggregate at SNR = -3
FER_REF_100IT = REF_FER_OPT["BP"][SNR_GRID.index(SNR)]  # 0.4860


def card_stamp(device: torch.device) -> str:
    """``"name, power.limit"`` of a CUDA device as ``nvidia-smi`` reports
    it (a card may be set below its maximum power, and then runs slower);
    the device type for anything else."""
    if device.type != "cuda":
        return device.type
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    return subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def main(trials: int = TRIALS, batch_size: int = BATCH,
         device: torch.device | str = "cuda") -> dict:
    """Run the benchmark, print its JSON line and return it as a dict."""
    device = torch.device(device)
    h = read_pcm(str(MATRIX))
    g, ok = gf2_nullspace(h)
    if not ok:
        raise RuntimeError(f"{MATRIX} is singular")
    gen = torch.Generator().manual_seed(SEED)
    codewords = gen_random_codewords(g, trials, gen, device)

    launches_before = bp_kernel.LAUNCHES
    res = run_experiment(BPDecoder(h, max_iter=100, device=device), h,
                         codewords, SNR, SEED + 1, batch_size=batch_size,
                         device=device)
    res50 = run_experiment(BPDecoder(h, max_iter=50, device=device), h,
                           codewords, SNR, SEED + 1, batch_size=batch_size,
                           device=device)
    launches = bp_kernel.LAUNCHES - launches_before

    out = {
        "metric": "BP-100it decoded codewords/s/chip (optimalH, SNR=-3dB)",
        "value": round(res.throughput, 1),
        "unit": "codewords/s/chip",
        "vs_baseline": round(res.throughput / BASELINE_CWS, 2),
        "extra": {
            "fer_100it": round(res.fer, 4),
            "fer_ref_100it": FER_REF_100IT,
            "avg_iterations": round(res.sum_iterations / res.total, 2),
            "cws_50it": round(res50.throughput, 1),
            "fer_50it": round(res50.fer, 4),
            "trials": trials,
            "device": card_stamp(device),
            "layout": "cuda" if device.type == "cuda" else "torch-ref",
            "bp_kernel_launches": launches,
        },
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
