"""FER-parity validation sweep against the reference's golden curves
(counterpart of ``ldpc_tpu/apps/validate.py``).

Runs each decoder over the 11-point SNR grid with a per-point trial budget
sized to the golden FER (``reference_data.suggested_trials``), computes the
two-proportion z-score against the transcribed ``reports/report_opt.csv`` /
``reports/report_H05.csv`` curves, and writes a reference-format CSV and,
on request, a markdown parity table. Bar: |z| < 3.5 (the noise streams
differ by construction, so bitwise parity is impossible). On H05 QP-ADMM
runs at the reference's non-OPTIMAL alpha = 1.95, mu = 0.5.

Codewords come from ``seed`` and the noise from ``seed + 1``, as in the
port's sweep app. The default report goes under ``build/``.

    python -m ldpc_tpu_torch.apps.validate --decoders bp,qp-admm \\
        --matrix optimalH [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

import torch

from ..channel.awgn import gen_random_codewords
from ..codes.gf2 import gf2_nullspace
from ..codes.io import read_pcm
from ..config import DecoderConfig
from ..decoders import default_batch, make_decoder
from ..decoders.base import resolve_device
from ..harness.experiment import run_experiment
from ..harness.reference_data import (SNR_GRID, Z_BOUND, ref_fer,
                                      suggested_trials, z_score)
from ..harness.report import ReportWriter

__all__ = ["CSV_NAMES", "main", "validate"]

DATA = Path(__file__).resolve().parents[2] / "data"

CSV_NAMES = {"bp": "BP", "qp-admm": "QP-ADMM", "alp": "ALP",
             "agc-alp": "AGC-ALP"}


def validate(matrix: str = "optimalH", decoders=("alp", "agc-alp"),
             batch_size: int = 0, seed: int = 239_239_239,
             max_trials: int = 10_000, min_trials: int = 0, report: str = "",
             table_out: str = "", decoder_cfg=None, snrs=None,
             device: torch.device | str = "cuda", log=print):
    """One row per (decoder, SNR): FER, golden FER, z and the verdict
    (PASS, "better" below the golden curve, FAIL above it)."""
    device = resolve_device(device)
    h = read_pcm(str(DATA / f"{matrix}.txt"))
    g, ok = gf2_nullspace(h)
    if not ok:
        raise ValueError(f"{matrix} is singular; cannot derive G")
    report = report or f"build/report_torch_{matrix}_validate.csv"
    unknown = [k for k in decoders if k not in CSV_NAMES]
    if unknown:
        raise SystemExit(f"unknown decoder(s) {unknown}; "
                         f"choose from {sorted(CSV_NAMES)}")
    if matrix == "H05" and decoder_cfg is None:
        # the reference's H05 run is the non-OPTIMAL build: its QP-ADMM
        # runs at alpha=1.95, mu=0.5 (main.cpp:30-34)
        decoder_cfg = DecoderConfig(admm_alpha=1.95, admm_mu=0.5)
    if os.path.dirname(report):
        os.makedirs(os.path.dirname(report), exist_ok=True)
    rows = []
    # a full-grid run replaces the report; an --snrs fill-in appends
    with ReportWriter(report, resume=snrs is not None) as rep:
        for kind in decoders:
            name = CSV_NAMES[kind]
            dec = make_decoder(kind, h, decoder_cfg, device=device)
            bs = batch_size or default_batch(kind)
            for snr in (snrs if snrs is not None else SNR_GRID):
                p_ref = ref_fer(matrix, name, snr)
                trials = min(max(suggested_trials(p_ref), min_trials),
                             max_trials)
                cw = gen_random_codewords(
                    g, trials, torch.Generator().manual_seed(seed), device)
                # keep streaming engaged at small budgets: "auto" streams
                # only from two batches of trials, and stragglers cost most
                # at the high-FER (small-budget) points
                bs_eff = (min(bs, max(1, trials // 2))
                          if hasattr(dec, "stream_init") else bs)
                t0 = time.time()
                res = run_experiment(dec, h, cw, snr, seed + 1,
                                     batch_size=bs_eff, device=device)
                z = z_score(res.fer, trials, p_ref)
                verdict = ("PASS" if abs(z) < Z_BOUND
                           else ("better" if z < 0 else "FAIL"))
                log(f"{name} snr={snr:+.1f}: fer={res.fer:.4f} "
                    f"ref={p_ref:.4f} z={z:+.2f} {verdict} "
                    f"(n={trials}, {res.throughput:.1f} cw/s, "
                    f"{time.time() - t0:.0f}s)", flush=True)
                rep.write_row(name, snr, res)
                rows.append(dict(method=name, snr=snr, fer=res.fer,
                                 ref=p_ref, z=z, n=trials, verdict=verdict,
                                 throughput=res.throughput))

    if table_out:
        with open(table_out, "w") as f:
            f.write(f"## Parity table — {matrix} "
                    f"(generated by ldpc_tpu_torch.apps.validate)\n\n")
            f.write("| Method | SNR | ours | reference | n | z | verdict |\n")
            f.write("|---|---:|---:|---:|---:|---:|---|\n")
            for r in rows:
                f.write(f"| {r['method']} | {r['snr']:+.1f} | "
                        f"{r['fer']:.4f} | {r['ref']:.4f} | {r['n']} | "
                        f"{r['z']:+.2f} | {r['verdict']} |\n")
    n_fail = sum(r["verdict"] == "FAIL" for r in rows)
    log(f"validate({matrix}): {len(rows)} points, {n_fail} FAIL")
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--matrix", default="optimalH",
                   choices=["optimalH", "H05"])
    p.add_argument("--decoders", default="alp,agc-alp")
    p.add_argument("--batch-size", type=int, default=0,
                   help="0 = per-decoder default (decoders.DEFAULT_BATCH)")
    p.add_argument("--max-trials", type=int, default=10_000)
    p.add_argument("--min-trials", type=int, default=0,
                   help="floor on the per-point trial budget (10000 for "
                        "full-power parity runs of fast decoders)")
    p.add_argument("--report", default="")
    p.add_argument("--table-out", default="")
    p.add_argument("--json-out", default="")
    p.add_argument("--snrs", default="",
                   help="comma-separated SNR subset (resume/fill-in); use "
                        "the --snrs=-1.0,-0.5 form for negatives")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda)")
    a = p.parse_args(argv)
    snrs = tuple(float(s) for s in a.snrs.split(",")) if a.snrs else None
    rows = validate(matrix=a.matrix, decoders=a.decoders.split(","),
                    batch_size=a.batch_size, max_trials=a.max_trials,
                    min_trials=a.min_trials, snrs=snrs, report=a.report,
                    table_out=a.table_out, device=a.device,
                    log=lambda *x, **k: print(*x, file=sys.stderr, **k))
    if a.json_out:
        with open(a.json_out, "w") as f:
            json.dump(rows, f, indent=1)
    return rows


if __name__ == "__main__":
    main()
