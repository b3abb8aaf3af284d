"""Two-proportion z of each FER of one run against another's: the port's
parity with a run of the JAX package where no golden curve exists.

Reads two *extended* benchmark reports (``apps.benchmark
--extended-report``: FER, mean iterations and trials per row) and pairs
their rows by method and SNR, or two before/after records of the matrix
optimizer (``scripts/torch_opt_before_after.py``'s JSON, or the JAX
script's) and pairs their FERs by key. Prints one markdown row per pair
(both FERs, both trial counts, z, PASS for |z| < ``Z_BOUND``, and for
reports both mean iterations), then a JSON line. Exits non-zero when a
pair lies outside ``Z_BOUND`` or a row has no partner.

Run: python scripts/torch_report_z.py reports/report_torch_H02_ext.csv \\
        reports/report_tpu_H02_ext.csv
     python scripts/torch_report_z.py \\
        reports/optimize_before_after_torch.json \\
        reports/optimize_before_after.json
"""
import csv
import json
import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ldpc_tpu_torch.harness.reference_data import Z_BOUND, z_score  # noqa


def _rows(path):
    with open(path) as f:
        return {(r["Method"], float(r["SNR"])): r for r in csv.DictReader(f)}


def _records(path):
    """A before/after record as rows: one per FER key, with its trials."""
    with open(path) as f:
        rec = json.load(f)
    return {(k, rec["snr"]): {"FER": v, "Trials": rec["trials"],
                              "AvgIterations": math.nan}
            for k, v in rec.items() if k.startswith(("fer_", "report_fer_"))}


def compare(ours_path, theirs_path) -> list:
    """One dict per (method, SNR) that both reports hold (per FER key of
    two JSON records), in ours' order; raises ``KeyError`` for a row of
    ours that theirs lacks."""
    read = _records if ours_path.endswith(".json") else _rows
    ours, theirs = read(ours_path), read(theirs_path)
    out = []
    for key, a in ours.items():
        b = theirs[key]
        fa, fb = float(a["FER"]), float(b["FER"])
        na, nb = int(a["Trials"]), int(b["Trials"])
        z = z_score(fa, na, fb, nb)
        out.append(dict(method=key[0], snr=key[1], fer=fa, trials=na,
                        fer_other=fb, trials_other=nb, z=z,
                        within=abs(z) < Z_BOUND,
                        iterations=float(a["AvgIterations"]),
                        iterations_other=float(b["AvgIterations"])))
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    rows = compare(argv[0], argv[1])
    print(f"| method | SNR | FER ({argv[0]}) | FER ({argv[1]}) | trials | z "
          f"| mean iterations |")
    print("|---|---|---|---|---|---|---|")
    for r in rows:
        print(f"| {r['method']} | {r['snr']:+.1f} | {r['fer']:.4f} | "
              f"{r['fer_other']:.4f} | {r['trials']} / {r['trials_other']} "
              f"| {r['z']:+.2f} {'PASS' if r['within'] else 'OUT'} | "
              f"{r['iterations']:.1f} / {r['iterations_other']:.1f} |")
    print(json.dumps(rows))
    return 0 if all(r["within"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
