"""Analysis plots, the ``notebooks/plots.ipynb`` equivalent (counterpart of
``ldpc_tpu/apps/plots.py``).

Produces the reference notebook's artifacts from ``report.csv`` files
(cells 1-9): per-matrix FER-vs-SNR semilog curves, before/after-optimization
comparison, decode-time curves, and channel-Hamming-distance curves; saves
``.eps``/``.png`` figures. matplotlib is imported inside the plotting
functions only, so nothing else of the package needs it.

Run:  python -m ldpc_tpu_torch.apps.plots report.csv --out plots/
      python -m ldpc_tpu_torch.apps.plots report_opt.csv --compare report_H05.csv
"""
from __future__ import annotations

import argparse
import csv
import os
from collections import defaultdict


def read_report(path: str) -> dict[str, list[dict]]:
    """Rows grouped by Method, each row with float fields."""
    per_method: dict[str, list[dict]] = defaultdict(list)
    with open(path) as f:
        for row in csv.DictReader(f):
            per_method[row["Method"]].append(
                {k: (v if k == "Method" else float(v))
                 for k, v in row.items()})
    for rows in per_method.values():
        rows.sort(key=lambda r: r["SNR"])
    return dict(per_method)


def plot_column(data, column: str, ylabel: str, title: str, out_path: str,
                logy: bool = True) -> None:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 5))
    for method, rows in data.items():
        xs = [r["SNR"] for r in rows]
        ys = [r[column] for r in rows]
        ax.plot(xs, ys, marker="o", label=method)
    if logy:
        ax.set_yscale("log")
    ax.set_xlabel("SNR (dB)")
    ax.set_ylabel(ylabel)
    ax.set_title(title)
    ax.grid(True, which="both", alpha=0.3)
    ax.legend()
    fig.tight_layout()
    fig.savefig(out_path)
    plt.close(fig)


def plot_compare(data_a, data_b, label_a: str, label_b: str, column: str,
                 out_path: str) -> None:
    """Before/after comparison per method (notebook cells 5-7)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 5))
    for method in sorted(set(data_a) | set(data_b)):
        for data, lbl, ls in ((data_a, label_a, "-"), (data_b, label_b, "--")):
            if method not in data:
                continue
            rows = data[method]
            ax.plot([r["SNR"] for r in rows], [r[column] for r in rows],
                    ls, marker="o", label=f"{method} ({lbl})")
    ax.set_yscale("log")
    ax.set_xlabel("SNR (dB)")
    ax.set_ylabel(column)
    ax.grid(True, which="both", alpha=0.3)
    ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(out_path)
    plt.close(fig)


def plot_grid_heatmap(csv_path: str, out_path: str):
    """(alpha, mu) FER heatmap from a qpadmm_grid --grid-out CSV."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np
    alphas, mus, fers = [], [], []
    with open(csv_path) as f:
        next(f)
        for line in f:
            a, m, v = line.strip().split(",")
            alphas.append(float(a)); mus.append(float(m))
            fers.append(float(v))
    a_ax = sorted(set(alphas))
    m_ax = sorted(set(mus))
    z = np.ones((len(a_ax), len(m_ax)))
    ai = {a: i for i, a in enumerate(a_ax)}
    mi = {m: i for i, m in enumerate(m_ax)}
    for a, m, v in zip(alphas, mus, fers):
        z[ai[a], mi[m]] = v
    best = int(np.argmin(z))
    bi, bj = divmod(best, len(m_ax))
    fig, ax = plt.subplots(figsize=(7, 6))
    im = ax.imshow(z, origin="lower", aspect="auto",
                   extent=(m_ax[0], m_ax[-1], a_ax[0], a_ax[-1]),
                   cmap="viridis")
    ax.plot(m_ax[bj], a_ax[bi], "r*", markersize=14,
            label=f"best ({a_ax[bi]:.2f}, {m_ax[bj]:.2f}) "
                  f"FER={z[bi, bj]:.3f}")
    ax.set_xlabel("mu"); ax.set_ylabel("alpha")
    ax.set_title("QP-ADMM (alpha, mu) grid FER")
    ax.legend(loc="upper right")
    fig.colorbar(im, ax=ax, label="FER")
    fig.tight_layout()
    fig.savefig(out_path)
    plt.close(fig)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("report")
    p.add_argument("--compare", default=None,
                   help="second report for before/after plots")
    p.add_argument("--grid", default=None,
                   help="qpadmm_grid CSV for an (alpha, mu) FER heatmap")
    p.add_argument("--out", default="plots")
    p.add_argument("--fmt", default="png", choices=("png", "eps"))
    args = p.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    if args.grid:
        plot_grid_heatmap(args.grid,
                          os.path.join(args.out, f"qpadmm_grid.{args.fmt}"))
    data = read_report(args.report)
    f = args.fmt
    plot_column(data, "FER", "FER", "Frame error rate",
                os.path.join(args.out, f"fer.{f}"))
    plot_column(data, "Time", "seconds / codeword", "Decode time",
                os.path.join(args.out, f"time.{f}"))
    plot_column(data, "AvgHamming", "mean channel Hamming distance",
                "Channel errors", os.path.join(args.out, f"hamming.{f}"),
                logy=False)
    if args.compare:
        data_b = read_report(args.compare)
        plot_compare(data, data_b,
                     os.path.splitext(os.path.basename(args.report))[0],
                     os.path.splitext(os.path.basename(args.compare))[0],
                     "FER", os.path.join(args.out, f"fer_compare.{f}"))
    print(f"plots written to {args.out}/")


if __name__ == "__main__":
    main()
