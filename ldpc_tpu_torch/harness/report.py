"""CSV report writer, format-compatible with the reference ``report.csv``
(counterpart of ``ldpc_tpu/harness/report.py``, the same bytes out).

Header and column order exactly match ``main.cpp:47-49,79-86``:
``Method,SNR,Sigma,FER,Time,AvgHamming,AvgHammingCorrect,AvgHammingWrong``
with 12-decimal fixed formatting. An *extended* report adds the metrics the
reference tracks but never writes (pseudocodeword rate, ``experiment.h:116``)
plus throughput, mean iterations, trials and dropped cuts.
"""
from __future__ import annotations

import math
import os

from .experiment import ExperimentResult

REFERENCE_HEADER = ("Method,SNR,Sigma,FER,Time,"
                    "AvgHamming,AvgHammingCorrect,AvgHammingWrong")
EXTENDED_HEADER = (REFERENCE_HEADER +
                   ",Pseudo,Throughput,AvgIterations,Trials,Dropped")

__all__ = ["ReportWriter", "REFERENCE_HEADER", "EXTENDED_HEADER"]


def _sigma(snr: float) -> float:
    return math.sqrt(10 ** (-snr / 10) / 2)


class ReportWriter:
    """Streams one row per (decoder, SNR) as results complete, so a crashed
    sweep retains finished rows (main.cpp:79-86 semantics)."""

    def __init__(self, path: str, extended: bool = False,
                 resume: bool = False):
        """``resume=False`` (default) truncates any prior file — re-running
        a sweep replaces its artifact rather than appending a duplicate
        block. ``resume=True`` appends (crash recovery / --snrs fill-in);
        on close, the file is de-duplicated by (Method, SNR) keeping the
        newest row, so re-running an already-present point replaces it."""
        self.path = path
        self.extended = extended
        self.resume = resume
        header = EXTENDED_HEADER if extended else REFERENCE_HEADER
        write_header = (not resume or not os.path.exists(path)
                        or os.path.getsize(path) == 0)
        self._f = open(path, "a" if resume else "w")
        if write_header:
            self._f.write(header + "\n")
            self._f.flush()

    def write_row(self, method: str, snr: float, res: ExperimentResult) -> None:
        cols = [method,
                f"{snr:.12f}",
                f"{_sigma(snr):.12f}",
                f"{res.fer:.12f}",
                f"{res.avg_time:.12f}",
                f"{res.mean_hamming:.12f}",
                f"{res.mean_hamming_ok:.12f}",
                f"{res.mean_hamming_wrong:.12f}"]
        if self.extended:
            cols += [f"{res.pseudo / max(1, res.total):.12f}",
                     f"{res.throughput:.3f}",
                     f"{res.sum_iterations / max(1, res.total):.3f}",
                     str(res.total),
                     str(res.sum_dropped)]
        self._f.write(",".join(cols) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()
        if self.resume:
            self._dedup()

    def _dedup(self) -> None:
        """Keep the newest row per (Method, SNR); preserve header + order of
        first appearance. Also drops stray duplicate header lines from
        historical appends."""
        with open(self.path) as f:
            lines = [ln.rstrip("\n") for ln in f if ln.strip()]
        if not lines:
            return
        header, body = lines[0], [ln for ln in lines[1:]
                                  if not ln.startswith("Method,")]
        newest: dict[tuple[str, str], str] = {}
        order: list[tuple[str, str]] = []
        for ln in body:
            parts = ln.split(",")
            if len(parts) < 2:
                continue
            k = (parts[0], parts[1])
            if k not in newest:
                order.append(k)
            newest[k] = ln
        with open(self.path, "w") as f:
            f.write(header + "\n")
            for k in order:
                f.write(newest[k] + "\n")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
