"""Reference golden FER curves and the statistical-parity helpers (from
``ldpc_tpu/harness/reference_data.py``).

The reference publishes two result sets, ``reports/report_opt.csv`` (matrix
``data/optimalH.txt``) and ``reports/report_H05.csv`` (``data/H05.txt``),
10,000 Monte-Carlo trials per (decoder, SNR) point (``main.cpp:42-92``, seed
239'239'239). Their ``mt19937`` sample path cannot be matched bit for bit, so
parity is |z| < Z_BOUND under the two-proportion z-test.

The H05 run used the non-``OPTIMAL`` build, whose QP-ADMM runs at
alpha = 1.95, mu = 0.5 (``main.cpp:30-34``); BP, ALP and AGC-ALP are
configured alike in both runs.
"""
from __future__ import annotations

import math

REF_TRIALS = 10_000
Z_BOUND = 3.5
SNR_GRID = [-5.0, -4.5, -4.0, -3.5, -3.0, -2.5, -2.0, -1.5, -1.0, -0.5, 0.0]

# reports/report_opt.csv rows 2-45 (matrix data/optimalH.txt)
REF_FER_OPT = {
    "BP":      [0.9982, 0.9825, 0.9187, 0.7495, 0.4860, 0.2324, 0.0851,
                0.0376, 0.0315, 0.0320, 0.0337],
    "QP-ADMM": [0.9821, 0.9216, 0.7721, 0.5286, 0.2751, 0.0990, 0.0245,
                0.0030, 0.0001, 0.0000, 0.0000],
    "ALP":     [0.9999, 0.9998, 0.9992, 0.9933, 0.9659, 0.8785, 0.6749,
                0.3956, 0.1576, 0.0383, 0.0057],
    "AGC-ALP": [0.9999, 0.9990, 0.9932, 0.9649, 0.8704, 0.6588, 0.3699,
                0.1350, 0.0303, 0.0030, 0.0000],
}


# reports/report_H05.csv rows 2-45 (matrix data/H05.txt; QP-ADMM at
# alpha=1.95, mu=0.5)
REF_FER_H05 = {
    "BP":      [0.9986, 0.9845, 0.9264, 0.7683, 0.5185, 0.2623, 0.1038,
                0.0510, 0.0343, 0.0323, 0.0356],
    "QP-ADMM": [0.9871, 0.9438, 0.8240, 0.5980, 0.3380, 0.1361, 0.0379,
                0.0071, 0.0016, 0.0000, 0.0000],
    "ALP":     [1.0000, 1.0000, 0.9986, 0.9892, 0.9497, 0.8289, 0.5974,
                0.3081, 0.1037, 0.0220, 0.0028],
    "AGC-ALP": [0.9999, 0.9987, 0.9890, 0.9506, 0.8307, 0.5965, 0.2980,
                0.0983, 0.0179, 0.0015, 0.0000],
}

REF_TABLES = {"optimalH": REF_FER_OPT, "H05": REF_FER_H05}


def ref_fer(matrix: str, method: str, snr: float) -> float:
    """Golden FER for (matrix in {optimalH, H05}, method, snr)."""
    return REF_TABLES[matrix][method][SNR_GRID.index(round(float(snr), 1))]


def z_score(p_ours: float, n_ours: int, p_ref: float,
            n_ref: int = REF_TRIALS) -> float:
    """Two-proportion z statistic (pooled); 0 when both estimates are 0."""
    pool = (p_ours * n_ours + p_ref * n_ref) / (n_ours + n_ref)
    var = pool * (1.0 - pool) * (1.0 / n_ours + 1.0 / n_ref)
    if var <= 0.0:
        return 0.0 if p_ours == p_ref else math.inf
    return (p_ours - p_ref) / math.sqrt(var)


def suggested_trials(p_ref: float, lo: int = 2000, mid: int = 4000,
                     hi: int = 10_000) -> int:
    """Trial budget giving comparable test power across the FER range: the
    z-test resolves with sqrt(n / (p (1 - p))), so high-FER points need far
    fewer trials than the low-FER tail."""
    if p_ref > 0.3:
        return lo
    if p_ref > 0.08:
        return mid
    return hi
