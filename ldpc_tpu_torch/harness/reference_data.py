"""Reference golden FER curve and the statistical-parity test (from
``ldpc_tpu/harness/reference_data.py``).

The reference publishes 10,000 Monte-Carlo trials per (decoder, SNR) point
(``reports/report_opt.csv``, matrix ``data/optimalH.txt``). Its ``mt19937``
sample path cannot be matched bit for bit, so parity is |z| < Z_BOUND under
the two-proportion z-test.
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


def z_score(p_ours: float, n_ours: int, p_ref: float,
            n_ref: int = REF_TRIALS) -> float:
    """Two-proportion z statistic (pooled); 0 when both estimates are 0."""
    pool = (p_ours * n_ours + p_ref * n_ref) / (n_ours + n_ref)
    var = pool * (1.0 - pool) * (1.0 / n_ours + 1.0 / n_ref)
    if var <= 0.0:
        return 0.0 if p_ours == p_ref else math.inf
    return (p_ours - p_ref) / math.sqrt(var)
