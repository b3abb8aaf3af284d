"""Plain PyTorch twin of the Cholesky diagonal-block kernel
(``csrc/chol_diag_inv.cu``), and the NaN rule both IPM factor paths share.

The TPU kernel ``_diag_inv_kernel`` (``ldpc_tpu/ops/pallas/chol_kernel.py``)
factors every lane's SPD (nb, nb) diagonal block and inverts the triangle.
A lane that is not SPD comes out NaN, in that lane only: the IPM freezes such
a lane instead of letting it poison the batch (``ops.ipm_solver``).

``jnp.linalg.cholesky`` NaN-fills a lane whose factorization fails;
``torch.linalg.cholesky`` raises instead, and ``cholesky_ex`` returns a
partial factor with ``info > 0``. :func:`cholesky_nan` therefore writes NaN
into the lower triangle of exactly the lanes with ``info != 0``, without
reading ``info`` on the host (``check_errors=False``, no stream sync).
"""
from __future__ import annotations

import torch

__all__ = ["chol_diag_inv_ref", "cholesky_nan"]


def cholesky_nan(m: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of each (.., n, n) lane; a lane that is not SPD
    is NaN on and below its diagonal, as ``jnp.linalg.cholesky`` gives it."""
    l, info = torch.linalg.cholesky_ex(m, check_errors=False)
    lower = torch.ones(m.shape[-2:], dtype=torch.bool,
                       device=m.device).tril()
    return torch.where((info != 0)[..., None, None] & lower, float("nan"), l)


def chol_diag_inv_ref(d: torch.Tensor):
    """(B, nb, nb) SPD blocks -> (L, L^{-1}), both (B, nb, nb) float32 and
    lower triangular; a non-SPD lane is NaN in both."""
    l = cholesky_nan(d)
    eye = torch.eye(d.shape[-1], dtype=d.dtype, device=d.device)
    inv = torch.linalg.solve_triangular(l, eye.expand_as(l), upper=False)
    return l, inv
