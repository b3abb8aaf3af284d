"""Plain PyTorch twins of the IPM's matvec and normal-matrix kernels
(``csrc/gemv.cu``, ``csrc/normal_build.cu``).

What the TPU kernels ``_fwd_kernel``, ``_tr_kernel`` and ``_normal_kernel``
of ``ldpc_tpu/ops/pallas/gemv_kernel.py`` compute, per lane, on the f32 cut
slice ``a`` (B, T, n):

* :func:`gemv_ref`: ``A x`` -> (B, T);
* :func:`gemv_t_ref`: ``A^T y`` -> (B, n);
* :func:`normal_ref`: ``M = A^T diag(d) A + diag(dxx) + delta I`` -> (B, n, n).

The TPU stored a transposed bf16 copy of A (``prepare_gemv``), a layout
choice of its vector unit; here ``a`` is taken as it is, and may be a row
slice ``a_buf[:, :T]`` of a larger per-lane buffer. The products are
``torch.bmm`` in float32; the IPM needs full f32 products, so TF32 must be
off (``ops.ipm_solver`` checks it). The diagonal is added as JAX adds it,
``(m_ii + dxx_i) + delta``.
"""
from __future__ import annotations

import torch

__all__ = ["gemv_ref", "gemv_t_ref", "normal_ref"]


def gemv_ref(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A x per lane: a (B, T, n), x (B, n) -> (B, T)."""
    return torch.bmm(a, x.unsqueeze(-1)).squeeze(-1)


def gemv_t_ref(a: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """A^T y per lane: a (B, T, n), y (B, T) -> (B, n)."""
    return torch.bmm(y.unsqueeze(1), a).squeeze(1)


def normal_ref(a: torch.Tensor, d: torch.Tensor, dxx: torch.Tensor,
               delta: float) -> torch.Tensor:
    """A^T diag(d) A + diag(dxx) + delta I per lane: a (B, T, n), d (B, T),
    dxx (B, n) -> (B, n, n) float32."""
    m = torch.bmm(a.transpose(1, 2), a * d.unsqueeze(-1))
    diag = m.diagonal(dim1=1, dim2=2)
    diag.add_(dxx).add_(delta)
    return m
