"""Plain PyTorch twins of the IPM's matvec and normal-matrix kernels
(``csrc/gemv.cu``, ``csrc/normal_build.cu``).

What the TPU kernels ``_fwd_kernel``, ``_tr_kernel`` and ``_normal_kernel``
of ``ldpc_tpu/ops/pallas/gemv_kernel.py`` compute, per lane, on the cut
slice ``a`` (B, T, n):

* :func:`gemv_ref`: ``A x`` -> (B, T);
* :func:`gemv_t_ref`: ``A^T y`` -> (B, n);
* :func:`normal_ref`: ``M = A^T diag(d) A + diag(dxx) + delta I`` -> (B, n, n).

``a`` is the float32 slice, possibly a row slice ``a_buf[:, :T]`` of a
larger per-lane buffer. The kernels read the (B, T, n_pad) int8 copy that
``gemv_kernel.pack_rows`` makes (n_pad = n rounded up to :data:`PAD`);
their plain version is the twin on :func:`unpack_rows` of it, the same
float32 values, so the same products. :func:`normal_split_ref` repeats the
normal-matrix kernel's own arithmetic (d as three bf16 planes, see
:func:`split_planes`) and is used by tests only. The products are ``torch.bmm`` in
float32; the IPM needs full f32 products, so TF32 must be off
(``ops.ipm_solver`` checks it). The diagonal is added as JAX adds it,
``(m_ii + dxx_i) + delta``.
"""
from __future__ import annotations

import torch

__all__ = ["PAD", "gemv_ref", "gemv_t_ref", "normal_ref", "normal_split_ref",
           "split_planes", "unpack_rows"]

PAD = 16   # the packed copy's columns are a multiple of this


def unpack_rows(a8: torch.Tensor, n: int) -> torch.Tensor:
    """The (B, T, n) float32 slice of a (B, T, n_pad) int8 packed copy."""
    return a8[..., :n].to(torch.float32)


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


def split_planes(d: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """d (float32) as three bfloat16 planes, ``hi = bf16(d)``,
    ``mid = bf16(d - hi)``, ``lo = bf16(d - hi - mid)``, round to nearest,
    the differences in float32. ``hi + mid + lo == d`` exactly for every
    normal float32 whose last plane is not subnormal (|d| >= 2**-100 is
    enough): each plane takes 8 of d's 24 significant bits."""
    hi = d.to(torch.bfloat16)
    r1 = d - hi.to(torch.float32)
    mid = r1.to(torch.bfloat16)
    lo = (r1 - mid.to(torch.float32)).to(torch.bfloat16)
    return hi, mid, lo


def normal_split_ref(a: torch.Tensor, d: torch.Tensor, dxx: torch.Tensor,
                     delta: float) -> torch.Tensor:
    """:func:`normal_ref` by the arithmetic of ``csrc/normal_build.cu``: the
    three planes of :func:`split_planes`, each scaling A's rows in bfloat16
    (exact for +-1/0 rows), the three products summed in float32. Differs
    from :func:`normal_ref` by the order of the float32 sums only."""
    a16 = a.to(torch.bfloat16)
    m = torch.zeros((a.shape[0], a.shape[2], a.shape[2]), dtype=torch.float32,
                    device=a.device)
    at = a16.to(torch.float32).transpose(1, 2)
    for plane in split_planes(d):
        m = m + torch.bmm(at, (a16 * plane.unsqueeze(-1)).to(torch.float32))
    diag = m.diagonal(dim1=1, dim2=2)
    diag.add_(dxx).add_(delta)
    return m
