"""Batched GF(2) Gaussian elimination with solution-adapted column order, the
cut source of AGC-ALP (counterpart of ``ldpc_tpu/ops/gf2_gauss.py``).

Reproduces ``CalculateGauss`` (``algo/agc_alp.h:19-74``) per lane:

1. order the columns: fractional entries first, stably sorted by |u - 0.5|
   ascending; then the integral zeros, then the integral ones, each in
   their original order (``agc_alp.h:20-39``);
2. row-reduce H over GF(2) in that column order: for each column, the first
   row at or below the rank with a 1 is swapped up and XORed out of every
   other row (``agc_alp.h:44-72``);
3. undo the column permutation (``agc_alp.h:73``).

The data-dependent column advance of the reference is a fixed n-column loop
here: each column either yields a pivot (swap, eliminate, rank + 1) or is
skipped, the same elimination in the same order. JAX's one-hot permutation
matmuls were a TPU workaround for batched gathers; ``torch.gather`` is exact.
"""
from __future__ import annotations

import torch

from .gauss_kernel import gf2_eliminate
from .gauss_ref import gf2_eliminate_ordered

EPS = 1e-8
GAUSS_BACKENDS = ("auto", "xla", "kernel")

__all__ = ["EPS", "GAUSS_BACKENDS", "calculate_gauss_batched",
           "fractional_column_order", "gf2_eliminate_ordered"]


def fractional_column_order(u: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """Per-lane column permutation p (B, n) int64: the lexicographic order of
    (group, |u - 0.5| for the fractional group else 0, index), with groups
    fractional 0, zeros 1, ones 2. Two stable sorts give it: by the distance,
    then by the group."""
    group = torch.where(u < eps, 1, torch.where(u > 1.0 - eps, 2, 0))
    dist = torch.where(group == 0, (u - 0.5).abs(), 0.0)
    by_dist = torch.sort(dist, dim=-1, stable=True).indices
    by_group = torch.sort(group.gather(-1, by_dist), dim=-1,
                          stable=True).indices
    return by_dist.gather(-1, by_group)


def calculate_gauss_batched(h: torch.Tensor, u: torch.Tensor,
                            eps: float = EPS, active=None,
                            backend: str = "auto") -> torch.Tensor:
    """Full CalculateGauss: h (m, n) uint8 (0/1), u (B, n) -> (B, m, n)
    uint8 on u's device.

    ``backend``: ``"xla"`` (the JAX package's name) is the plain elimination
    :func:`gf2_eliminate_ordered` on every lane; ``"kernel"`` is
    :func:`.gauss_kernel.gf2_eliminate` (``csrc/gf2_gauss.cu`` on CUDA, the
    same twin on the CPU), which leaves the lanes that ``active`` marks off
    unreduced: callers mask them. ``"auto"`` is ``"kernel"`` on CUDA and
    ``"xla"`` on the CPU.
    """
    if backend not in GAUSS_BACKENDS:
        raise ValueError(f"unknown gauss backend {backend!r}; known: "
                         f"{GAUSS_BACKENDS}")
    if backend == "auto":
        backend = "kernel" if u.device.type == "cuda" else "xla"
    bsz, n = u.shape
    m = h.shape[0]
    p = fractional_column_order(u, eps)                       # (B, n)
    idx = p[:, None, :].expand(bsz, m, n)
    h_perm = h.to(torch.uint8).expand(bsz, m, n).gather(2, idx)
    if backend == "xla":
        he = gf2_eliminate_ordered(h_perm)
    else:
        if active is None:
            active = torch.ones((bsz,), dtype=torch.bool, device=u.device)
        he = gf2_eliminate(h_perm.contiguous(), active)
    # un-permute: out[b, i, p[b, j]] = he[b, i, j]
    return torch.empty_like(he).scatter_(2, idx, he)
