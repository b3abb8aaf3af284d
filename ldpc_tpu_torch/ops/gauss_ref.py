"""Plain PyTorch GF(2) elimination: the ``"xla"`` path of
``ops.gf2_gauss`` and the twin of the kernel ``csrc/gf2_gauss.cu``.

What ``gf2_eliminate_ordered`` (``ldpc_tpu/ops/gf2_gauss.py:46-88``) and the
TPU kernel ``_kernel`` (``ldpc_tpu/ops/pallas/gauss_kernel.py:64``) compute:
each lane's (m, n) 0/1 matrix row-reduced in left-to-right column order. For
each column, the first row at or below the lane's rank with a 1 is the
pivot; it is swapped up to the rank's row and XORed out of every other row
with a 1 in that column, and the rank grows by one. The loop over columns
stops once every lane's rank is m: a later column can give no pivot.
"""
from __future__ import annotations

import torch

__all__ = ["gf2_eliminate_ordered", "gf2_eliminate_ref"]


def gf2_eliminate_ordered(h_perm: torch.Tensor) -> torch.Tensor:
    """Row-reduce (B, m, n) 0/1 matrices (any integer dtype) fully, in
    left-to-right column order. Returns (B, m, n) uint8."""
    hm = h_perm.to(torch.uint8).clone()
    bsz, m, n = hm.shape
    rows = torch.arange(m, device=hm.device)
    rank = torch.zeros((bsz,), dtype=torch.int64, device=hm.device)
    for col in range(n):
        if int(rank.min()) >= m:
            break
        cand = (hm[:, :, col] == 1) & (rows >= rank[:, None])   # (B, m)
        has = cand.any(dim=1)
        t = cand.to(torch.uint8).argmax(dim=1)                  # first hit
        r = rank.clamp_max(m - 1)
        row_r = hm.gather(1, r[:, None, None].expand(bsz, 1, n))
        row_t = hm.gather(1, t[:, None, None].expand(bsz, 1, n))
        oh_r = ((rows == rank[:, None]) & has[:, None])[..., None]
        oh_t = ((rows == t[:, None]) & has[:, None])[..., None]
        hm = torch.where(oh_r, row_t, torch.where(oh_t, row_r, hm))
        elim = (hm[:, :, col] == 1) & ~oh_r[..., 0] & has[:, None]
        hm = hm ^ (elim[..., None].to(torch.uint8) * row_t)
        rank = rank + has.to(torch.int64)
    return hm


def gf2_eliminate_ref(h_perm: torch.Tensor,
                      active: torch.Tensor) -> torch.Tensor:
    """The kernel's function: active lanes reduced as
    :func:`gf2_eliminate_ordered` does, inactive lanes passed through.
    Returns (B, m, n) uint8."""
    out = gf2_eliminate_ordered(h_perm)
    return torch.where(active[:, None, None], out, h_perm.to(torch.uint8))
