"""Plain PyTorch flooding BP, the twin of the kernel ``csrc/bp_decode.cu``.

Counterpart of ``ldpc_tpu/decoders/bp.py`` (``_check_update_rowlayout`` and
the ``layout="edge"`` decode): messages live on padded edge slots, the row
layout ``(B, m, dc)`` and the col layout ``(B, n, dv)``, re-bucketed with flat
gathers through the ``CodeGraph`` permutations. This is also the kernel's
formulation: a row pass over ``row_col`` slots and a column pass over
``col_from_row`` edges.

Semantics (the reference's ``algo/bp.h``, kept by the JAX package):

* check->variable: sgn * phi(sum phi(|v2c|)) over the row excluding self;
  ``v2c <= 0`` counts as negative; pad slots carry ``NEUTRAL_LLR``;
* posterior ``total = llr + sum c2v``; variable->check ``total - c2v``;
* hard decision ``total <= 0 -> 1``;
* each lane freezes at its first syndrome success; a lane that never
  succeeds reports ``iterations = max_iter``.

The row and column sums run in slot order, one add at a time, which is the
order the kernel uses, so on one device the two see the same float32
arithmetic up to the math library's ``log``/``tanh``.
"""
from __future__ import annotations

import torch

from ..decoders.base import DecodeResult
from .phi import phi

NEUTRAL_LLR = 64.0  # pad-slot LLR: phi() == 0, sign +1 -> no contribution

__all__ = ["NEUTRAL_LLR", "check_update_rowlayout", "bp_decode_ref"]


def _slot_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in slot order: ((x0 + x1) + x2) + ..."""
    s = x[..., 0]
    for k in range(1, x.shape[-1]):
        s = s + x[..., k]
    return s


def check_update_rowlayout(v2c: torch.Tensor, mask: torch.Tensor,
                           variant: str = "sumprod",
                           ms_factor: float = 0.75) -> torch.Tensor:
    """Row-layout check-node update: v2c (B, m, dc) -> c2v (B, m, dc)."""
    neg = (v2c <= 0.0) & mask
    sign_e = torch.where(neg, -1.0, 1.0)
    total_neg = neg.sum(dim=-1, keepdim=True)
    sign_tot = 1.0 - 2.0 * (total_neg % 2).to(v2c.dtype)
    if variant == "sumprod":
        mag = torch.where(mask, phi(v2c.abs()), 0.0)
        out_mag = phi(_slot_sum(mag)[..., None] - mag)
    elif variant == "minsum":
        a = torch.where(mask, v2c.abs(), float("inf"))
        m1, idx = a.min(dim=-1, keepdim=True)        # first minimum
        slot = torch.arange(a.shape[-1], device=a.device)
        first = slot == idx
        m2 = torch.where(first, float("inf"), a).amin(dim=-1, keepdim=True)
        out_mag = ms_factor * torch.where(first, m2, m1)
    else:
        raise ValueError(f"unknown BP variant {variant!r}")
    return torch.where(mask, sign_tot * sign_e * out_mag, 0.0)


def bp_decode_ref(llr: torch.Tensor, row_col: torch.Tensor,
                  row_mask: torch.Tensor, col_mask: torch.Tensor,
                  row_from_col: torch.Tensor, col_from_row: torch.Tensor,
                  max_iter: int, variant: str = "sumprod",
                  ms_factor: float = 0.75,
                  fixed_iters: bool = False) -> DecodeResult:
    """Decode a (B, n) float32 LLR batch with flooding BP.

    The tables are the ``CodeGraph`` arrays as tensors on ``llr``'s device.
    The loop leaves once every lane has converged (or after ``max_iter``
    iterations; always after ``max_iter`` with ``fixed_iters``), which reads
    one flag back to the host per iteration.
    """
    b, n = llr.shape
    m, dc = row_mask.shape
    dv = col_mask.shape[1]
    rc = row_col.long().reshape(-1)
    rfc = row_from_col.long().reshape(-1)
    cfr = col_from_row.long().reshape(-1)

    def gather(x, fill, index, shape):
        flat = torch.cat([x.flatten(1), x.new_full((b, 1), fill)], dim=1)
        return flat[:, index].reshape(b, *shape)

    def iteration(v2c_row):
        c2v_row = check_update_rowlayout(v2c_row, row_mask, variant,
                                         ms_factor)
        c2v_col = gather(c2v_row, 0.0, cfr, (n, dv))
        total = llr + _slot_sum(torch.where(col_mask, c2v_col, 0.0))
        v2c_col = torch.where(col_mask, total[:, :, None] - c2v_col,
                              NEUTRAL_LLR)
        return gather(v2c_col, NEUTRAL_LLR, rfc, (m, dc)), total <= 0.0

    def syndrome_ok(bits):
        parity = gather(bits, 0, rc, (m, dc)).sum(dim=-1) % 2
        return (parity == 0).all(dim=-1)

    # the first v->c message is the channel LLR of the edge's column
    v2c = torch.where(row_mask, gather(llr, NEUTRAL_LLR, rc, (m, dc)),
                      NEUTRAL_LLR)
    bits = (llr <= 0.0).to(torch.uint8)
    done = torch.zeros(b, dtype=torch.bool, device=llr.device)
    iters = torch.full((b,), max_iter, dtype=torch.int32, device=llr.device)
    it = 0
    while it < max_iter and (fixed_iters or not bool(done.all())):
        v2c, hard = iteration(v2c)
        bits_new = hard.to(torch.uint8)
        ok = syndrome_ok(bits_new)
        iters = iters.masked_fill(ok & ~done, it + 1)
        bits = torch.where(done[:, None], bits, bits_new)
        done = done | ok
        it += 1
    return DecodeResult(bits=bits, success=done, iterations=iters)
