"""The eight counters of a block, as the reference decoder's ``exp``
(acg-alp-ldpc ``experiment.h:33-46, 109-118``) counts them.

``correct``: the decoder's certificate, a valid codeword, equal to the word
sent; ``pseudo``: certificate and a valid codeword that differs; anything
else is a frame error. The Hamming counters count the channel's hard
decision errors (y <= 0 for bit 0, y > 0 for bit 1), split by correct and
wrong frames.
"""
from __future__ import annotations

import torch

from .gf2 import syndrome_zero

COUNTERS = ("total", "correct", "pseudo", "sum_hamming", "sum_hamming_ok",
            "sum_hamming_wrong", "sum_iterations", "sum_dropped")


def counters(h: torch.Tensor, out: dict, sent: torch.Tensor,
             y: torch.Tensor) -> torch.Tensor:
    """(8,) int64 in ``COUNTERS`` order over a batch. ``out`` holds the
    decoder's ``bits`` (B, n), ``success`` (B,), ``iterations`` (B,) and
    ``dropped`` (B,) or None."""
    bits = out["bits"]
    valid = out["success"].bool() & syndrome_zero(h, bits)
    match = (bits == sent).all(dim=-1)
    correct = valid & match
    ham = torch.where(sent == 0, y <= 0, y > 0).sum(dim=-1)
    dropped = out.get("dropped")
    zero = torch.zeros_like(ham)
    cols = (torch.ones_like(ham), correct, valid & ~match, ham,
            torch.where(correct, ham, zero), torch.where(correct, zero, ham),
            out["iterations"], zero if dropped is None else dropped)
    return torch.stack([c.to(torch.int64).sum() for c in cols])
