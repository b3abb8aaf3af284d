"""phi-domain math for sum-product BP (counterpart of ``ldpc_tpu/ops/phi.py``).

phi(x) = -log(tanh(x/2)) is an involution on (0, inf). In float32 the
argument is clamped: below 1e-9 phi saturates near 21 (a "certain" LLR),
above 31 tanh rounds to 1 and phi is exactly 0; both ends are benign for
decoding and keep the decoder free of inf/nan. ``csrc/bp_decode.cu`` applies
the same clamp.
"""
from __future__ import annotations

import torch

PHI_ARG_MIN = 1e-9
PHI_ARG_MAX = 31.0

__all__ = ["phi", "PHI_ARG_MIN", "PHI_ARG_MAX"]


def phi(x: torch.Tensor) -> torch.Tensor:
    x = x.clamp(PHI_ARG_MIN, PHI_ARG_MAX)
    return -torch.log(torch.tanh(0.5 * x))
