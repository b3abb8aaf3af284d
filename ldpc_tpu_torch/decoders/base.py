"""Batched decoder API (counterpart of ``ldpc_tpu/decoders/base.py``).

Decoders are batched and specialised to H at construction time; the graph
structure is extracted once on the host and ``decode_batch`` maps a (B, n)
float32 batch of channel LLRs to a :class:`DecodeResult` on the same device.
Decoders and the harness run on the card unless the caller passes
``device="cpu"`` (:func:`resolve_device`).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Protocol, runtime_checkable

import torch

__all__ = ["DecodeResult", "Decoder", "resolve_device"]


def resolve_device(device: torch.device | str) -> torch.device:
    """``device`` as a ``torch.device``; raises when it names CUDA and no
    card is visible, rather than carrying on elsewhere."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} asked for, but "
                           f"torch.cuda.is_available() is false; pass "
                           f"device='cpu' to run on the CPU")
    return device


class DecodeResult(NamedTuple):
    bits: torch.Tensor         # (B, n) uint8: hard decisions
    success: torch.Tensor      # (B,) bool: decoder certificate
    iterations: torch.Tensor   # (B,) int32: iterations used (diagnostic)
    # (B,) int32 resource-exhaustion telemetry; None where not applicable.
    dropped: Optional[torch.Tensor] = None


@runtime_checkable
class Decoder(Protocol):
    name: str
    n: int

    def decode_batch(self, llrs: torch.Tensor) -> DecodeResult:
        ...
