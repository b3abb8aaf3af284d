"""Batched flooding-schedule BP (counterpart of ``ldpc_tpu/decoders/bp.py``).

``BPDecoder`` holds the Tanner-graph tables of one H as buffers and picks the
implementation by the device of the LLRs it is given:

* on a CUDA tensor, early-exit ``sumprod`` goes to the fused CUDA kernel,
  :mod:`..ops.bp_kernel`;
* everything else, ``minsum`` and ``fixed_iters`` on the card and every
  variant on the CPU, goes to the plain PyTorch decode, :mod:`..ops.bp_ref`.

This is the JAX package's own split: its Pallas kernel does early-exit
sum-product, and its XLA layouts (the default ``mxu``) serve ``minsum`` and
``fixed_iters`` on the accelerator. The route is fixed by the variant and the
device; nothing falls back from the kernel to the plain decode.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..codes.graph import CodeGraph
from ..ops import bp_kernel
from ..ops.bp_ref import bp_decode_ref
from ..utils.profiling import spanned
from .base import DecodeResult, resolve_device

__all__ = ["BPDecoder"]

_TABLES = ("row_col", "row_mask", "col_mask", "row_from_col", "col_from_row")


class BPDecoder(nn.Module):
    """Flooding-schedule BP specialised to one H (a 0/1 matrix or a
    :class:`CodeGraph`). ``max_iter`` defaults to the reference's benchmark
    value 100 (``main.cpp:29``)."""

    def __init__(self, h, max_iter: int = 100, variant: str = "sumprod",
                 ms_factor: float = 0.75, fixed_iters: bool = False,
                 device: torch.device | str = "cuda"):
        super().__init__()
        device = resolve_device(device)
        if variant not in ("sumprod", "minsum"):
            raise ValueError(f"unknown BP variant {variant!r}")
        self.name = "BP"
        self.graph = g = (h if isinstance(h, CodeGraph)
                          else CodeGraph.from_h(np.asarray(h)))
        self.n, self.m = g.n, g.m
        self.max_iter = int(max_iter)
        self.variant = variant
        self.ms_factor = float(ms_factor)
        self.fixed_iters = bool(fixed_iters)
        for name in _TABLES:
            self.register_buffer(name, torch.from_numpy(
                np.ascontiguousarray(getattr(g, name))).to(device))

    @spanned("bp.decode")
    def decode_batch(self, llrs: torch.Tensor) -> DecodeResult:
        """(B, n) float32 LLRs on the decoder's device -> DecodeResult."""
        if llrs.device != self.row_col.device:
            raise ValueError(f"llrs on {llrs.device}, decoder on "
                             f"{self.row_col.device}")
        if llrs.device.type not in ("cuda", "cpu"):
            raise ValueError(f"no BP implementation for {llrs.device}")
        if (llrs.device.type == "cuda" and self.variant == "sumprod"
                and not self.fixed_iters):
            bits, success, iters = bp_kernel.bp_decode(
                llrs, self.row_col, self.col_from_row, self.max_iter)
            return DecodeResult(bits=bits, success=success, iterations=iters)
        return bp_decode_ref(llrs, self.row_col, self.row_mask,
                             self.col_mask, self.row_from_col,
                             self.col_from_row, self.max_iter, self.variant,
                             self.ms_factor, self.fixed_iters)
