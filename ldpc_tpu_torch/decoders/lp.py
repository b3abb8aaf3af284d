"""Full ("Feldman") LP decoding over the cascaded three-variable polytope
(counterpart of ``ldpc_tpu/decoders/lp.py``).

The LP rows are the cascade constraints the reference builds into GLPK
(``DecodeFullLP``, ``full_lp.h:61-156``), the structure QP-ADMM uses
(:class:`.admm.ADMMStructure`). The solve is batched fixed-iteration PDHG
(:func:`..ops.lp_solver.pdhg_box_lp_shared`) instead of dual simplex; the
constraint matrix is shared by the batch, so its products are GEMMs.

Certificate as ``DecodeFromLp`` (``full_lp.h:44-59``): round at 0.5, integral
iff no codeword variable lies in (int_tol, 1 - int_tol), and a certified
output must be a codeword (the reference asserts it, ``full_lp.h:151-153``).
The reference comments this decoder out of its benchmark (``main.cpp:36``).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..codes.gf2 import is_codeword
from ..ops.lp_solver import pdhg_box_lp_shared
from .admm import ADMMStructure
from .base import DecodeResult, resolve_device

__all__ = ["FullLPDecoder", "cascade_matrix"]


def cascade_matrix(s: ADMMStructure) -> np.ndarray:
    """The dense (n_con, n_var) float32 constraint matrix of the cascade,
    built as the JAX package builds it (``lp.py:44-50``)."""
    a = np.zeros((s.n_con, s.n_var), np.float32)
    for ci in range(s.n_con):
        for sl in range(3):
            vi = s.con_var[ci, sl]
            if vi < s.n_var:
                a[ci, vi] += s.con_coef[ci, sl]
    return a


class FullLPDecoder(nn.Module):
    """Full LP decoder specialised to one H: ``iters`` PDHG steps on every
    lane from the box-LP vertex ``x0 = (c < 0)``."""

    def __init__(self, h, iters: int = 2000, int_tol: float = 3e-2,
                 structure: ADMMStructure | None = None,
                 device: torch.device | str = "cuda"):
        super().__init__()
        device = resolve_device(device)
        self.name = "FullLP"
        h = np.asarray(h, dtype=np.uint8) % 2
        self.structure = s = structure or ADMMStructure.from_h(h)
        self.n = s.n
        self.iters = int(iters)
        self.int_tol = float(int_tol)
        for name, arr in (("h", h), ("a", cascade_matrix(s)), ("b", s.b)):
            self.register_buffer(name, torch.from_numpy(
                np.ascontiguousarray(arr)).to(device))

    def solve(self, llrs: torch.Tensor) -> torch.Tensor:
        """(B, n) LLRs -> the LP iterate x (B, n_var) after ``iters``
        steps."""
        if llrs.device != self.a.device:
            raise ValueError(f"llrs on {llrs.device}, decoder on "
                             f"{self.a.device}")
        s = self.structure
        bsz = llrs.shape[0]
        c = torch.cat([llrs.to(torch.float32),
                       llrs.new_zeros((bsz, s.n_var - s.n),
                                      dtype=torch.float32)], dim=1)
        x0 = (c < 0.0).to(torch.float32)     # the box LP's vertex
        y0 = c.new_zeros((bsz, s.n_con))
        x, _ = pdhg_box_lp_shared(c, self.a, self.b, x0, y0, self.iters)
        return x

    def decode_batch(self, llrs: torch.Tensor) -> DecodeResult:
        """(B, n) float32 LLRs on the decoder's device -> DecodeResult
        (``iterations`` = ``iters`` on every lane)."""
        xv = self.solve(llrs)[:, :self.n]
        bits = (xv > 0.5).to(torch.uint8)
        integral = ((xv < self.int_tol) | (xv > 1.0 - self.int_tol)).all(-1)
        success = integral & is_codeword(self.h, bits)
        return DecodeResult(bits=bits, success=success,
                            iterations=torch.full((bits.shape[0],),
                                                  self.iters,
                                                  dtype=torch.int32,
                                                  device=bits.device))
