"""AGC-ALP: adaptive LP decoding with adaptive cut generation (paper IEEE
6218777; reference ``algo/agc_alp.h``; counterpart of
``ldpc_tpu/decoders/agc_alp.py``).

ALP with a second cut source: in each round, for the lanes where H gave no
new violated cut, H is Gaussian-eliminated over GF(2) with its columns
ordered most-fractional-first against the current LP solution
(``CalculateGauss``, ``agc_alp.h:19-74``; :mod:`..ops.gf2_gauss`), and the cut
search runs over the eliminated rows. A lane stops when its cut count
reaches ``max_rows`` (1000 in the reference benchmark, ``main.cpp:38``) or
neither source gives a new cut (``agc_alp.h:99-101``, with the ``||``
short-circuit: gauss cuts only in rounds where no H cut was added).
"""
from __future__ import annotations

import torch

from ..ops.gf2_gauss import GAUSS_BACKENDS, calculate_gauss_batched
from ..ops.ipm_solver import ipm_capture
from ..utils.profiling import spanned
from .alp import _AdaptiveLPBase

__all__ = ["AGCALPDecoder"]


class AGCALPDecoder(_AdaptiveLPBase):
    """AGC-ALP at the JAX package's defaults, its FER-parity configuration:
    the IPM backend with the reference's cut semantics (no snapping, no
    cut-threshold slack, the gauss fractionality eps at the reference's
    1e-8, ``utils/channel.h:10``).

    ``gauss_backend``: ``"xla"`` is the plain elimination on every lane;
    ``"kernel"`` is the elimination kernel (``csrc/gf2_gauss.cu`` on CUDA,
    its twin on the CPU), which skips the lanes that need no gauss cut;
    ``"auto"`` is ``"kernel"`` on CUDA and ``"xla"`` on the CPU.

    ``run_experiment`` streams AGC-ALP (``streaming="auto"``), as the JAX
    package does: finished lanes are drained after each cut round and
    refilled with the next trials (``_AdaptiveLPBase.stream_*``). With the
    IPM as CUDA graphs, a stream's first chunk captures the solve shape of
    every row tier at its width (:func:`..ops.ipm_solver.ipm_capture`), so
    that no later chunk stops to capture a tier the stream reaches late.
    """

    use_gauss = True

    def __init__(self, h, max_rows: int = 1000, max_rounds: int = 64,
                 lp_iters: int = 100, int_tol: float = 3e-2,
                 cut_tol: float = 3e-4, gauss_eps: float = 1e-8,
                 gauss_margin: float = 0.0, snap_tol: float = 0.0,
                 lp_backend: str = "ipm", gauss_backend: str = "auto",
                 device: torch.device | str = "cuda"):
        if gauss_backend not in GAUSS_BACKENDS:
            raise ValueError(f"unknown gauss_backend {gauss_backend!r}; "
                             f"known: {GAUSS_BACKENDS}")
        super().__init__(h, max_rows=max_rows, max_rounds=max_rounds,
                         lp_iters=lp_iters, int_tol=int_tol, cut_tol=cut_tol,
                         snap_tol=snap_tol, lp_backend=lp_backend,
                         device=device)
        self.name = "AGC-ALP"
        self.gauss_eps = float(gauss_eps)
        self.gauss_margin = float(gauss_margin)
        self.gauss_backend = gauss_backend
        self._captured_widths: set[int] = set()

    @spanned("agc.gauss")
    def _gauss_sup(self, x, need=None):
        he = calculate_gauss_batched(self.h, x, self.gauss_eps, active=need,
                                     backend=self.gauss_backend)
        return he.bool()

    def stream_chunk(self, st: dict) -> dict:
        self._capture_tiers(st)
        return super().stream_chunk(st)

    def _capture_tiers(self, st: dict) -> None:
        """Capture every row tier's solve graphs at the stream's width, once
        per width, with the arguments :meth:`_solve` gives each tier
        (:meth:`_ipm_args`; the eager path has none to capture)."""
        bsz = st["c"].shape[0]
        if bsz in self._captured_widths or self.lp_backend != "ipm":
            return
        self._captured_widths.add(bsz)
        for t in self._tiers + (self.capacity,):
            args, kw = self._ipm_args(st["c"], st["a"], st["rhs"], st["x"],
                                      st["y"], st["done"], t)
            ipm_capture(*args, **kw)
