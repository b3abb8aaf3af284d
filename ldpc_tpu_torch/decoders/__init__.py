"""Decoder registry and factory (counterpart of
``ldpc_tpu/decoders/__init__.py``).

Ported so far: ``bp``, ``alp`` and ``agc-alp``. The other names of the JAX
registry raise ``NotImplementedError`` naming the ROADMAP item that ports
them. The decoder modules are imported when a decoder is made:
``ops.bp_ref`` imports ``decoders.base``, so importing ``decoders.bp`` here
would be circular.
"""
from __future__ import annotations

import torch

__all__ = ["DECODER_NAMES", "DEFAULT_BATCH", "default_batch",
           "make_decoder"]

DECODER_NAMES = ("bp", "qp-admm", "full-lp", "alp", "agc-alp")

# the JAX package's per-decoder batch sizes, kept so configurations carry
# across; not re-measured on the H100
DEFAULT_BATCH = {"bp": 8192, "qp-admm": 1024, "full-lp": 256,
                 "alp": 256, "agc-alp": 128}

_NOT_PORTED = {
    ("qp-admm", "qpadmm", "admm"): "QP-ADMM: ROADMAP item 8",
    ("full-lp", "fulllp"): "Full LP: ROADMAP item 10",
}


def default_batch(kind: str) -> int:
    """Per-decoder batch size (256 for names it does not know)."""
    return DEFAULT_BATCH.get(kind.lower(), 256)


def make_decoder(kind: str, h, cfg=None,
                 device: torch.device | str = "cpu"):
    """Build a decoder on ``device`` by registry name from a
    :class:`..config.DecoderConfig` (or its defaults). ``cfg.bp_layout`` is
    accepted and unused: the port's BP has one layout per device."""
    from ..config import DecoderConfig
    cfg = cfg or DecoderConfig()
    kind = kind.lower()
    if kind == "bp":
        from .bp import BPDecoder
        return BPDecoder(h, max_iter=cfg.bp_max_iter, variant=cfg.bp_variant,
                         device=device)
    if kind == "alp":
        from .alp import ALPDecoder
        return ALPDecoder(h, max_rounds=cfg.lp_max_rounds,
                          lp_iters=cfg.lp_iters, int_tol=cfg.lp_int_tol,
                          device=device)
    if kind in ("agc-alp", "agcalp", "agc"):
        from .agc_alp import AGCALPDecoder
        return AGCALPDecoder(h, max_rows=cfg.agc_max_rows,
                             max_rounds=cfg.lp_max_rounds,
                             lp_iters=cfg.lp_iters, int_tol=cfg.lp_int_tol,
                             device=device)
    for names, what in _NOT_PORTED.items():
        if kind in names:
            raise NotImplementedError(f"decoder {kind!r} is not ported to "
                                      f"ldpc_tpu_torch yet ({what})")
    raise ValueError(f"unknown decoder {kind!r}; known: {DECODER_NAMES}")
