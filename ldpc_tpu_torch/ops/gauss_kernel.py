"""Python wrapper of the GF(2) elimination kernel (``csrc/gf2_gauss.cu``).

Replaces ``ldpc_tpu/ops/pallas/gauss_kernel.py`` (``_kernel``, called by
``gf2_eliminate_pallas``). :func:`gf2_eliminate` picks by the device of
``h_perm``: a CPU tensor goes to the plain twin
:func:`..ops.gauss_ref.gf2_eliminate_ref`, a CUDA tensor to the kernel,
anything else raises; nothing falls back. On CUDA the wrapper checks its
inputs and the card's shared-memory limit (one lane's bit-packed matrix must
fit: there is no fallback to the twin for a large code, unlike the TPU's
``gauss_fits_vmem``), allocates the output and launches on the current
stream without synchronising.

``LAUNCHES`` counts the kernel's launches, so a run can show that its main
path went through the kernel.
"""
from __future__ import annotations

import torch

from . import _build
from .gauss_ref import gf2_eliminate_ref

LAUNCHES = 0

__all__ = ["gf2_eliminate"]


def gf2_eliminate(h_perm: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """Row-reduce each active lane's (m, n) 0/1 matrix in left-to-right
    column order; inactive lanes come back unreduced. h_perm (B, m, n)
    uint8, contiguous; active (B,) bool. Returns (B, m, n) uint8,
    bit-identical to ``gf2_eliminate_ordered`` on active lanes."""
    global LAUNCHES
    dev = h_perm.device
    if dev.type == "cpu":
        return gf2_eliminate_ref(h_perm, active)
    if dev.type != "cuda":
        raise ValueError(f"gf2_eliminate: no implementation for {dev}")
    if h_perm.dtype != torch.uint8:
        raise TypeError(f"gf2_eliminate: h_perm must be torch.uint8, got "
                        f"{h_perm.dtype}")
    if h_perm.dim() != 3 or min(h_perm.shape[1:]) < 1:
        raise ValueError(f"gf2_eliminate: h_perm must be (B, m, n), got "
                         f"{tuple(h_perm.shape)}")
    if not h_perm.is_contiguous():
        raise ValueError("gf2_eliminate: h_perm must be contiguous")
    bsz, m, n = h_perm.shape
    if (active.device != dev or active.dtype != torch.bool
            or tuple(active.shape) != (bsz,) or not active.is_contiguous()):
        raise ValueError(f"gf2_eliminate: active must be a contiguous "
                         f"({bsz},) bool tensor on {dev}, got "
                         f"{tuple(active.shape)} {active.dtype} on "
                         f"{active.device}")
    lib = _build.load()
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    need = lib.ldpc_gf2_gauss_smem_bytes(m, n)
    limit = lib.ldpc_smem_optin_limit(index)
    if need > limit:
        raise ValueError(f"gf2_eliminate: one lane's {m}x{n} matrix needs "
                         f"{need} bytes of shared memory; the card allows "
                         f"{limit}")
    out = torch.empty_like(h_perm)
    if bsz == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.ldpc_gf2_gauss(h_perm.data_ptr(), active.data_ptr(),
                                  out.data_ptr(), bsz, m, n, stream)
    if code != 0:
        msg = lib.ldpc_cuda_error_string(code).decode()
        raise RuntimeError(f"gf2_eliminate launch failed: CUDA error {code} "
                           f"({msg})")
    LAUNCHES += 1
    return out
