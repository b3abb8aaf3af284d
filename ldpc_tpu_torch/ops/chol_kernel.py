"""Python wrapper of the Cholesky diagonal-block kernel
(``csrc/chol_diag_inv.cu``).

Replaces ``ldpc_tpu/ops/pallas/chol_kernel.py`` (``_diag_inv_kernel``,
called by ``_chol_diag_inv``). :func:`chol_diag_inv` picks by the device of
``d``: a CPU tensor goes to the plain twin
:func:`..ops.chol_ref.chol_diag_inv_ref`, a CUDA tensor to the kernel,
anything else raises; nothing falls back. On CUDA the wrapper checks its
input, allocates the outputs and launches on the current stream without
synchronising.

``LAUNCHES`` counts the kernel's launches, so a run can show that its main
path went through the kernel.
"""
from __future__ import annotations

import torch

from . import _build
from .chol_ref import chol_diag_inv_ref

LAUNCHES = 0

__all__ = ["chol_diag_inv"]


def _raise_launch(lib, what: str, code: int) -> None:
    msg = lib.ldpc_cuda_error_string(code).decode()
    raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")


def chol_diag_inv(d: torch.Tensor):
    """(B, nb, nb) float32 SPD blocks -> (L, L^{-1}), both (B, nb, nb),
    lower triangular, zero above the diagonal. A lane that is not SPD is
    NaN in that lane only."""
    global LAUNCHES
    dev = d.device
    if dev.type == "cpu":
        return chol_diag_inv_ref(d)
    if dev.type != "cuda":
        raise ValueError(f"chol_diag_inv: no implementation for {dev}")
    if d.dtype != torch.float32:
        raise TypeError(f"chol_diag_inv: d must be torch.float32, got "
                        f"{d.dtype}")
    if d.dim() != 3 or d.shape[1] != d.shape[2] or d.shape[1] < 1:
        raise ValueError(f"chol_diag_inv: d must be (B, nb, nb), got "
                         f"{tuple(d.shape)}")
    if not d.is_contiguous():
        raise ValueError("chol_diag_inv: d must be contiguous")
    bsz, nb, _ = d.shape
    lib = _build.load()
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    need = lib.ldpc_chol_diag_inv_smem_bytes(nb)
    limit = lib.ldpc_smem_optin_limit(index)
    if need > limit:
        raise ValueError(f"chol_diag_inv: one block of {nb}x{nb} needs "
                         f"{need} bytes of shared memory; the card allows "
                         f"{limit}")
    l_out = torch.empty_like(d)
    inv_out = torch.empty_like(d)
    if bsz == 0:
        return l_out, inv_out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.ldpc_chol_diag_inv(d.data_ptr(), l_out.data_ptr(),
                                      inv_out.data_ptr(), bsz, nb, stream)
    if code != 0:
        _raise_launch(lib, "chol_diag_inv", code)
    LAUNCHES += 1
    return l_out, inv_out
