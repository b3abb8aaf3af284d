"""Python wrapper of the fused BP decode kernel (``csrc/bp_decode.cu``).

Replaces ``ldpc_tpu/ops/pallas/bp_kernel.py`` (``_kernel``). The wrapper
checks its inputs, allocates the outputs, and launches on the current CUDA
stream without synchronising. It takes CUDA tensors only: the plain PyTorch
twin is :func:`ldpc_tpu_torch.ops.bp_ref.bp_decode_ref`, and
``decoders.bp.BPDecoder`` picks between the two by the tensor's device.

The kernel decodes one codeword per thread block, its threads set by the
code's shape in the source (chosen from variant builds timed on the H100,
``PERF.md``). It takes row degrees up to 32 and codes whose ``n`` and
``m * dc`` fit its 16-bit tables; other shapes are refused.

``LAUNCHES`` counts the kernel's launches, so a run can show that its main
path went through the kernel.
"""
from __future__ import annotations

import torch

from . import _build

LAUNCHES = 0
# csrc/bp_decode.cu kMaxDc (the sign parity is a 32-bit mask) and kMaxIndex
# (16-bit table entries)
_MAX_DC = 32
_MAX_INDEX = 65535

__all__ = ["bp_decode"]


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int,
           device: torch.device) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"bp_decode: {name} must be a CUDA tensor, got "
                         f"{t.device}")
    if t.device != device:
        raise ValueError(f"bp_decode: {name} is on {t.device}, llr on "
                         f"{device}")
    if t.dtype != dtype:
        raise TypeError(f"bp_decode: {name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"bp_decode: {name} must be {ndim}-D, got shape "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"bp_decode: {name} must be contiguous")


def bp_decode(llr: torch.Tensor, row_col: torch.Tensor,
              col_from_row: torch.Tensor, max_iter: int):
    """Sum-product BP with early exit, one codeword per thread block.

    ``llr`` (B, n) float32; ``row_col`` (m, dc) and ``col_from_row``
    (n, dv) int32 ``CodeGraph`` tables; all on one CUDA device. Returns
    ``(bits (B, n) uint8, success (B,) bool, iterations (B,) int32)``.
    """
    global LAUNCHES
    dev = llr.device
    _check("llr", llr, torch.float32, 2, dev)
    _check("row_col", row_col, torch.int32, 2, dev)
    _check("col_from_row", col_from_row, torch.int32, 2, dev)
    b, n = llr.shape
    m, dc = row_col.shape
    if col_from_row.shape[0] != n:
        raise ValueError(f"bp_decode: col_from_row has {col_from_row.shape[0]}"
                         f" rows, llr has {n} columns")
    if max_iter < 0:
        raise ValueError(f"bp_decode: max_iter must be >= 0, got {max_iter}")
    if dc > _MAX_DC:
        raise ValueError(f"bp_decode: row degree {dc} is more than the "
                         f"kernel's {_MAX_DC}")
    if max(n, m * dc) > _MAX_INDEX:
        raise ValueError(f"bp_decode: n = {n} or m * dc = {m * dc} does not "
                         f"fit the kernel's 16-bit tables")
    dv = col_from_row.shape[1]
    bits = torch.empty((b, n), dtype=torch.uint8, device=dev)
    success = torch.empty((b,), dtype=torch.bool, device=dev)
    iterations = torch.empty((b,), dtype=torch.int32, device=dev)
    if b == 0:
        return bits, success, iterations
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ldpc_bp_decode(
            llr.data_ptr(), row_col.data_ptr(), col_from_row.data_ptr(),
            bits.data_ptr(), success.data_ptr(), iterations.data_ptr(),
            b, n, m, dc, dv, int(max_iter), stream)
    if err != 0:
        msg = lib.ldpc_cuda_error_string(err).decode()
        raise RuntimeError(f"bp_decode launch failed: CUDA error {err} "
                           f"({msg})")
    LAUNCHES += 1
    return bits, success, iterations
