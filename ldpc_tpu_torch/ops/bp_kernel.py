"""Python wrapper of the fused BP decode kernel (``csrc/bp_decode.cu``).

Replaces ``ldpc_tpu/ops/pallas/bp_kernel.py`` (``_kernel``). The wrapper
checks its inputs, allocates the outputs, and launches
(:func:`._launch.launch`) on the current CUDA stream without synchronising.
It takes CUDA tensors only and refuses a CPU tensor
(:func:`._launch.cuda_only`) instead of running a twin: the kernel covers
one variant of BP (sum-product with early exit), so the caller,
``decoders.bp.BPDecoder``, picks by variant and device between it and the
plain PyTorch twin :func:`ldpc_tpu_torch.ops.bp_ref.bp_decode_ref`.

The kernel decodes one codeword per thread block, its threads set by the
code's shape in the source (chosen from variant builds timed on the H100,
``PERF.md``). It takes row degrees up to 32 and codes whose ``n`` and
``m * dc`` fit its 16-bit tables; other shapes are refused.

``LAUNCHES`` counts the kernel's launches, so a run can show that its main
path went through the kernel.
"""
from __future__ import annotations

import torch

from ._launch import counter, cuda_only, expect, launch

LAUNCHES = 0
_COUNT = counter(__name__, "LAUNCHES")
# csrc/bp_decode.cu kMaxDc (the sign parity is a 32-bit mask) and kMaxIndex
# (16-bit table entries)
_MAX_DC = 32
_MAX_INDEX = 65535

__all__ = ["bp_decode"]


def bp_decode(llr: torch.Tensor, row_col: torch.Tensor,
              col_from_row: torch.Tensor, max_iter: int):
    """Sum-product BP with early exit, one codeword per thread block.

    ``llr`` (B, n) float32; ``row_col`` (m, dc) and ``col_from_row``
    (n, dv) int32 ``CodeGraph`` tables; all on one CUDA device. Returns
    ``(bits (B, n) uint8, success (B,) bool, iterations (B,) int32)``.
    """
    named = (("llr", llr, torch.float32), ("row_col", row_col, torch.int32),
             ("col_from_row", col_from_row, torch.int32))
    cuda_only("bp_decode", ((name, t) for name, t, _ in named))
    dev = llr.device
    for name, t, dtype in named:
        if t.dim() != 2:
            raise ValueError(f"bp_decode: {name} must be 2-D, got shape "
                             f"{tuple(t.shape)}")
        expect("bp_decode", name, t, dtype, t.shape, dev)
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
    if b:
        launch("bp_decode", "ldpc_bp_decode", dev, llr, row_col, col_from_row,
               bits, success, iterations, b, n, m, dc, dv, int(max_iter))
        _COUNT()
    return bits, success, iterations
