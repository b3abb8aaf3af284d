"""Python wrapper of the PDHG chunk kernel (``csrc/pdhg_chunk.cu``).

Replaces ``ldpc_tpu/ops/pallas/pdhg_kernel.py`` (``_kernel``, called by
``pdhg_chunk_pallas``). :func:`pdhg_chunk` picks by the device of ``a``: a
CPU tensor goes to the plain twin :func:`..ops.pdhg_ref.pdhg_chunk_ref`, a
CUDA tensor to the kernel, anything else raises; nothing falls back. On CUDA
the wrapper checks its inputs, allocates the outputs and launches on the
current stream without synchronising.

``a`` may be a row slice of a larger per-lane buffer (``a_buf[:, :T]``): its
rows must be contiguous (strides ``(L, n, 1)``, any lane stride ``L``); the
kernel takes ``L``. Every other tensor must be contiguous.

``LAUNCHES`` counts the kernel's launches, so a run can show that its main
path went through the kernel.
"""
from __future__ import annotations

import torch

from . import _build
from .pdhg_ref import pdhg_chunk_ref

LAUNCHES = 0

__all__ = ["pdhg_chunk"]


def _check(name: str, v: torch.Tensor, shape: tuple, dtype: torch.dtype,
           device: torch.device) -> None:
    if v.device != device:
        raise ValueError(f"pdhg_chunk: {name} is on {v.device}, a on "
                         f"{device}")
    if v.dtype != dtype:
        raise TypeError(f"pdhg_chunk: {name} must be {dtype}, got {v.dtype}")
    if tuple(v.shape) != shape:
        raise ValueError(f"pdhg_chunk: {name} must have shape {shape}, got "
                         f"{tuple(v.shape)}")
    if not v.is_contiguous():
        raise ValueError(f"pdhg_chunk: {name} must be contiguous")


def pdhg_chunk(c, a, b, tau, sigma, x, y, iters: int, active=None,
               average: bool = False):
    """``iters`` PDHG steps per lane and the lane's error at the end.

    c, tau, x: (B, n) float32; a: (B, T, n) float32; b, sigma, y: (B, T)
    float32; ``active``: optional (B,) bool (inactive lanes pass x and y
    through and read error 0). Returns (x', y', err (B,)), as
    :func:`..ops.pdhg_ref.pdhg_chunk_ref` does.
    """
    global LAUNCHES
    dev = a.device
    if dev.type == "cpu":
        return pdhg_chunk_ref(c, a, b, tau, sigma, x, y, iters,
                              active=active, average=average)
    if dev.type != "cuda":
        raise ValueError(f"pdhg_chunk: no implementation for {dev}")
    if a.dtype != torch.float32:
        raise TypeError(f"pdhg_chunk: a must be torch.float32, got {a.dtype}")
    if a.dim() != 3:
        raise ValueError(f"pdhg_chunk: a must be 3-D, got shape "
                         f"{tuple(a.shape)}")
    bsz, t, n = a.shape
    if t < 1 or n < 1:
        raise ValueError(f"pdhg_chunk: empty row slice or columns, a has "
                         f"shape {tuple(a.shape)}")
    if a.stride(2) != 1 or a.stride(1) != n:
        raise ValueError(f"pdhg_chunk: a's rows must be contiguous (strides "
                         f"(L, {n}, 1)), got {a.stride()}")
    if iters < 1:
        raise ValueError(f"pdhg_chunk: iters must be >= 1, got {iters}")
    f32 = torch.float32
    for name, v in (("c", c), ("tau", tau), ("x", x)):
        _check(name, v, (bsz, n), f32, dev)
    for name, v in (("b", b), ("sigma", sigma), ("y", y)):
        _check(name, v, (bsz, t), f32, dev)
    if active is not None:
        _check("active", active, (bsz,), torch.bool, dev)
    lib = _build.load()
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    need = lib.ldpc_pdhg_chunk_smem_bytes(n, t, int(average))
    limit = lib.ldpc_smem_optin_limit(index)
    if need > limit:
        raise ValueError(f"pdhg_chunk: one lane needs {need} bytes of shared "
                         f"memory (n={n}, T={t}, average={average}); the "
                         f"card allows {limit}")
    x_out = torch.empty_like(x)
    y_out = torch.empty_like(y)
    err = torch.empty((bsz,), dtype=f32, device=dev)
    if bsz == 0:
        return x_out, y_out, err
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.ldpc_pdhg_chunk(
            c.data_ptr(), a.data_ptr(), b.data_ptr(), tau.data_ptr(),
            sigma.data_ptr(), x.data_ptr(), y.data_ptr(),
            active.data_ptr() if active is not None else None,
            x_out.data_ptr(), y_out.data_ptr(), err.data_ptr(),
            bsz, n, t, a.stride(0), int(iters), int(average), stream)
    if code != 0:
        msg = lib.ldpc_cuda_error_string(code).decode()
        raise RuntimeError(f"pdhg_chunk launch failed: CUDA error {code} "
                           f"({msg})")
    LAUNCHES += 1
    return x_out, y_out, err
