"""Python wrappers of the IPM's matvec kernels (``csrc/gemv.cu``) and of its
normal-matrix kernel (``csrc/normal_build.cu``).

Replace ``ldpc_tpu/ops/pallas/gemv_kernel.py``: ``_fwd_kernel`` and
``_tr_kernel`` (called by ``batched_gemv`` and ``batched_gemv_t``) and
``_normal_kernel`` (called by ``normal_build``). Each wrapper picks by the
device of ``a``: a CPU tensor goes to its plain twin in :mod:`.gemv_ref`, a
CUDA tensor to the kernel, anything else raises; nothing falls back. On CUDA
a wrapper checks its inputs, allocates the output and launches on the
current stream without synchronising.

``a`` is the (B, T, n) float32 cut slice as the decoder holds it, possibly a
row slice ``a_buf[:, :T]`` of a larger per-lane buffer: its rows must be
contiguous (strides ``(L, n, 1)``, any lane stride ``L``), the contract of
``ops.pdhg_kernel``. The vectors must be contiguous. The TPU's transposed
bf16 copy (``prepare_gemv``) was a layout choice of its vector unit and has
no counterpart here.

``GEMV_LAUNCHES``, ``GEMV_T_LAUNCHES`` and ``NORMAL_LAUNCHES`` count each
kernel's launches, so a run can show that its main path went through them.
"""
from __future__ import annotations

import torch

from . import _build
from .gemv_ref import gemv_ref, gemv_t_ref, normal_ref

GEMV_LAUNCHES = 0
GEMV_T_LAUNCHES = 0
NORMAL_LAUNCHES = 0

__all__ = ["batched_gemv", "batched_gemv_t", "normal_build"]


def _check_a(fn: str, a: torch.Tensor) -> tuple[int, int, int]:
    if a.dtype != torch.float32:
        raise TypeError(f"{fn}: a must be torch.float32, got {a.dtype}")
    if a.dim() != 3:
        raise ValueError(f"{fn}: a must be 3-D, got shape {tuple(a.shape)}")
    bsz, t, n = a.shape
    if t < 1 or n < 1:
        raise ValueError(f"{fn}: empty row slice or columns, a has shape "
                         f"{tuple(a.shape)}")
    if a.stride(2) != 1 or (t > 1 and a.stride(1) != n):
        raise ValueError(f"{fn}: a's rows must be contiguous (strides "
                         f"(L, {n}, 1)), got {a.stride()}")
    return bsz, t, n


def _check_vec(fn: str, name: str, v: torch.Tensor, shape: tuple,
               device: torch.device) -> None:
    if v.device != device:
        raise ValueError(f"{fn}: {name} is on {v.device}, a on {device}")
    if v.dtype != torch.float32:
        raise TypeError(f"{fn}: {name} must be torch.float32, got {v.dtype}")
    if tuple(v.shape) != shape:
        raise ValueError(f"{fn}: {name} must have shape {shape}, got "
                         f"{tuple(v.shape)}")
    if not v.is_contiguous():
        raise ValueError(f"{fn}: {name} must be contiguous")


def _device_or_raise(fn: str, a: torch.Tensor) -> bool:
    """True for a CPU tensor (use the twin); raises off CPU and CUDA."""
    if a.device.type == "cpu":
        return True
    if a.device.type != "cuda":
        raise ValueError(f"{fn}: no implementation for {a.device}")
    return False


def _launch(fn: str, entry, *args) -> None:
    lib = _build.load()
    dev = args[0].device
    ptrs = [v.data_ptr() if isinstance(v, torch.Tensor) else v for v in args]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = getattr(lib, entry)(*ptrs, stream)
    if code != 0:
        msg = lib.ldpc_cuda_error_string(code).decode()
        raise RuntimeError(f"{fn} launch failed: CUDA error {code} ({msg})")


def batched_gemv(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A x per lane: a (B, T, n) float32, x (B, n) float32 -> (B, T)."""
    global GEMV_LAUNCHES
    if _device_or_raise("batched_gemv", a):
        return gemv_ref(a, x)
    bsz, t, n = _check_a("batched_gemv", a)
    _check_vec("batched_gemv", "x", x, (bsz, n), a.device)
    out = torch.empty((bsz, t), dtype=torch.float32, device=a.device)
    if bsz:
        _launch("batched_gemv", "ldpc_gemv_fwd", a, x, out, bsz, t, n,
                a.stride(0))
        GEMV_LAUNCHES += 1
    return out


def batched_gemv_t(a: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """A^T y per lane: a (B, T, n) float32, y (B, T) float32 -> (B, n)."""
    global GEMV_T_LAUNCHES
    if _device_or_raise("batched_gemv_t", a):
        return gemv_t_ref(a, y)
    bsz, t, n = _check_a("batched_gemv_t", a)
    _check_vec("batched_gemv_t", "y", y, (bsz, t), a.device)
    out = torch.empty((bsz, n), dtype=torch.float32, device=a.device)
    if bsz:
        _launch("batched_gemv_t", "ldpc_gemv_tr", a, y, out, bsz, t, n,
                a.stride(0))
        GEMV_T_LAUNCHES += 1
    return out


def normal_build(a: torch.Tensor, d: torch.Tensor, dxx: torch.Tensor,
                 delta: float) -> torch.Tensor:
    """M = A^T diag(d) A + diag(dxx) + delta I per lane: a (B, T, n),
    d (B, T), dxx (B, n), all float32 -> (B, n, n) float32, both triangles
    written."""
    global NORMAL_LAUNCHES
    if _device_or_raise("normal_build", a):
        return normal_ref(a, d, dxx, delta)
    bsz, t, n = _check_a("normal_build", a)
    _check_vec("normal_build", "d", d, (bsz, t), a.device)
    _check_vec("normal_build", "dxx", dxx, (bsz, n), a.device)
    out = torch.empty((bsz, n, n), dtype=torch.float32, device=a.device)
    if bsz:
        _launch("normal_build", "ldpc_normal_build", a, d, dxx, out, bsz, t,
                n, a.stride(0), float(delta))
        NORMAL_LAUNCHES += 1
    return out
