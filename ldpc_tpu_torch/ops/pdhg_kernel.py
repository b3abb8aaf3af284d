"""Python wrapper of the PDHG chunk kernel (``csrc/pdhg_chunk.cu``).

Replaces ``ldpc_tpu/ops/pallas/pdhg_kernel.py`` (``_kernel``, called by
``pdhg_chunk_pallas``). :func:`pdhg_chunk` picks by the device of ``a``
(:func:`._launch.on_cpu`): a CPU tensor goes to the plain twin
:func:`..ops.pdhg_ref.pdhg_chunk_ref`, a CUDA tensor to the kernel. On CUDA
the wrapper checks its inputs, allocates the outputs and launches
(:func:`._launch.launch`) on the current stream without synchronising.

``a`` may be a row slice of a larger per-lane buffer (``a_buf[:, :T]``): its
rows must be contiguous (strides ``(L, n, 1)``, any lane stride ``L``); the
kernel takes ``L``. Every other tensor must be contiguous.

The kernel holds each lane's slice in shared memory as int8, which is exact
only for entries in {-1, 0, 1}; it checks every entry while it converts and
reports per lane. The wrapper returns that report as a fourth value, a (B,)
bool tensor that is true for an active lane whose slice has another entry
(that lane's result is wrong; the caller raises, as ``pdhg_box_lp_fused``
does). On the CPU the same report is made with tensor
operations. A shape whose slice fits neither one block's shared memory nor
its share in a cluster of 2, 4 or 8 blocks is refused with ``ValueError``
(:func:`kernel_plan` says how a shape is laid out).

``LAUNCHES`` counts the kernel's launches, so a run can show that its main
path went through the kernel; ``TIER_LAUNCHES`` counts them by row count T.
"""
from __future__ import annotations

import ctypes
from collections import Counter

import torch

from . import _build
from ._launch import counter, expect, launch, on_cpu, raise_for
from .pdhg_ref import pdhg_chunk_ref

LAUNCHES = 0
TIER_LAUNCHES: Counter = Counter()
_COUNT = counter(__name__, "LAUNCHES", "TIER_LAUNCHES")

__all__ = ["kernel_plan", "outside_set", "pdhg_chunk", "reset_tier_counts"]


def reset_tier_counts() -> None:
    """Set the per-T launch counts to zero."""
    TIER_LAUNCHES.clear()


def outside_set(a: torch.Tensor, active=None) -> torch.Tensor:
    """(B,) bool: the lane is active and its slice ``a`` (B, T, n) has an
    entry other than -1, 0 or 1. What the kernel reports, with tensor
    operations."""
    bad = ((a != 0) & (a != 1) & (a != -1)).flatten(1).any(dim=1)
    return bad if active is None else bad & active


def kernel_plan(n: int, t: int, average: bool = False) -> dict:
    """How the kernel lays out a (T, n) slice on the current CUDA device:
    ``fits``, ``blocks_per_lane`` (1, or a cluster of 2, 4 or 8 that splits
    the rows), ``row_groups``, ``threads`` and ``smem_bytes`` per block (for
    a shape that does not fit, the smallest layout's: a cluster of 8)."""
    out = (ctypes.c_longlong * 5)()
    code = _build.load().ldpc_pdhg_chunk_plan(n, t, int(average), out)
    if code:
        raise_for(code, "pdhg_chunk plan")
    return {"fits": bool(out[0]), "blocks_per_lane": int(out[1]),
            "row_groups": int(out[2]), "threads": int(out[3]),
            "smem_bytes": int(out[4])}


def pdhg_chunk(c, a, b, tau, sigma, x, y, iters: int, active=None,
               average: bool = False):
    """``iters`` PDHG steps per lane and the lane's error at the end.

    c, tau, x: (B, n) float32; a: (B, T, n) float32 with entries in
    {-1, 0, 1}; b, sigma, y: (B, T) float32; ``active``: optional (B,) bool
    (inactive lanes pass x and y through and read error 0). Returns
    (x', y', err (B,)), as :func:`..ops.pdhg_ref.pdhg_chunk_ref` does, and
    a fourth value, (B,) bool, true for an active lane whose slice has an
    entry outside the set.
    """
    if on_cpu("pdhg_chunk", a):
        out = pdhg_chunk_ref(c, a, b, tau, sigma, x, y, iters,
                             active=active, average=average)
        return (*out, outside_set(a, active))
    dev = a.device
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
        expect("pdhg_chunk", name, v, f32, (bsz, n), dev)
    for name, v in (("b", b), ("sigma", sigma), ("y", y)):
        expect("pdhg_chunk", name, v, f32, (bsz, t), dev)
    if active is not None:
        expect("pdhg_chunk", "active", active, torch.bool, (bsz,), dev)
    with torch.cuda.device(dev):
        plan = kernel_plan(n, t, average)
    if not plan["fits"]:
        index = dev.index if dev.index is not None else \
            torch.cuda.current_device()
        limit = _build.load().ldpc_smem_optin_limit(index)
        raise ValueError(f"pdhg_chunk: a lane's slice split over "
                         f"{plan['blocks_per_lane']} blocks needs "
                         f"{plan['smem_bytes']} bytes of shared memory "
                         f"(n={n}, T={t}, average={average}); the card "
                         f"allows {limit} per block")
    x_out = torch.empty_like(x)
    y_out = torch.empty_like(y)
    err = torch.empty((bsz,), dtype=f32, device=dev)
    flag = torch.empty((bsz,), dtype=torch.int32, device=dev)
    if bsz:
        launch("pdhg_chunk", "ldpc_pdhg_chunk", dev, c, a, b, tau, sigma, x,
               y, active, x_out, y_out, err, flag, bsz, n, t, a.stride(0),
               int(iters), int(average))
        _COUNT(t)
    return x_out, y_out, err, flag != 0
