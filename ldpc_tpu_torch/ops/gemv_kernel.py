"""Python wrappers of the IPM's matvec kernels (``csrc/gemv.cu``) and of its
normal-matrix kernel (``csrc/normal_build.cu``), and the packed copy of the
cut rows all three read.

Replace ``ldpc_tpu/ops/pallas/gemv_kernel.py``: ``_fwd_kernel`` and
``_tr_kernel`` (called by ``batched_gemv`` and ``batched_gemv_t``),
``_normal_kernel`` (called by ``normal_build``) and ``prepare_gemv``
(:func:`pack_rows`). Each wrapper picks by the device of ``a``
(:func:`._launch.on_cpu`): a CPU tensor goes to its plain twin in
:mod:`.gemv_ref` on the unpacked copy, a CUDA tensor to the kernel. A
wrapper checks its inputs on either device, allocates the output and on
CUDA launches (:func:`._launch.launch`) on the current stream without
synchronising.

The kernels read the packed copy :func:`pack_rows` makes once per solve: a
contiguous (B, T, n_pad) int8 tensor, n_pad = n rounded up to 16, pad
columns zero, so that every row starts 16-byte aligned for the kernels'
bulk copies. Cut rows are +-1/0, so one byte is exact; ``pack_rows`` also
returns a device flag that says so, which the IPM reads with the host read
it already makes. The TPU's copy was bf16 in a transposed (B, n8, T) layout,
a choice of its vector unit; int8 moves half of bf16's bytes. ``normal_build``
runs on the tensor cores: it turns the int8 entries into bf16 (exact) and
splits d into three bf16 planes that sum back to d exactly.

:func:`gemv_t_launch` launches the A^T y kernel, optionally with its
epilogue -ea - A^T y + eb - ec, for a caller that checked its inputs and
keeps its own twin (the IPM's Newton right-hand side,
:func:`.ipm_kernel.newton_rhs`).

``GEMV_LAUNCHES``, ``GEMV_T_LAUNCHES`` and ``NORMAL_LAUNCHES`` count each
kernel's launches (the epilogue's among the A^T y ones), so a run can
show that its main path went through them;
``GEMV_TIER_LAUNCHES``, ``GEMV_T_TIER_LAUNCHES`` and ``NORMAL_TIER_LAUNCHES``
count them by row count T (declared with :func:`._launch.counter`).
"""
from __future__ import annotations

from collections import Counter

import torch

from . import _build
from ._launch import counter, expect, launch, on_cpu
from .gemv_ref import PAD, gemv_ref, gemv_t_ref, normal_ref, unpack_rows

GEMV_LAUNCHES = 0
GEMV_T_LAUNCHES = 0
NORMAL_LAUNCHES = 0
GEMV_TIER_LAUNCHES: Counter = Counter()
GEMV_T_TIER_LAUNCHES: Counter = Counter()
NORMAL_TIER_LAUNCHES: Counter = Counter()
_GEMV = counter(__name__, "GEMV_LAUNCHES", "GEMV_TIER_LAUNCHES")
_GEMV_T = counter(__name__, "GEMV_T_LAUNCHES", "GEMV_T_TIER_LAUNCHES")
_NORMAL = counter(__name__, "NORMAL_LAUNCHES", "NORMAL_TIER_LAUNCHES")

__all__ = ["batched_gemv", "batched_gemv_t", "check_packed", "gemv_t_launch",
           "normal_build", "pack_rows", "reset_tier_counts"]

_chunk_rows: dict[int, int] = {}
# per (device, stream): A^T y's per-lane run counts, zeros that the kernel
# leaves zero, so no call pays a fill
_counts: dict[tuple[int, int], torch.Tensor] = {}


def _run_counts(device: torch.device, bsz: int) -> torch.Tensor:
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    counts = _counts.get(key)
    if counts is None or counts.numel() < bsz:
        counts = _counts[key] = torch.zeros(max(bsz, 256), dtype=torch.int32,
                                            device=device)
    return counts


def reset_tier_counts() -> None:
    """Set the per-T launch counts of the three kernels to zero."""
    GEMV_TIER_LAUNCHES.clear()
    GEMV_T_TIER_LAUNCHES.clear()
    NORMAL_TIER_LAUNCHES.clear()


def pack_rows(a: torch.Tensor, out: torch.Tensor | None = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """The int8 copy of a (B, T, n) cut slice (any strides) the matvec
    kernels read: (B, T, n_pad) contiguous, n_pad = n rounded up to 16, pad
    columns zero; and a 0-d bool tensor on a's device, true when every entry
    of ``a`` is -1, 0 or 1 (the copy is exact only then). No host read.
    ``out``: a buffer of that shape to pack into, whose pad columns are
    zero (as a previous pack leaves them); only its first n columns are
    written."""
    if a.dim() != 3:
        raise ValueError(f"pack_rows: a must be 3-D, got shape "
                         f"{tuple(a.shape)}")
    bsz, t, n = a.shape
    n_pad = -(-n // PAD) * PAD
    if out is None:
        a8 = torch.zeros((bsz, t, n_pad), dtype=torch.int8, device=a.device)
    elif (out.dtype != torch.int8 or tuple(out.shape) != (bsz, t, n_pad)
          or out.device != a.device or not out.is_contiguous()):
        raise ValueError(f"pack_rows: out must be a contiguous int8 "
                         f"{(bsz, t, n_pad)} tensor on {a.device}")
    else:
        a8 = out
    view = a8[..., :n]
    view.copy_(a)
    ok = ((view == a) & (view.abs() <= 1)).all()
    return a8, ok


def check_packed(fn: str, a8: torch.Tensor, n: int) -> tuple[int, int, int]:
    """(B, T, n_pad) of ``a8``, refused unless it is :func:`pack_rows`'s
    copy of a slice with ``n`` columns."""
    if a8.dtype != torch.int8:
        raise TypeError(f"{fn}: a must be the int8 copy from pack_rows, got "
                        f"{a8.dtype}")
    if a8.dim() != 3:
        raise ValueError(f"{fn}: a must be 3-D, got shape {tuple(a8.shape)}")
    bsz, t, n_pad = a8.shape
    if t < 1 or n < 1:
        raise ValueError(f"{fn}: empty row slice or columns, a has shape "
                         f"{tuple(a8.shape)}, n = {n}")
    if n_pad != -(-n // PAD) * PAD:
        raise ValueError(f"{fn}: a has {n_pad} columns; pack_rows pads "
                         f"n = {n} to {-(-n // PAD) * PAD}")
    if not a8.is_contiguous() or a8.data_ptr() % PAD:
        raise ValueError(f"{fn}: a must be contiguous and 16-byte aligned")
    return bsz, t, n_pad


def batched_gemv(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A x per lane: a the (B, T, n_pad) int8 copy from :func:`pack_rows`,
    x (B, n) float32 -> (B, T) float32."""
    cpu = on_cpu("batched_gemv", a)
    n = x.shape[-1]
    bsz, t, n_pad = check_packed("batched_gemv", a, n)
    expect("batched_gemv", "x", x, torch.float32, (bsz, n), a.device)
    if cpu:
        return gemv_ref(unpack_rows(a, n), x)
    out = torch.empty((bsz, t), dtype=torch.float32, device=a.device)
    if bsz:
        launch("batched_gemv", "ldpc_gemv_fwd", a.device, a, x, out, bsz, t,
               n, n_pad)
        _GEMV(t)
    return out


def gemv_t_launch(fn: str, a: torch.Tensor, y: torch.Tensor, n: int,
                  epilogue: tuple = (None, None, None)) -> torch.Tensor:
    """One launch of the A^T y kernel on CUDA inputs that ``fn`` checked
    (:func:`check_packed`, y (B, T) float32): A^T y, or with ``epilogue``
    (ea, eb, ec), contiguous (B, n) float32, ((-ea - A^T y) + eb) - ec, each
    operation rounded to nearest in that order. The caller keeps the
    twin."""
    bsz, t, n_pad = a.shape
    out = torch.empty((bsz, n), dtype=torch.float32, device=a.device)
    if bsz:
        rows = _chunk_rows.get(n_pad)
        if rows is None:
            rows = _chunk_rows[n_pad] = _build.load().ldpc_gemv_chunk_rows(
                n_pad)
        # the kernel splits a lane into at most twice ceil(t / rows) chunks
        part = torch.empty((bsz, 2 * -(-t // rows), n), dtype=torch.float32,
                           device=a.device)
        launch(fn, "ldpc_gemv_tr", a.device, a, y, part, out,
               _run_counts(a.device, bsz), *epilogue, bsz, t, n, n_pad)
        _GEMV_T(t)
    return out


def batched_gemv_t(a: torch.Tensor, y: torch.Tensor, n: int) -> torch.Tensor:
    """A^T y per lane: a the (B, T, n_pad) int8 copy from :func:`pack_rows`
    of a slice with ``n`` columns, y (B, T) float32 -> (B, n) float32."""
    cpu = on_cpu("batched_gemv_t", a)
    bsz, t, _ = check_packed("batched_gemv_t", a, n)
    expect("batched_gemv_t", "y", y, torch.float32, (bsz, t), a.device)
    if cpu:
        return gemv_t_ref(unpack_rows(a, n), y)
    return gemv_t_launch("batched_gemv_t", a, y, n)


def normal_build(a: torch.Tensor, d: torch.Tensor, dxx: torch.Tensor,
                 delta: float, n: int) -> torch.Tensor:
    """M = A^T diag(d) A + diag(dxx) + delta I per lane: a the (B, T, n_pad)
    int8 copy from :func:`pack_rows` of a slice with ``n`` columns, d (B, T)
    and dxx (B, n) float32 -> (B, n, n) float32, both triangles written and
    exactly symmetric."""
    cpu = on_cpu("normal_build", a)
    bsz, t, n_pad = check_packed("normal_build", a, n)
    expect("normal_build", "d", d, torch.float32, (bsz, t), a.device)
    expect("normal_build", "dxx", dxx, torch.float32, (bsz, n), a.device)
    if cpu:
        return normal_ref(unpack_rows(a, n), d, dxx, delta)
    out = torch.empty((bsz, n, n), dtype=torch.float32, device=a.device)
    if bsz:
        launch("normal_build", "ldpc_normal_build", a.device, a, d, dxx, out,
               bsz, t, n, n_pad, float(delta))
        _NORMAL(t)
    return out
