"""Python wrapper of the GF(2) elimination kernel (``csrc/gf2_gauss.cu``).

Replaces ``ldpc_tpu/ops/pallas/gauss_kernel.py`` (``_kernel``, called by
``gf2_eliminate_pallas``). :func:`gf2_eliminate` picks by the device of
``h_perm`` (:func:`._launch.on_cpu`): a CPU tensor goes to the plain twin
:func:`..ops.gauss_ref.gf2_eliminate_ref`, a CUDA tensor to the kernel. On
CUDA the wrapper checks its inputs, takes the launch layout from
:func:`gauss_plan` (which raises ``ValueError`` for a shape no layout
takes: there is no fallback to the twin for a large code, unlike the TPU's
``gauss_fits_vmem``), allocates the output and launches
(:func:`._launch.launch`) on the current stream without synchronising. The
kernel recomputes the plan and refuses a launch whose plan differs from its
own.

``LAUNCHES`` counts the kernel's launches, so a run can show that its main
path went through the kernel.
"""
from __future__ import annotations

import torch

from ._launch import counter, expect, launch, on_cpu
from .gauss_ref import gf2_eliminate_ref

LAUNCHES = 0
_COUNT = counter(__name__, "LAUNCHES")
MAX_ROWS = 768          # 24 words of row bits per column, in registers
WORD_BUCKETS = (1, 2, 3, 4, 5, 6, 7, 8, 12, 16, 20, 24)

__all__ = ["gauss_plan", "gf2_eliminate", "lane_words", "max_threads"]


def max_threads(words: int) -> int:
    """Threads per block at ``words`` words per column (``max_threads`` of
    the source): a thread's registers hold up to 12 words at 1024 threads,
    16 at 768 and 24 at 640."""
    return 1024 if words <= 12 else 768 if words <= 16 else 640


def lane_words(words: int, m: int, threads: int) -> int:
    """Shared 32-bit words per lane (``lane_words`` of the source): the
    count of published columns and the rank (and two words of padding), P
    (``words`` padded to a multiple of 4), each column's pivot row, each
    row's output row (m padded to a multiple of 4) and each pivot's elim."""
    padded = -(-words // 4) * 4
    return 4 + padded + threads + -(-m // 4) * 4 + m * padded


def gauss_plan(m: int, n: int) -> dict:
    """The kernel's launch layout for (m, n) lanes, as ``csrc/gf2_gauss.cu``
    computes it: one block per lane of one thread per column
    (``threads_per_lane``, n rounded up to a warp), ``words`` 32-bit words
    of row bits per column in registers (ceil(m / 32) rounded up to a
    bucket of ``WORD_BUCKETS``) and the shared bytes of a block
    (:func:`lane_words`). Raises ``ValueError`` for a shape no
    layout takes: m or n below 1, m above ``MAX_ROWS``, n above
    :func:`max_threads` (1024 up to 384 rows, 768 up to 512, 640 above)."""
    if m < 1 or n < 1:
        raise ValueError(f"gauss_plan: empty matrix {m}x{n}")
    words = next((w for w in WORD_BUCKETS if 32 * w >= m), None)
    if words is None or n > max_threads(words):
        raise ValueError(f"gauss_plan: a {m}x{n} lane does not fit the "
                         f"kernel (at most {MAX_ROWS} rows, their bits in "
                         f"registers, and one thread per column: "
                         f"{max_threads(12)} columns up to 384 rows, "
                         f"{max_threads(16)} up to 512, {max_threads(24)} "
                         f"above)")
    threads = -(-n // 32) * 32
    return {"threads_per_lane": threads, "words": words,
            "smem_bytes": lane_words(words, m, threads) * 4}


def gf2_eliminate(h_perm: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """Row-reduce each active lane's (m, n) 0/1 matrix in left-to-right
    column order; inactive lanes come back unreduced. h_perm (B, m, n)
    uint8, contiguous; active (B,) bool. Returns (B, m, n) uint8,
    bit-identical to ``gf2_eliminate_ordered`` on active lanes."""
    if on_cpu("gf2_eliminate", h_perm):
        return gf2_eliminate_ref(h_perm, active)
    if h_perm.dim() != 3 or min(h_perm.shape[1:]) < 1:
        raise ValueError(f"gf2_eliminate: h_perm must be (B, m, n), got "
                         f"{tuple(h_perm.shape)}")
    (bsz, m, n), dev = h_perm.shape, h_perm.device
    expect("gf2_eliminate", "h_perm", h_perm, torch.uint8, h_perm.shape, dev)
    expect("gf2_eliminate", "active", active, torch.bool, (bsz,), dev)
    plan = gauss_plan(m, n)
    out = torch.empty_like(h_perm)
    if bsz:
        launch("gf2_eliminate", "ldpc_gf2_gauss", dev, h_perm, active, out,
               bsz, m, n, plan["threads_per_lane"], plan["words"],
               plan["smem_bytes"])
        _COUNT()
    return out
