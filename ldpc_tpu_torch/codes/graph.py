"""Static Tanner-graph structure of H as padded index tables (host side).

Counterpart of ``ldpc_tpu/codes/graph.py``, with the same tables and
sentinels, so either package's tables drive either package's decoder:

* **row layout** ``(m, dc_max)``: ``row_col`` holds each check row's columns
  in ascending order, padded with ``n``; ``row_mask`` marks real slots.
* **col layout** ``(n, dv_max)``: ``col_row`` holds each column's check rows,
  padded with ``m``; ``col_mask`` marks real slots.
* **cross-layout flat permutations**: ``row_from_col`` indexes the flattened
  col layout (pad == ``n * dv_max``, a sentinel slot callers append) and
  ``col_from_row`` the flattened row layout (pad == ``m * dc_max``).
"""
from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np

__all__ = ["CodeGraph"]


@dataclass(frozen=True)
class CodeGraph:
    """Padded, static edge structure of a parity-check matrix H."""

    h: np.ndarray                 # (m, n) uint8
    m: int
    n: int
    n_edges: int
    dc_max: int                   # max check (row) degree
    dv_max: int                   # max variable (column) degree
    row_col: np.ndarray           # (m, dc_max) int32; == n for pad
    row_mask: np.ndarray          # (m, dc_max) bool
    row_deg: np.ndarray           # (m,) int32
    col_row: np.ndarray           # (n, dv_max) int32; == m for pad
    col_mask: np.ndarray          # (n, dv_max) bool
    col_deg: np.ndarray           # (n,) int32
    row_from_col: np.ndarray      # (m, dc_max) int32 into flat col layout
    col_from_row: np.ndarray      # (n, dv_max) int32 into flat row layout

    @staticmethod
    def from_h(h: np.ndarray) -> "CodeGraph":
        h = np.asarray(h, dtype=np.uint8) % 2
        m, n = h.shape
        row_deg = h.sum(axis=1).astype(np.int32)
        col_deg = h.sum(axis=0).astype(np.int32)
        dc_max = max(int(row_deg.max()), 1)
        dv_max = max(int(col_deg.max()), 1)

        row_col = np.full((m, dc_max), n, dtype=np.int32)
        row_mask = np.zeros((m, dc_max), dtype=bool)
        col_row = np.full((n, dv_max), m, dtype=np.int32)
        col_mask = np.zeros((n, dv_max), dtype=bool)
        row_from_col = np.full((m, dc_max), n * dv_max, dtype=np.int32)
        col_from_row = np.full((n, dv_max), m * dc_max, dtype=np.int32)
        col_fill = np.zeros(n, dtype=np.int64)
        for i in range(m):
            for s, j in enumerate(np.nonzero(h[i])[0]):
                t = col_fill[j]
                col_fill[j] += 1
                row_col[i, s] = j
                row_mask[i, s] = True
                col_row[j, t] = i
                col_mask[j, t] = True
                row_from_col[i, s] = j * dv_max + t
                col_from_row[j, t] = i * dc_max + s

        return CodeGraph(
            h=h, m=m, n=n, n_edges=int(row_deg.sum()),
            dc_max=dc_max, dv_max=dv_max,
            row_col=row_col, row_mask=row_mask, row_deg=row_deg,
            col_row=col_row, col_mask=col_mask, col_deg=col_deg,
            row_from_col=row_from_col, col_from_row=col_from_row,
        )

    @staticmethod
    def from_arrays(arrays: dict) -> "CodeGraph":
        """Build from a mapping of field name -> value (e.g. the ``__dict__``
        of the JAX package's ``CodeGraph``), checking every table's shape.
        Extra keys are ignored."""
        kw = {}
        for f in fields(CodeGraph):
            v = arrays[f.name]
            kw[f.name] = int(v) if f.type == "int" else np.asarray(v).copy()
        g = CodeGraph(**kw)
        m, n, dc, dv = g.m, g.n, g.dc_max, g.dv_max
        want = {"h": (m, n), "row_col": (m, dc), "row_mask": (m, dc),
                "row_deg": (m,), "col_row": (n, dv), "col_mask": (n, dv),
                "col_deg": (n,), "row_from_col": (m, dc),
                "col_from_row": (n, dv)}
        for name, shape in want.items():
            if getattr(g, name).shape != shape:
                raise ValueError(f"{name} has shape {getattr(g, name).shape},"
                                 f" expected {shape}")
        return g
