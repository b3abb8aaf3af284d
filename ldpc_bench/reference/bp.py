"""Flooding sum-product BP with early exit, the reference decoder's
``algo/bp.h`` in plain PyTorch.

check -> variable: ``sgn * phi(sum phi(|v2c|))`` over the row without the
edge itself, ``phi(x) = -log(tanh(x / 2))`` with x clamped to [1e-9, 31];
``v2c <= 0`` counts as negative. Posterior ``llr + sum c2v``, variable ->
check ``posterior - c2v``, hard decision ``posterior <= 0 -> 1``. Each lane
stops at its first iteration whose hard decision satisfies every check; a
lane that never does reports ``max_iter`` iterations and no success.
Messages sit on padded edge slots (rows (m, dc), columns (n, dv)); row and
column sums run in slot order. Float32; ``control`` runs it in bfloat16.
"""
from __future__ import annotations

import numpy as np
import torch

PAD_LLR = 64.0          # a pad slot's message: phi() is 0, sign +


def prepare(h: np.ndarray, cfg: dict, device) -> dict:
    """Padded edge tables of H on ``device``."""
    h = np.asarray(h, dtype=np.uint8) % 2
    m, n = h.shape
    dc = int(h.sum(axis=1).max())
    dv = int(h.sum(axis=0).max())
    row_col = np.full((m, dc), n, dtype=np.int64)
    row_from_col = np.full((m, dc), n * dv, dtype=np.int64)
    col_from_row = np.full((n, dv), m * dc, dtype=np.int64)
    fill = np.zeros(n, dtype=np.int64)
    for i in range(m):
        for s, j in enumerate(np.nonzero(h[i])[0]):
            row_col[i, s] = j
            row_from_col[i, s] = j * dv + fill[j]
            col_from_row[j, fill[j]] = i * dc + s
            fill[j] += 1
    t = {"row_col": row_col, "row_from_col": row_from_col,
         "col_from_row": col_from_row, "row_mask": row_col < n,
         "col_mask": col_from_row < m * dc}
    out = {k: torch.from_numpy(v).to(device) for k, v in t.items()}
    out.update(m=m, n=n, dc=dc, dv=dv, max_iter=int(cfg["bp_max_iter"]))
    if cfg.get("bp_variant", "sumprod") != "sumprod":
        raise ValueError("the reference decodes sum-product BP only")
    return out


def _slot_sum(x: torch.Tensor) -> torch.Tensor:
    s = x[..., 0]
    for k in range(1, x.shape[-1]):
        s = s + x[..., k]
    return s


def _phi(x: torch.Tensor) -> torch.Tensor:
    return -torch.log(torch.tanh(0.5 * x.clamp(1e-9, 31.0)))


def decode(t: dict, llr: torch.Tensor, control: bool = False) -> dict:
    """Decode (B, n) LLRs; returns bits (B, n) uint8, success (B,) bool,
    iterations (B,) int32, dropped None."""
    dt = torch.bfloat16 if control else torch.float32
    b, n = llr.shape
    m, dc, dv = t["m"], t["dc"], t["dv"]
    row_mask, col_mask = t["row_mask"], t["col_mask"]
    llr = llr.to(dt)
    one, zero = torch.ones((), dtype=dt, device=llr.device), \
        torch.zeros((), dtype=dt, device=llr.device)

    def gather(x, fill, index, shape):
        flat = torch.cat([x.flatten(1), x.new_full((b, 1), fill)], dim=1)
        return flat[:, index.reshape(-1)].reshape(b, *shape)

    def check_update(v2c):
        neg = (v2c <= 0) & row_mask
        sign_e = torch.where(neg, -one, one)
        parity = neg.sum(dim=-1, keepdim=True) % 2
        sign_tot = torch.where(parity == 1, -one, one)
        mag = torch.where(row_mask, _phi(v2c.abs()), zero)
        out = _phi(_slot_sum(mag)[..., None] - mag)
        return torch.where(row_mask, sign_tot * sign_e * out, zero)

    v2c = torch.where(row_mask, gather(llr, PAD_LLR, t["row_col"], (m, dc)),
                      torch.full((), PAD_LLR, dtype=dt, device=llr.device))
    bits = (llr <= 0).to(torch.uint8)
    done = torch.zeros(b, dtype=torch.bool, device=llr.device)
    iters = torch.full((b,), t["max_iter"], dtype=torch.int32,
                       device=llr.device)
    for it in range(t["max_iter"]):
        c2v = gather(check_update(v2c), 0.0, t["col_from_row"], (n, dv))
        total = llr + _slot_sum(torch.where(col_mask, c2v, zero))
        v2c_col = torch.where(col_mask, total[:, :, None] - c2v,
                              torch.full((), PAD_LLR, dtype=dt,
                                         device=llr.device))
        v2c = gather(v2c_col, PAD_LLR, t["row_from_col"], (m, dc))
        hard = (total <= 0).to(torch.uint8)
        ok = (gather(hard, 0, t["row_col"], (m, dc)).sum(dim=-1) % 2
              == 0).all(dim=-1)
        iters = iters.masked_fill(ok & ~done, it + 1)
        bits = torch.where(done[:, None], bits, hard)
        done = done | ok
        if bool(done.all()):
            break
    return {"bits": bits, "success": done, "iterations": iters,
            "dropped": None}


def lanes_differ(prog: dict, ref: dict) -> dict:
    """Per-lane disagreements: ``lanes_differ`` marks a lane whose bits,
    success or iterations differ (BP's lanes are exact integers)."""
    bits = (prog["bits"] != ref["bits"]).any(dim=-1)
    other = ((prog["success"].bool() != ref["success"].bool())
             | (prog["iterations"].to(torch.int64)
                != ref["iterations"].to(torch.int64)))
    return {"lanes_differ": bits | other}
