"""BPSK-AWGN channel with counter-hash noise, worked out again.

The channel the configurations state: noise variance
``sigma^2 = 10**(-snr/10) / 2`` rounded to float32, bit 0 -> +1 and
bit 1 -> -1, LLR ``2 y / sigma^2``; each trial's noise a pure function of
``(seed, trial, bit)``: a 32-bit counter hash (Wellons' ``lowbias32``) gives
two uniforms per pair of bits and Box-Muller in float64 turns them into two
normals, rounded to float32. ``control`` runs Box-Muller in float32.
"""
from __future__ import annotations

import math

import numpy as np
import torch

_M32 = 0xFFFFFFFF


def scales(snr: float) -> tuple[float, float]:
    """(sigma, 2 / sigma^2) of one SNR, the variance rounded to float32."""
    var = float(np.float32(10.0) ** np.float32(-(snr / 10.0))
                / np.float32(2.0))
    return math.sqrt(var), 2.0 / var


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def normals(seed: int, trials: torch.Tensor, n: int,
            control: bool = False) -> torch.Tensor:
    """(B, n) float32 standard normals of trials ``trials`` (B,) int64."""
    dev = trials.device
    key = _mix32(torch.full((1, 1), (int(seed) & _M32) ^ 0x9E3779B9,
                            dtype=torch.int64, device=dev))
    t = trials.to(torch.int64)[:, None] & _M32
    lane = _mix32(key ^ t)
    pairs = (n + 1) // 2
    ctr = torch.arange(2 * pairs, dtype=torch.int64, device=dev)[None, :]
    u = _mix32((_mix32(lane ^ ctr) + t) & _M32)
    u = u.to(torch.float32 if control else torch.float64)
    u1 = (u[:, 0::2] + 1.0) * 2.0 ** -32
    theta = (2.0 * math.pi * 2.0 ** -32) * u[:, 1::2]
    r = torch.sqrt(-2.0 * torch.log(u1))
    z = torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1)
    return z.reshape(z.shape[0], 2 * pairs)[:, :n].to(torch.float32)


def received(bits: torch.Tensor, snr: float, seed: int,
             trials: torch.Tensor, control: bool = False) -> torch.Tensor:
    """Received symbols y (B, n) float32 of codewords ``bits`` (B, n)."""
    sigma = scales(snr)[0]
    symbols = 1.0 - 2.0 * bits.to(torch.float32)
    return symbols + sigma * normals(seed, trials, bits.shape[-1], control)


def llrs(y: torch.Tensor, snr: float) -> torch.Tensor:
    """Channel LLRs of received symbols."""
    return scales(snr)[1] * y
