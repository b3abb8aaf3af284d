"""BPSK-AWGN channel model on tensors (counterpart of
``ldpc_tpu/channel/awgn.py``).

Numeric conventions pinned to the reference (``utils/channel.h``):

* noise variance  sigma^2 = 10**(-snr/10) / 2, evaluated in float32 as the
  JAX package does                                   (``channel.h:12``)
* BPSK modulation bit 0 -> +1.0, bit 1 -> -1.0       (``channel.h:24``)
* LLR(y) = 2*y / sigma^2                             (``channel.h:14-16``)

Per-trial determinism: each trial's noise is a pure function of
``(seed, trial_index, bit)``, so a run's result does not depend on the batch
size, the batch order or the device. A counter-based integer hash gives two
32-bit uniforms per pair of bits, and Box-Muller (evaluated in float64, then
rounded to float32) turns them into two normals. Only exact integer tensor
ops feed the float64 step, so the CPU and a CUDA device draw the same bits of
randomness. (The stream is not JAX's threefry and need not be.)

On a CUDA tensor the channel step is one launch a batch of the hand-written
kernel ``csrc/awgn_channel.cu`` (:func:`channel`: y, the LLRs and the
hard-decision count together), bit for bit with the plain ops here
(:func:`channel_ref`), which every function runs on a CPU tensor.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.channel_kernel import awgn_channel

__all__ = ["llr_variance", "llr", "bpsk", "awgn_noise", "noise_key",
           "noise_scales", "snr_table", "hard_errors", "channel_ref",
           "channel", "transmit", "channel_llr", "gen_random_codewords"]

_M32 = 0xFFFFFFFF


def llr_variance(snr: float) -> float:
    """Noise variance for the repo's SNR convention, rounded as float32."""
    var = np.float32(10.0) ** np.float32(-(snr / 10.0)) / np.float32(2.0)
    return float(var)


def llr(y: torch.Tensor, snr: float) -> torch.Tensor:
    """Channel LLR of received symbol(s)."""
    return 2.0 * y / llr_variance(snr)


def bpsk(bits: torch.Tensor) -> torch.Tensor:
    """Map bits {0,1} -> symbols {+1,-1} (float32)."""
    return 1.0 - 2.0 * bits.to(torch.float32)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for int64 ``x`` in [0, 2**32): the constant is
    split in 16-bit halves so no int64 product overflows."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A bijective 32-bit finalizer with full avalanche (Wellons'
    ``lowbias32``) on int64 tensors, or Python ints, holding 32-bit
    values."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def awgn_noise(seed: int, trial_idx: torch.Tensor, n: int) -> torch.Tensor:
    """Standard normal noise (B, n) float32, a pure function of
    ``(seed, trial_idx[b], bit)``, on ``trial_idx``'s device."""
    dev = trial_idx.device
    # a fill, not a host-to-device copy: a copy would wait for the stream
    key = _mix32(torch.full((1, 1), (int(seed) & _M32) ^ 0x9E3779B9,
                            dtype=torch.int64, device=dev))
    t = trial_idx.to(torch.int64)[:, None] & _M32
    lane = _mix32(key ^ t)                                    # (B, 1)
    pairs = (n + 1) // 2
    ctr = torch.arange(2 * pairs, dtype=torch.int64, device=dev)[None, :]
    h = _mix32((_mix32(lane ^ ctr) + t) & _M32)               # (B, 2*pairs)
    u = h.to(torch.float64)
    u1 = (u[:, 0::2] + 1.0) * 2.0 ** -32                      # (0, 1]
    theta = (2.0 * math.pi * 2.0 ** -32) * u[:, 1::2]         # [0, 2pi)
    r = torch.sqrt(-2.0 * torch.log(u1))
    z = torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1)
    return z.reshape(z.shape[0], 2 * pairs)[:, :n].to(torch.float32)


def noise_key(seed: int) -> int:
    """The 32-bit key of ``seed``'s noise as :func:`awgn_noise` takes it,
    on the host (:func:`_mix32` on a Python int): the channel kernel's
    argument."""
    return _mix32((int(seed) & _M32) ^ 0x9E3779B9)


def noise_scales(snr: float) -> tuple[float, float]:
    """(sigma, 2 / sigma^2) of one SNR as Python floats. Both round to
    float32 where they multiply a float32 tensor, so :func:`transmit` and
    :func:`snr_table`'s per-lane factors give the same bits."""
    var = llr_variance(snr)
    return math.sqrt(var), 2.0 / var


def snr_table(snrs, device: torch.device | str):
    """Per-SNR noise scales for lanes at different SNRs in one batch:
    ((S,) sigma, (S,) 2 / sigma^2) float32 tensors on ``device``, built on
    the host from :func:`noise_scales` and indexed by each lane's SNR id."""
    scales = np.asarray([noise_scales(float(s)) for s in snrs], np.float32)
    table = torch.from_numpy(scales.reshape(-1, 2)).to(device)
    return table[:, 0].contiguous(), table[:, 1].contiguous()


def hard_errors(bits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(..., B) int64 channel hard-decision errors of codewords ``bits``
    received as ``y``: y <= 0 for bit 0, y > 0 otherwise
    (``experiment.h:33-46``)."""
    return torch.where(bits == 0, y <= 0, y > 0).sum(dim=-1)


def _lanes(v):
    """A per-lane (B,) factor as a column against (B, n); a float as is."""
    return v[:, None] if isinstance(v, torch.Tensor) else v


def _received(bits, sigma, seed, trial_idx):
    return bpsk(bits) + _lanes(sigma) * awgn_noise(seed, trial_idx,
                                                    bits.shape[-1])


def channel_ref(bits: torch.Tensor, trial_idx: torch.Tensor, seed: int,
                sigma, scale):
    """The channel step as plain tensor ops, on any device: (y, scale * y,
    :func:`hard_errors`) of codewords ``bits`` (..., B, n), trial ``b``'s
    noise keyed by ``(seed, trial_idx[b])`` and shared over the leading
    dimensions. ``sigma`` and ``scale``: Python floats or (B,) float32
    tensors (rows of :func:`snr_table`)."""
    y = _received(bits, sigma, seed, trial_idx)
    return y, _lanes(scale) * y, hard_errors(bits, y)


def channel(bits: torch.Tensor, trial_idx: torch.Tensor, seed: int, sigma,
            scale):
    """:func:`channel_ref`'s (y, llr, hard-decision errors), bit for bit:
    on a CUDA tensor one launch of the channel kernel
    (``ops/channel_kernel.py``), on a CPU tensor :func:`channel_ref`.
    Leading dimensions of ``bits`` are lanes of the kernel's batch with
    ``trial_idx`` repeated over them."""
    if bits.device.type != "cuda":
        return channel_ref(bits, trial_idx, seed, sigma, scale)
    n = bits.shape[-1]
    rows = bits.reshape(-1, n).contiguous()
    trials = trial_idx.to(torch.int64)
    reps = rows.shape[0] // max(trials.shape[0], 1)
    if reps > 1:
        trials = trials.repeat(reps)
    y, lam, hd = awgn_channel(rows, trials, noise_key(seed), sigma, scale)
    return y.view(bits.shape), lam.view(bits.shape), hd.view(bits.shape[:-1])


def transmit(bits: torch.Tensor, snr: float, seed: int,
             trial_idx: torch.Tensor) -> torch.Tensor:
    """Send codewords ``bits`` (B, n) over BPSK-AWGN; trial ``b``'s noise is
    keyed by ``(seed, trial_idx[b])``. Returns received symbols (B, n) f32."""
    return channel(bits, trial_idx, seed, *noise_scales(snr))[0]


def channel_llr(bits: torch.Tensor, snr: float, seed: int,
                trial_idx: torch.Tensor):
    """Transmit and convert to LLRs in one step; returns (y, llr) with the
    LLRs of :func:`llr`. PyTorch's CUDA division by a Python float
    multiplies by its float32 reciprocal, so ``2 y / var`` there is ``y``
    times ``2 fl(1 / var)``, exactly, and the channel's own LLRs are kept;
    the CPU divides."""
    inv = np.float32(1.0) / np.float32(llr_variance(snr))
    y, lam, _ = channel(bits, trial_idx, seed, noise_scales(snr)[0],
                        2.0 * float(inv))
    return y, (lam if bits.device.type == "cuda" else llr(y, snr))


def gen_random_codewords(g: np.ndarray, num: int,
                         generator: torch.Generator,
                         device: torch.device | str) -> torch.Tensor:
    """Sample ``num`` codewords as random GF(2) combinations of G's rows
    (``gen_random_codeword``, ``channel.h:28-36``).

    The coefficients come from ``generator`` (on its own device) and the
    product runs on ``device`` in float32, exact for 0/1 values. Returns
    (num, n) uint8 on ``device``.
    """
    g_t = torch.as_tensor(np.asarray(g, np.float32), device=device)
    coeffs = torch.randint(0, 2, (num, g_t.shape[0]), generator=generator,
                           device=generator.device, dtype=torch.float32)
    prod = coeffs.to(device) @ g_t
    return prod.remainder(2.0).to(torch.uint8)
