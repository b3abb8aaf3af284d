"""Python wrapper of the channel kernel (``csrc/awgn_channel.cu``).

No TPU kernel stands behind it: it replaces the eager PyTorch ops of the
harness's channel step (the counter-hash noise of
``channel/awgn.py``, BPSK, the LLR scaling and the hard-decision count),
about 100 launches a batch, with one. The wrapper checks its inputs,
allocates the outputs, and launches (:func:`._launch.launch`) on the
current CUDA stream without synchronising. It takes CUDA tensors only and
refuses a CPU tensor (:func:`._launch.cuda_only`) instead of running a
twin: the plain PyTorch twin,
:func:`ldpc_tpu_torch.channel.awgn.channel_ref`, lives beside the noise it
reproduces in ``channel/awgn.py``, and
:func:`ldpc_tpu_torch.channel.awgn.channel` picks between the two by the
tensor's device.

``LAUNCHES`` counts the kernel's launches, so a run can show that its
channel went through the kernel.
"""
from __future__ import annotations

import numpy as np
import torch

from ._launch import counter, cuda_only, expect, launch

LAUNCHES = 0
_COUNT = counter(__name__, "LAUNCHES")

__all__ = ["awgn_channel"]


def _factor(name: str, v, b: int, dev: torch.device):
    """(tensor or None, float32 value) of a per-lane (B,) float32 tensor
    or a Python float."""
    if isinstance(v, torch.Tensor):
        expect("awgn_channel", name, v, torch.float32, (b,), dev)
        return v, 0.0
    return None, float(np.float32(v))


def awgn_channel(bits: torch.Tensor, trial_idx: torch.Tensor, key: int,
                 sigma, scale):
    """The channel step of one batch in one launch.

    ``bits`` (B, n) uint8, contiguous; ``trial_idx`` (B,) int64, any
    stride; ``sigma`` and ``scale`` Python floats (rounded to float32) or
    (B,) float32 tensors, one factor a lane; all on one CUDA device;
    ``key`` the 32-bit key of the noise's seed
    (``channel/awgn.py`` ``noise_key``). Returns ``(y (B, n) float32,
    llr (B, n) float32, hd (B,) int64)``: the received symbols
    ``(1 - 2 bit) + sigma z`` with trial ``b``'s noise keyed by
    ``(key, trial_idx[b])``, ``scale * y``, and each lane's channel
    hard-decision errors (y <= 0 for bit 0, y > 0 otherwise).
    """
    if bits.dim() != 2:
        raise ValueError(f"awgn_channel: bits must be 2-D, got shape "
                         f"{tuple(bits.shape)}")
    (b, n), dev = bits.shape, bits.device
    expect("awgn_channel", "bits", bits, torch.uint8, (b, n), dev)
    expect("awgn_channel", "trial_idx", trial_idx, torch.int64, (b,), dev,
           contiguous=False)
    if not 0 <= key < 2**32:
        raise ValueError(f"awgn_channel: key must be a 32-bit value, got "
                         f"{key}")
    sigma_t, sigma_f = _factor("sigma", sigma, b, dev)
    scale_t, scale_f = _factor("scale", scale, b, dev)
    cuda_only("awgn_channel", (("bits", bits), ("trial_idx", trial_idx),
                               ("sigma", sigma_t), ("scale", scale_t)))
    y = torch.empty((b, n), dtype=torch.float32, device=dev)
    llr = torch.empty((b, n), dtype=torch.float32, device=dev)
    hd = torch.empty((b,), dtype=torch.int64, device=dev)
    if b:
        launch("awgn_channel", "ldpc_awgn_channel", dev, bits, trial_idx,
               trial_idx.stride(0), sigma_t, scale_t, sigma_f, scale_f, key,
               y, llr, hd, b, n)
        _COUNT()
    return y, llr, hd
