"""Python wrapper of the channel kernel (``csrc/awgn_channel.cu``).

No TPU kernel stands behind it: it replaces the eager PyTorch ops of the
harness's channel step (the counter-hash noise of
``channel/awgn.py``, BPSK, the LLR scaling and the hard-decision count),
about 100 launches a batch, with one. The wrapper checks its inputs,
allocates the outputs, and launches on the current CUDA stream without
synchronising. It takes CUDA tensors only: the plain PyTorch twin is
:func:`ldpc_tpu_torch.channel.awgn.channel_ref`, and
:func:`ldpc_tpu_torch.channel.awgn.channel` picks between the two by the
tensor's device.

``LAUNCHES`` counts the kernel's launches, so a run can show that its
channel went through the kernel.
"""
from __future__ import annotations

import numpy as np
import torch

from . import _build

LAUNCHES = 0

__all__ = ["awgn_channel"]


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
           contiguous: bool = True) -> None:
    if t.dtype != dtype:
        raise TypeError(f"awgn_channel: {name} must be {dtype}, got "
                        f"{t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"awgn_channel: {name} must have shape {shape}, "
                         f"got {tuple(t.shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"awgn_channel: {name} must be contiguous")


def _factor(name: str, v, b: int):
    """(tensor or None, float32 value) of a per-lane (B,) float32 tensor
    or a Python float."""
    if isinstance(v, torch.Tensor):
        _check(name, v, torch.float32, (b,))
        return v, 0.0
    return None, float(np.float32(v))


def _ptr(t):
    return None if t is None else t.data_ptr()


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
    global LAUNCHES
    if bits.dim() != 2:
        raise ValueError(f"awgn_channel: bits must be 2-D, got shape "
                         f"{tuple(bits.shape)}")
    b, n = bits.shape
    _check("bits", bits, torch.uint8, (b, n))
    _check("trial_idx", trial_idx, torch.int64, (b,), contiguous=False)
    if not 0 <= key < 2**32:
        raise ValueError(f"awgn_channel: key must be a 32-bit value, got "
                         f"{key}")
    sigma_t, sigma_f = _factor("sigma", sigma, b)
    scale_t, scale_f = _factor("scale", scale, b)
    dev = bits.device
    for name, t in (("bits", bits), ("trial_idx", trial_idx),
                    ("sigma", sigma_t), ("scale", scale_t)):
        if t is None:
            continue
        if t.device.type != "cuda":
            raise ValueError(f"awgn_channel: {name} must be a CUDA tensor, "
                             f"got {t.device}")
        if t.device != dev:
            raise ValueError(f"awgn_channel: {name} is on {t.device}, bits "
                             f"on {dev}")
    y = torch.empty((b, n), dtype=torch.float32, device=dev)
    llr = torch.empty((b, n), dtype=torch.float32, device=dev)
    hd = torch.empty((b,), dtype=torch.int64, device=dev)
    if b == 0:
        return y, llr, hd
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ldpc_awgn_channel(
            bits.data_ptr(), trial_idx.data_ptr(), trial_idx.stride(0),
            _ptr(sigma_t), _ptr(scale_t), sigma_f, scale_f, key,
            y.data_ptr(), llr.data_ptr(), hd.data_ptr(), b, n, stream)
    if err != 0:
        msg = lib.ldpc_cuda_error_string(err).decode()
        raise RuntimeError(f"awgn_channel launch failed: CUDA error {err} "
                           f"({msg})")
    LAUNCHES += 1
    return y, llr, hd
