"""The one way the wrappers of ``ops/*_kernel.py`` call the kernel library
(:mod:`._build`): their device rule, their argument check, the launch, and
their launch counters.

* :func:`on_cpu`: a CPU tensor goes to the wrapper's plain twin, a CUDA
  tensor to the kernel, any other device raises; :func:`cuda_only` is the
  rule of a wrapper whose caller picks the twin (``bp_decode``,
  ``awgn_channel``).
* :func:`expect`: one argument's device, dtype, shape and contiguity.
* :func:`launch`: one entry point of the library on the device's current
  stream, the tensors passed as pointers; a CUDA error raises
  ``RuntimeError``. It makes no synchronisation, host read or allocation.
* :func:`counter`: a wrapper declares each of its launch counters once: a
  module global int and, optionally, a ``Counter`` beside it that splits
  the count by a key (a row tier, a shape). Calling the returned
  :class:`Count` counts one launch. :data:`COUNTERS` holds every declared
  counter, so :mod:`.ipm_graph` records what each captured graph launches
  (:func:`snapshot`, :func:`since`, :func:`restore`) and adds it at every
  replay, whichever wrapper declared it.
"""
from __future__ import annotations

import sys
from collections import Counter

import torch

from . import _build

__all__ = ["COUNTERS", "Count", "counter", "cuda_only", "expect", "launch",
           "on_cpu", "raise_for", "restore", "since", "snapshot"]


class Count:
    """A declared launch counter: the int global ``name`` of ``module``
    and, if ``by`` is given, its Counter global ``by``, which splits the
    count by a key. Both are read by name at every use, so a caller that
    resets the int (``module.NAME = 0``) is seen."""
    __slots__ = ("module", "name", "by", "_ns")

    def __init__(self, module: str, name: str, by: str | None = None):
        self.module, self.name, self.by = module, name, by
        self._ns = vars(sys.modules[module])
        if not isinstance(self._ns[name], int) or (
                by is not None and not isinstance(self._ns[by], Counter)):
            raise TypeError(f"{module}: {name} must be an int and {by} a "
                            f"Counter")

    def __call__(self, key=None) -> None:
        """Count one launch (under ``key`` in ``by``)."""
        ns = self._ns
        ns[self.name] += 1
        if self.by is not None:
            ns[self.by][key] += 1

    def add(self, n: int, by: Counter | None) -> None:
        self._ns[self.name] += n
        if by:
            self._ns[self.by].update(by)

    def read(self) -> tuple[int, Counter | None]:
        ns = self._ns
        return ns[self.name], None if self.by is None else Counter(ns[self.by])

    def write(self, value: tuple[int, Counter | None]) -> None:
        self._ns[self.name] = value[0]
        if self.by is not None:
            self._ns[self.by].clear()
            self._ns[self.by].update(value[1])


# every counter a wrapper module declared, in the order of declaration
COUNTERS: list[Count] = []


def counter(module: str, name: str, by: str | None = None) -> Count:
    """Declare the launch counter ``name`` (and its split ``by``) of the
    wrapper ``module`` (its ``__name__``); returns what counts a launch."""
    count = Count(module, name, by)
    COUNTERS.append(count)
    return count


def snapshot() -> list:
    """(counter, value) of every declared counter, the Counters copied."""
    return [(c, c.read()) for c in COUNTERS]


def restore(snap: list) -> None:
    for c, value in snap:
        c.write(value)


def since(snap: list) -> list:
    """What each counter of ``snap`` gained since: (counter, n, the
    Counter's gain or None), the counters that gained nothing left out."""
    out = []
    for c, (n0, by0) in snap:
        n1, by1 = c.read()
        by = None if by0 is None else by1 - by0
        if n1 != n0 or by:
            out.append((c, n1 - n0, by))
    return out


def on_cpu(fn: str, t: torch.Tensor) -> bool:
    """The device rule of a wrapper with a twin: True for a CPU tensor (the
    twin runs), False for a CUDA one (the kernel); nothing falls back."""
    kind = t.device.type
    if kind == "cpu":
        return True
    if kind != "cuda":
        raise ValueError(f"{fn}: no implementation for {t.device}")
    return False


def cuda_only(fn: str, named) -> None:
    """Refuse any (name, tensor or None) of ``named`` off CUDA."""
    for name, t in named:
        if t is not None and t.device.type != "cuda":
            raise ValueError(f"{fn}: {name} must be a CUDA tensor, got "
                             f"{t.device}")


def expect(fn: str, name: str, t: torch.Tensor, dtype: torch.dtype,
           shape: tuple, device: torch.device,
           contiguous: bool = True) -> None:
    """Refuse ``t`` unless it is a ``dtype`` tensor of ``shape`` on
    ``device``, contiguous unless ``contiguous`` is False: ``TypeError``
    for the dtype, ``ValueError`` for the rest."""
    if (t.device == device and t.dtype == dtype and t.shape == shape
            and (not contiguous or t.is_contiguous())):
        return
    if t.device != device:
        raise ValueError(f"{fn}: {name} is on {t.device}, not {device}")
    if t.dtype != dtype:
        raise TypeError(f"{fn}: {name} must be {dtype}, got {t.dtype}")
    if t.shape != shape:
        raise ValueError(f"{fn}: {name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    raise ValueError(f"{fn}: {name} must be contiguous")


def raise_for(code: int, what: str) -> None:
    """Raise ``RuntimeError`` for a non-zero CUDA error ``code`` of the
    library call ``what``."""
    if code:
        msg = _build.load().ldpc_cuda_error_string(code).decode()
        raise RuntimeError(f"{what} failed: CUDA error {code} ({msg})")


def launch(fn: str, entry: str, device: torch.device, *args) -> None:
    """Call the library's ``entry`` with ``args`` (each tensor as its data
    pointer) and the current stream of ``device``, under its device
    guard."""
    lib = _build.load()
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(device):
        code = getattr(lib, entry)(
            *ptrs, torch.cuda.current_stream(device).cuda_stream)
    if code:
        raise_for(code, f"{fn} launch")
