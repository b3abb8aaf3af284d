"""Multi-process runtime initialisation (counterpart of
``ldpc_tpu/parallel/distributed.py``).

One process per device, joined by ``torch.distributed``. ``torchrun``
(``python -m torch.distributed.run --nproc-per-node N ...``) starts the
processes and sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and
``MASTER_ADDR``/``MASTER_PORT``, as the TPU environment's cluster discovery
does for ``jax.distributed``; explicit arguments serve processes started
another way (the CPU tests spawn theirs).

Nothing falls back: a rank asked to run on the card that finds none raises,
a failed ``init_process_group`` raises, and the backend is never switched
behind the caller's back. NCCL refuses two ranks on one GPU; ``gloo`` (which
reduces CUDA tensors through the host) is the backend that lets several
ranks share one card.
"""
from __future__ import annotations

import os
from datetime import timedelta

import torch
import torch.distributed as dist

from ..decoders.base import resolve_device

__all__ = ["initialize_distributed", "is_multi_host", "process_count",
           "process_index", "shutdown"]

_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR")


def initialize_distributed(init_method: str | None = None,
                           world_size: int | None = None,
                           rank: int | None = None,
                           backend: str | None = None,
                           device: torch.device | str = "cuda",
                           timeout: timedelta = timedelta(minutes=5)
                           ) -> None:
    """Join this process to the world when running multi-process.

    A no-op when ``world_size <= 1``, when neither explicit arguments nor
    torchrun's environment are present, or when the default group already
    exists. Otherwise each rank on the card binds
    ``cuda:{LOCAL_RANK % device_count}`` before its first CUDA call, then
    ``init_process_group`` runs with ``backend`` (default ``nccl`` on the
    card, ``gloo`` on the CPU) and a first ``all_reduce`` proves that every
    rank of the world joined.
    """
    if world_size is not None and world_size <= 1:
        return
    explicit = init_method is not None
    if not (explicit or any(v in os.environ for v in _ENV)):
        return
    if dist.is_initialized():
        return
    if explicit and (world_size is None or rank is None):
        raise ValueError("an explicit init_method needs world_size and rank")
    device = resolve_device(device)
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank if explicit else 0))
        device = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    kwargs = dict(backend=backend, init_method=init_method or "env://",
                  timeout=timeout)
    if explicit:
        kwargs.update(world_size=world_size, rank=rank)
    if backend == "nccl":
        kwargs["device_id"] = device       # create the communicator now
    dist.init_process_group(**kwargs)
    joined = torch.ones(1, dtype=torch.int64, device=device)
    dist.all_reduce(joined)
    if int(joined) != dist.get_world_size():
        raise RuntimeError(f"{int(joined)} ranks answered in a world of "
                           f"{dist.get_world_size()}")


def is_multi_host() -> bool:
    """True when the world has more than one process."""
    return process_count() > 1


def process_index() -> int:
    """This process's rank (0 when single-process)."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The world size (1 when single-process)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def shutdown() -> None:
    """Destroy the default group, if one exists."""
    if dist.is_initialized():
        dist.destroy_process_group()
