"""Trial sharding over the ranks of a ``torch.distributed`` world
(counterpart of ``ldpc_tpu/parallel/mesh.py``).

The JAX package shards the trial axis of one global program over a device
mesh and lets XLA turn the counter sums into ``psum`` collectives. Here each
rank is a process with one device: the runners split whole units of work
(batches, trial ranges, candidates) over the ranks, every rank runs its
share as it would alone, and the int64 counters are summed with one
``all_reduce`` at the end.

Only ``all_reduce`` and ``broadcast`` are used: they are the two collectives
that ``gloo`` supports on CUDA tensors, and ``gloo`` is how several ranks
share one card (NCCL refuses that). A gather is an ``all_reduce(SUM)`` of a
zero-filled vector in which each rank fills its own slots.

One process per device keeps the kernels' wrappers sound: each launches
under ``torch.cuda.device(tensor.device)`` on that device's current stream,
and per-device state in the CUDA sources (``pdhg_chunk.cu``'s cached
shared-memory limit, each ``cudaFuncSetAttribute``) applies to the device
current in the process that set it.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..decoders.base import resolve_device

__all__ = ["TrialSharding", "make_trial_mesh"]


@dataclass(frozen=True)
class TrialSharding:
    """This rank's place in a sharded run: ``rank`` of ``world_size`` in
    ``group`` (None when the mesh is this process alone, whose collectives
    are identities), on ``device``, over ``backend``."""

    rank: int
    world_size: int
    device: torch.device
    group: object = None
    backend: str | None = None
    axis_name: str = "trials"

    @property
    def num_devices(self) -> int:
        return self.world_size

    def strided(self, items: list) -> list:
        """This rank's items of ``items``: ``r, r + W, r + 2W, ...``."""
        return items[self.rank::self.world_size]

    def span(self, count: int) -> tuple[int, int]:
        """This rank's contiguous ``[start, stop)`` of ``count`` units, the
        remainder spread over the first ranks."""
        return (self.rank * count // self.world_size,
                (self.rank + 1) * count // self.world_size)

    def all_sum(self, counters: torch.Tensor) -> torch.Tensor:
        """Sums an int64 tensor over the ranks, in place; returns it."""
        if self.group is not None:
            dist.all_reduce(counters, group=self.group)
        return counters

    def all_max(self, value: float) -> float:
        """The largest of every rank's ``value``."""
        if self.group is None:
            return value
        t = torch.tensor([value], dtype=torch.float64, device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return float(t)

    def barrier(self) -> None:
        """Returns once every rank has reached it and this rank's device has
        finished its queued work."""
        self.all_sum(torch.zeros(1, dtype=torch.int64, device=self.device))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def make_trial_mesh(group: list[int] | None = None,
                    axis_name: str = "trials",
                    device: torch.device | str = "cuda"
                    ) -> TrialSharding | None:
    """The sharding of the ranks in ``group`` (default: the whole world, or
    this process alone when no process group exists). ``group=[0]`` is the
    one-device mesh of rank 0; a rank outside ``group`` gets None. On the
    card, ``device`` is the one :func:`..distributed.initialize_distributed`
    bound."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if not dist.is_initialized():
        if group not in (None, [0]):
            raise ValueError(f"group {group} without a process group")
        return TrialSharding(0, 1, device, axis_name=axis_name)
    world = dist.get_world_size()
    ranks = list(range(world)) if group is None else sorted(set(group))
    me = dist.get_rank()
    if ranks == list(range(world)):
        pg = dist.group.WORLD
    elif len(ranks) == 1:
        pg = None
    else:                     # every rank of the world enters new_group
        pg = dist.new_group(ranks)
    if me not in ranks:
        return None
    return TrialSharding(ranks.index(me), len(ranks), device, pg,
                         dist.get_backend(pg) if pg is not None else None,
                         axis_name)
