"""CUDA graphs for the IPM solve (:func:`.ipm_solver.ipm_box_lp`), and the
launch counters under replay.

JAX runs ``ipm_box_lp`` as one compiled program: a ``fori_loop`` of
``lax.cond`` chunks that reads nothing back. The port captures each part of
a solve that reads nothing back (its start, a chunk boundary, a chunk of
Newton steps, the certificate) once per solve shape as a
``torch.cuda.CUDAGraph`` and replays it; the host still reads the chunk
boundary's flag. :func:`capture` runs every part once on a side stream
(the warm-up: lazy library set-up and the matvecs' per-stream scratch
happen there, outside any capture), then captures each part on that stream
into one memory pool per device, shared by every graph: replays are serial
and every tensor a part allocates is dead when it ends, so the pool holds
scratch only. A capture that fails raises with its cause.

The hand-written kernels' wrappers count a launch on the host, where they
launch, so a replay would count nothing. :func:`capture` records what each
graph's capture added to every counter a wrapper declared
(:func:`._launch.counter`; the warm-up and the captures themselves are left
out) and :func:`replay` adds it, so the counters after a graph solve equal
the eager solve's, a new wrapper's included. Beside them this module counts
``REPLAYS``, ``CALLS`` (the hand-written kernel launches the replays made)
and ``NODES`` (the device operations the replays ran: the kernel, copy and
memset nodes of each graph, read from libcuda after capture), so a
caller can tell the host's launches from the device's.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from . import _launch

__all__ = ["CAPTURES", "CALLS", "NODES", "REPLAYS", "Captured", "capture",
           "replay"]

CAPTURES = 0
REPLAYS = 0
CALLS = 0
NODES = 0

# cuGraphNodeType: CU_GRAPH_NODE_TYPE_KERNEL, _MEMCPY, _MEMSET
_DEVICE_NODES = (0, 1, 2)

_pools: dict[int, tuple] = {}
_streams: dict[int, torch.cuda.Stream] = {}
_libcuda = None


def _device_nodes(raw: int) -> int:
    """The kernel, copy and memset nodes of a cudaGraph_t (libcuda's
    cuGraphGetNodes and cuGraphNodeGetType)."""
    global _libcuda
    if _libcuda is None:
        lib = ctypes.CDLL("libcuda.so.1")
        p = ctypes.c_void_p
        lib.cuGraphGetNodes.argtypes = [p, p, ctypes.POINTER(ctypes.c_size_t)]
        lib.cuGraphGetNodes.restype = ctypes.c_int
        lib.cuGraphNodeGetType.argtypes = [p, ctypes.POINTER(ctypes.c_int)]
        lib.cuGraphNodeGetType.restype = ctypes.c_int
        _libcuda = lib
    graph, count = ctypes.c_void_p(raw), ctypes.c_size_t(0)
    code = _libcuda.cuGraphGetNodes(graph, None, ctypes.byref(count))
    nodes = (ctypes.c_void_p * count.value)()
    if not code:
        code = _libcuda.cuGraphGetNodes(graph, nodes, ctypes.byref(count))
    kind, total = ctypes.c_int(0), 0
    for node in nodes:
        if code:
            break
        code = _libcuda.cuGraphNodeGetType(node, ctypes.byref(kind))
        total += kind.value in _DEVICE_NODES
    if code:
        raise RuntimeError(f"reading a captured graph's nodes failed: "
                           f"CUresult {code}")
    return total


@dataclass
class Captured:
    """One captured part: its graph, what a replay adds to the counters
    (:func:`._launch.since`: (counter, launches, the Counter's split)),
    the hand-written launches in it, its device operations and the scratch
    it must hold alive."""
    graph: torch.cuda.CUDAGraph
    delta: list
    calls: int
    nodes: int
    held: list


def capture(parts: dict, device: torch.device, keep=()) -> dict:
    """Warm up, then capture, each of ``parts`` (name -> a function of no
    arguments that reads and writes only tensors that outlive it) on
    ``device``; returns name -> :class:`Captured`. ``keep`` is called on the
    side stream before the warm-up and returns what the graphs must hold
    alive (scratch that a wrapper allocates per stream). The launch counters
    are left as they were."""
    global CAPTURES
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _pools:
        with torch.cuda.device(idx):
            _pools[idx] = torch.cuda.graph_pool_handle()
            _streams[idx] = torch.cuda.Stream(idx)
    side, pool = _streams[idx], _pools[idx]
    saved = _launch.snapshot()
    out = {}
    try:
        current = torch.cuda.current_stream(idx)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            held = [fn() for fn in keep]
            for fn in parts.values():
                fn()
        current.wait_stream(side)
        for name, fn in parts.items():
            _launch.restore(saved)
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            with torch.cuda.graph(graph, pool=pool, stream=side):
                fn()
            delta = _launch.since(saved)
            calls = sum(n for _, n, _ in delta)
            nodes = _device_nodes(graph.raw_cuda_graph())
            graph.instantiate()
            out[name] = Captured(graph, delta, calls, nodes, held)
    except Exception as exc:
        raise RuntimeError(f"ipm_box_lp: capturing the solve's CUDA graphs "
                           f"failed: {exc}") from exc
    finally:
        _launch.restore(saved)
    CAPTURES += len(out)
    return out


def replay(part: Captured) -> None:
    """Replay a captured part on the current stream and count its
    launches."""
    global REPLAYS, CALLS, NODES
    part.graph.replay()
    for count, n, by in part.delta:
        count.add(n, by)
    REPLAYS += 1
    CALLS += part.calls
    NODES += part.nodes
