"""Weighted segment sum over CSR rows: CUDA kernel and its twin.

Kernel: ``csrc/tile_segment.cu`` (``weighted_segment_sum``), replacing
``snag_tpu/ops/pallas/tile_segment.py::tile_weighted_segment_sum``.  For
every head h and edge k = i <- j of the row-sorted CSR graph:

    agg[i, h]    = sum_k e[k, h] * x[col[k]]
    rowsum[i, h] = sum_k e[k, h]

The kernel gathers x[col] itself; the JAX package's (E, C) edge block is
never built.

Twin: ``weighted_segment_sum_twin``, the ``index_add_`` form of
``xla_weighted_segment_sum`` (tile_segment.py:341-353).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from snag_tpu_torch.data.graph import DeviceGraph
from snag_tpu_torch.ops.cuda._lib import (KernelStats, check, load_library,
                                          ptr, require, stream_of)

STATS = KernelStats("weighted_segment_sum")


def weighted_segment_sum_twin(x: torch.Tensor, e: torch.Tensor,
                              graph: DeviceGraph
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain-PyTorch version: gather, weight, ``index_add_`` over rows."""
    n, c = x.shape
    h = e.shape[1]
    vals = (e[:, :, None] * x[graph.col.long()][:, None, :]).reshape(-1, h * c)
    agg = torch.zeros(n, h * c, dtype=torch.float32, device=x.device)
    agg.index_add_(0, graph.row, vals)
    rowsum = torch.zeros(n, h, dtype=torch.float32, device=x.device)
    rowsum.index_add_(0, graph.row, e)
    return agg.reshape(n, h, c), rowsum


def _library():
    built = load_library("tile_segment")
    fn = built.lib.weighted_segment_sum
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return built


def weighted_segment_sum_cuda(x: torch.Tensor, e: torch.Tensor,
                              graph: DeviceGraph
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel; every input must be f32/int32, contiguous
    and on the same CUDA device."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"weighted_segment_sum_cuda needs CUDA tensors, "
                         f"got {dev}")
    if x.dim() != 2 or e.dim() != 2:
        raise ValueError(f"x must be (N, C) and e (E, H), got "
                         f"{tuple(x.shape)} and {tuple(e.shape)}")
    n, c = x.shape
    h = e.shape[1]
    if n != graph.n_nodes:
        raise ValueError(f"x has {n} rows, the graph {graph.n_nodes} nodes")
    require(x, "x", torch.float32, (n, c), dev)
    require(e, "e", torch.float32, (graph.n_edges, h), dev)
    require(graph.row_ptr, "row_ptr", torch.int32, (n + 1,), dev)
    require(graph.col, "col", torch.int32, (graph.n_edges,), dev)
    vec = 4 if (c % 4 == 0 and x.data_ptr() % 16 == 0) else 1
    if -(-c // vec) > 1024:
        raise ValueError(f"C = {c} is too wide for one block per row")

    agg = torch.empty(n, h, c, dtype=torch.float32, device=dev)
    rowsum = torch.empty(n, h, dtype=torch.float32, device=dev)
    built = _library()
    with torch.cuda.device(dev):
        err = built.lib.weighted_segment_sum(
            ptr(x), ptr(e), ptr(graph.row_ptr), ptr(graph.col), ptr(agg),
            ptr(rowsum), n, c, h, vec, stream_of(x))
    check(built, err, "weighted_segment_sum")
    STATS.launches += 1
    return agg, rowsum


def weighted_segment_sum(x: torch.Tensor, e: torch.Tensor, graph: DeviceGraph
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (N, C), e (E, H) in CSR edge order.  Returns (agg (N, H, C) f32,
    rowsum (N, H) f32): the kernel for CUDA tensors, the twin for CPU
    tensors."""
    if x.device.type == "cuda":
        return weighted_segment_sum_cuda(x, e, graph)
    if x.device.type != "cpu":
        raise ValueError(f"no weighted segment sum for device {x.device}")
    STATS.twin_calls += 1
    return weighted_segment_sum_twin(x, e, graph)
