"""Weighted segment sum over CSR rows: CUDA kernel and its twin.

Kernel: ``csrc/tile_segment.cu`` (``weighted_segment_sum``), replacing
``snag_tpu/ops/pallas/tile_segment.py::tile_weighted_segment_sum``.  For
every head h and edge k = i <- j of the row-sorted CSR graph:

    agg[i, h]    = sum_k e[k, h] * x[col[k]]
    rowsum[i, h] = sum_k e[k, h]

The kernel gathers x[col] itself; the JAX package's (E, C) edge block is
never built.  One warp owns a row; lane l owns the 4-float (or 1-float)
slices l, l + 32, ... of a column chunk, at most ``MAX_GROUPS`` of them, and
up to ``MAX_HEADS`` heads' accumulators: ``launch_plan`` gives the chunks
and head groups, so any C and any H are taken.

Twin: ``weighted_segment_sum_twin``, the ``index_add_`` form of
``xla_weighted_segment_sum`` (tile_segment.py:341-353).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from snag_tpu_torch.data.graph import DeviceGraph
from snag_tpu_torch.ops.cuda._lib import (KernelStats, check, load_library,
                                          ptr, require, stream_of)

STATS = KernelStats("weighted_segment_sum")
MAX_HEADS = 4       # heads a launch group
MAX_GROUPS = 4      # slices a lane in one column chunk
WARPS = 4           # rows a block


class LaunchPlan(NamedTuple):
    """How ``csrc/tile_segment.cu`` covers (rows, heads, C / vec slices):
    blocks of ``WARPS`` rows, a warp a row; ``chunks`` column chunks
    (gridDim.y) of 32 lanes x ``groups`` slices, lane l owning slices
    chunk * 32 * groups + l + 32 g; ``full`` head groups of ``MAX_HEADS``
    (gridDim.z) and, launched on its own, a group of the ``tail`` heads
    left."""
    vec: int
    groups: int
    chunks: int
    full: int
    tail: int


def launch_plan(c: int, h: int, vec: int) -> LaunchPlan:
    """The plan the C entry ``weighted_segment_sum`` launches (its
    ``plan_for``): the C / vec slices in 32-lane groups, cut into the
    fewest column chunks of at most ``MAX_GROUPS`` groups, shared out
    evenly."""
    lane_groups = -(-(c // vec) // 32)
    chunks = -(-lane_groups // MAX_GROUPS)
    return LaunchPlan(vec, -(-lane_groups // chunks), chunks, h // MAX_HEADS,
                      h % MAX_HEADS)


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
        plan = built.lib.weighted_segment_sum_plan
        plan.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
        plan.restype = ctypes.c_int
    return built


def kernel_plan(c: int, h: int, vec: int) -> LaunchPlan:
    """The plan as the built library computes it (for holding
    ``launch_plan`` against it on the card)."""
    built = _library()
    out = (ctypes.c_int * 4)()
    check(built, built.lib.weighted_segment_sum_plan(
        c, h, vec, ctypes.cast(out, ctypes.c_void_p)),
        "weighted_segment_sum_plan")
    return LaunchPlan(vec, *out)


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
    tensors.  Takes f32 alone: a bf16 x raises (a bf16 GCN waits for a
    bf16 variant of the kernel, ROADMAP A)."""
    if x.dtype == torch.bfloat16 or e.dtype == torch.bfloat16:
        raise TypeError("the weighted segment sum has no bf16 variant "
                        "(ROADMAP A: bf16 GCN (segment sum))")
    if x.device.type == "cuda":
        return weighted_segment_sum_cuda(x, e, graph)
    if x.device.type != "cpu":
        raise ValueError(f"no weighted segment sum for device {x.device}")
    STATS.twin_calls += 1
    return weighted_segment_sum_twin(x, e, graph)
