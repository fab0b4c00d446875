"""Weighted segment sum over CSR rows: CUDA kernel and its twin.

Kernel: ``csrc/tile_segment.cu`` (``weighted_segment_sum``), replacing
``snag_tpu/ops/pallas/tile_segment.py::tile_weighted_segment_sum``.  For
every head h and edge k = i <- j of the row-sorted CSR graph:

    agg[i, h]    = sum_k e[k, h] * x[col[k]]
    rowsum[i, h] = sum_k e[k, h]

The kernel gathers x[col] itself; the JAX package's (E, C) edge block is
never built.  One warp owns a row; lane l owns the 4-element (or 1-element)
slices l, l + 32, ... of a column chunk, at most ``MAX_GROUPS`` of them, and
up to ``MAX_HEADS`` heads' accumulators: ``launch_plan`` gives the chunks
and head groups, so any C and any H are taken.

Twin: ``weighted_segment_sum_twin``, the ``index_add_`` form of
``xla_weighted_segment_sum`` (tile_segment.py:341-353).

bf16: bf16 x and e (the JAX GCN under ``--dtype bfloat16``,
gnn.py:43-50) take ``weighted_segment_sum_bf16``, counted apart
(``STATS_BF16``): a body of its own, a row on 16 lanes where its slices
fit, two rows a warp (``launch_plan(..., bf16=True)``).  It follows the
Pallas kernel (tile_segment.py:209-234): each product e x of two bf16
values is exact in f32, the products and rowsum's bf16 e are added in f32,
and both outputs are f32.  ``round_term`` rounds each edge's term e x to
bf16 before it is added: the GCN backward's reverse-edge launch, where JAX
rounds each edge's e g to bf16 (gat_agg.py:104) before it sums them in
f32; with ``out_bf16`` that launch returns the f32 sum rounded once to
bf16, as JAX returns d_x (gat_agg.py:112), and no rowsum.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from snag_tpu_torch.data.graph import DeviceGraph
from snag_tpu_torch.ops.cuda._lib import (KernelStats, check, dtype_suffix,
                                          load_library, ptr, require,
                                          stream_of)

STATS = KernelStats("weighted_segment_sum")
STATS_BF16 = KernelStats("weighted_segment_sum_bf16")
BF16 = torch.bfloat16
MAX_HEADS = 4       # heads a launch group
MAX_GROUPS = 4      # slices a lane in one column chunk (f32)
MAX_GROUPS_BF16 = 5  # slices a lane in one column chunk (bf16)
WARPS = 4           # warps a block


class LaunchPlan(NamedTuple):
    """How ``csrc/tile_segment.cu`` covers (rows, heads, C / vec slices):
    blocks of ``WARPS`` warps, a row on ``lanes`` lanes (32 / lanes rows a
    warp); ``chunks`` column chunks (gridDim.y) of ``lanes`` x ``groups``
    slices, lane l of a row owning slices chunk * lanes * groups + l +
    lanes g; ``full`` head groups of ``MAX_HEADS`` (gridDim.z) and,
    launched on its own, a group of the ``tail`` heads left."""
    vec: int
    groups: int
    chunks: int
    full: int
    tail: int
    lanes: int = 32


def launch_plan(c: int, h: int, vec: int, bf16: bool = False) -> LaunchPlan:
    """The plan the C entry launches.  ``weighted_segment_sum`` (its
    ``plan_for``): the C / vec slices in 32-lane groups, cut into the
    fewest column chunks of at most ``MAX_GROUPS`` groups, shared out
    evenly.  ``weighted_segment_sum_bf16`` (``plan_bf16``): a row of at
    most 16 ``MAX_GROUPS_BF16`` slices on 16 lanes in one chunk, a wider
    one in 32-lane groups cut as above with ``MAX_GROUPS_BF16``."""
    nv = c // vec
    heads = (h // MAX_HEADS, h % MAX_HEADS)
    if bf16 and nv <= 16 * MAX_GROUPS_BF16:
        return LaunchPlan(vec, -(-nv // 16), 1, *heads, 16)
    most = MAX_GROUPS_BF16 if bf16 else MAX_GROUPS
    lane_groups = -(-nv // 32)
    chunks = -(-lane_groups // most)
    return LaunchPlan(vec, -(-lane_groups // chunks), chunks, *heads, 32)


def _check_flags(dtype: torch.dtype, round_term: bool, out_bf16: bool):
    if round_term and dtype != BF16:
        raise ValueError(f"round_term rounds bf16 terms; x is {dtype}")
    if out_bf16 and not round_term:
        raise ValueError("out_bf16 writes the sum of round_term's terms in "
                         "bf16 (the GCN backward's d_x); pass round_term")


def weighted_segment_sum_twin(x: torch.Tensor, e: torch.Tensor,
                              graph: DeviceGraph, round_term: bool = False,
                              out_bf16: bool = False
                              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain-PyTorch version: gather, weight, ``index_add_`` over rows.
    bf16 x and e are upcast to f32 and multiplied there (exactly), each
    product rounded to bf16 under ``round_term``, and added in f32;
    ``out_bf16`` rounds that sum to bf16 and returns no rowsum."""
    n, c = x.shape
    h = e.shape[1]
    _check_flags(x.dtype, round_term, out_bf16)
    x, e = x.to(torch.float32), e.to(torch.float32)
    vals = e[:, :, None] * x[graph.col.long()][:, None, :]
    if round_term:
        vals = vals.to(BF16).to(torch.float32)
    agg = torch.zeros(n, h * c, dtype=torch.float32, device=x.device)
    agg.index_add_(0, graph.row, vals.reshape(-1, h * c))
    if out_bf16:
        return agg.reshape(n, h, c).to(BF16), None
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
        fn = built.lib.weighted_segment_sum_bf16
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        for name in ("weighted_segment_sum_plan",
                     "weighted_segment_sum_bf16_plan"):
            plan = getattr(built.lib, name)
            plan.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
            plan.restype = ctypes.c_int
    return built


def kernel_plan(c: int, h: int, vec: int, bf16: bool = False) -> LaunchPlan:
    """The plan as the built library computes it (for holding
    ``launch_plan`` against it on the card)."""
    built = _library()
    name = "weighted_segment_sum_bf16_plan" if bf16 else \
        "weighted_segment_sum_plan"
    out = (ctypes.c_int * 5)()
    check(built, getattr(built.lib, name)(
        c, h, vec, ctypes.cast(out, ctypes.c_void_p)), name)
    return LaunchPlan(vec, *out)


def weighted_segment_sum_cuda(x: torch.Tensor, e: torch.Tensor,
                              graph: DeviceGraph, round_term: bool = False,
                              out_bf16: bool = False
                              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch the CUDA kernel; x and e must be both f32 or both bf16, the
    graph int32, every input contiguous and on the same CUDA device;
    ``round_term`` takes bf16 alone, ``out_bf16`` ``round_term`` alone."""
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
    bf16 = dtype_suffix(x.dtype, "segment sum kernels") == "_bf16"
    _check_flags(x.dtype, round_term, out_bf16)
    require(x, "x", x.dtype, (n, c), dev)
    require(e, "e", x.dtype, (graph.n_edges, h), dev)
    require(graph.row_ptr, "row_ptr", torch.int32, (n + 1,), dev)
    require(graph.col, "col", torch.int32, (graph.n_edges,), dev)
    vec = 4 if (c % 4 == 0 and x.data_ptr() % (4 * x.element_size()) == 0
                ) else 1

    agg = torch.empty(n, h, c, dtype=BF16 if out_bf16 else torch.float32,
                      device=dev)
    rowsum = None if out_bf16 else torch.empty(n, h, dtype=torch.float32,
                                               device=dev)
    built = _library()
    stats = STATS_BF16 if bf16 else STATS
    args = [ptr(x), ptr(e), ptr(graph.row_ptr), ptr(graph.col), ptr(agg),
            ptr(rowsum), n, c, h, vec]
    if bf16:
        args += [int(round_term), int(out_bf16)]
    with torch.cuda.device(dev):
        err = getattr(built.lib, stats.name)(*args, stream_of(x))
    check(built, err, stats.name)
    stats.launches += 1
    return agg, rowsum


def weighted_segment_sum(x: torch.Tensor, e: torch.Tensor, graph: DeviceGraph,
                         round_term: bool = False, out_bf16: bool = False
                         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x (N, C), e (E, H) in CSR edge order, both f32 or both bf16.
    Returns (agg (N, H, C) f32, rowsum (N, H) f32): the kernel for CUDA
    tensors, the twin for CPU tensors.  ``round_term`` (bf16 only) rounds
    each edge's term to bf16 before it is added; ``out_bf16`` (with
    ``round_term``) returns agg rounded once to bf16 and no rowsum."""
    if x.dtype != e.dtype:
        raise TypeError(f"x is {x.dtype} and e {e.dtype}: the weighted "
                        "segment sum takes both float32 or both bfloat16")
    if x.device.type == "cuda":
        return weighted_segment_sum_cuda(x, e, graph, round_term, out_bf16)
    if x.device.type != "cpu":
        raise ValueError(f"no weighted segment sum for device {x.device}")
    bf16 = dtype_suffix(x.dtype, "segment sum kernels") == "_bf16"
    (STATS_BF16 if bf16 else STATS).twin_calls += 1
    return weighted_segment_sum_twin(x, e, graph, round_term, out_bf16)
