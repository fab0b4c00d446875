"""Sparse-GAT attention + aggregation forward: CUDA kernel and its twin.

Kernel: ``csrc/gat_attention.cu``, replacing
``snag_tpu/ops/pallas/gat_attention.py::fused_gat_attention``.  For every
head h and edge i <- j of the row-sorted CSR graph:

    e_ij        = exp(-leakyrelu_0.2(s_src[i, h] + s_dst[j, h]))
    agg[i, h]   = sum_j e_ij * x[j]
    rowsum[i, h] = sum_j e_ij

One warp owns a row; lane l owns the 4-float (or 1-float) slices l,
l + 32, ... of the row's C features, at most ``MAX_GROUPS`` of them, so the
kernel takes C <= 1,280 when C % 4 == 0 and C <= 320 otherwise
(``slice_width``; the backward shares the limit).

Twin: ``gat_attention_twin``, the ``index_add_`` form of
``xla_gat_attention`` (gat_attention.py:207-221).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from snag_tpu_torch.data.graph import DeviceGraph
from snag_tpu_torch.ops.cuda._lib import (KernelStats, check, load_library,
                                          ptr, require, stream_of)

STATS = KernelStats("gat_attention_fwd")
MAX_HEADS = 4
MAX_GROUPS = 10     # slices a lane


def slice_width(c: int, *tensors: torch.Tensor) -> int:
    """The GAT kernels' slice width: 4 floats when C % 4 == 0 and every
    tensor is 16-byte aligned, else 1.  Raises when a lane would own more
    than ``MAX_GROUPS`` slices of a row."""
    vec = 4 if c % 4 == 0 and all(t.data_ptr() % 16 == 0
                                  for t in tensors) else 1
    if c // vec > 32 * MAX_GROUPS:
        raise ValueError(
            f"C = {c} is too wide for a warp per row: the GAT kernels take "
            f"C <= {4 * 32 * MAX_GROUPS} with C % 4 == 0 (and 16-byte "
            f"aligned tensors), else C <= {32 * MAX_GROUPS}")
    return vec


def gat_attention_twin(x: torch.Tensor, s_src: torch.Tensor,
                       s_dst: torch.Tensor, graph: DeviceGraph
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain-PyTorch version: gather, weight, ``index_add_`` over rows."""
    n, c = x.shape
    h = s_src.shape[1]
    row = graph.row
    col = graph.col.long()
    score = s_src[row] + s_dst[col]                          # (E, H)
    e = torch.exp(-F.leaky_relu(score, negative_slope=0.2))
    vals = (e[:, :, None] * x[col][:, None, :]).reshape(-1, h * c)
    agg = torch.zeros(n, h * c, dtype=torch.float32, device=x.device)
    agg.index_add_(0, row, vals)
    rowsum = torch.zeros(n, h, dtype=torch.float32, device=x.device)
    rowsum.index_add_(0, row, e)
    return agg.reshape(n, h, c), rowsum


def _library():
    built = load_library("gat_attention")
    fn = built.lib.gat_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return built


def gat_attention_cuda(x: torch.Tensor, s_src: torch.Tensor,
                       s_dst: torch.Tensor, graph: DeviceGraph
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel; every input must be f32/int32, contiguous
    and on the same CUDA device."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"gat_attention_cuda needs CUDA tensors, got {dev}")
    n, c = x.shape
    h = s_src.shape[1]
    if not 1 <= h <= MAX_HEADS:
        raise ValueError(f"{h} heads; the kernel takes 1..{MAX_HEADS}")
    if n != graph.n_nodes:
        raise ValueError(f"x has {n} rows, the graph {graph.n_nodes} nodes")
    require(x, "x", torch.float32, (n, c), dev)
    require(s_src, "s_src", torch.float32, (n, h), dev)
    require(s_dst, "s_dst", torch.float32, (n, h), dev)
    require(graph.row_ptr, "row_ptr", torch.int32, (n + 1,), dev)
    require(graph.col, "col", torch.int32, (graph.n_edges,), dev)

    agg = torch.empty(n, h, c, dtype=torch.float32, device=dev)
    rowsum = torch.empty(n, h, dtype=torch.float32, device=dev)
    vec = slice_width(c, x, agg)
    built = _library()
    with torch.cuda.device(dev):
        err = built.lib.gat_attention_fwd(
            ptr(x), ptr(s_src), ptr(s_dst), ptr(graph.row_ptr),
            ptr(graph.col), ptr(agg), ptr(rowsum), n, c, h, vec,
            stream_of(x))
    check(built, err, "gat_attention_fwd")
    STATS.launches += 1
    return agg, rowsum


def fused_gat_attention(x: torch.Tensor, s_src: torch.Tensor,
                        s_dst: torch.Tensor, graph: DeviceGraph
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (agg (N, H, C) f32, rowsum (N, H) f32): the kernel for CUDA
    tensors, the twin for CPU tensors."""
    if x.device.type == "cuda":
        return gat_attention_cuda(x, s_src, s_dst, graph)
    if x.device.type != "cpu":
        raise ValueError(f"no GAT attention path for device {x.device}")
    STATS.twin_calls += 1
    return gat_attention_twin(x, s_src, s_dst, graph)
