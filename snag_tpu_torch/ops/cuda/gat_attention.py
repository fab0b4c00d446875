"""Sparse-GAT attention + aggregation forward: CUDA kernel and its twin.

Kernel: ``csrc/gat_attention.cu``, replacing
``snag_tpu/ops/pallas/gat_attention.py::fused_gat_attention``.  For every
head h and edge i <- j of the row-sorted CSR graph:

    e_ij        = exp(-leakyrelu_0.2(s_src[i, h] + s_dst[j, h]))
    agg[i, h]   = sum_j e_ij * x[j]
    rowsum[i, h] = sum_j e_ij

One warp owns a row; lane l owns the 4-float (or 1-float) slices l,
l + 32, ... of the row's C features, at most ``MAX_GROUPS`` of them, and
holds up to ``MAX_HEADS`` heads: H <= 4 with C <= 1,280 when C % 4 == 0
(else C <= 320), the main path's shapes.  Any other H and C run the wide
kernels (``wide``; the backward shares the split), which walk column
chunks (``csrc/gat_attention.cu``, ``WIDE_GROUPS``) and head groups of
``MAX_HEADS`` to the same sums; their launches are counted apart
(``STATS_WIDE``, ``STATS_BF16_WIDE``).

Twin: ``gat_attention_twin``, the ``index_add_`` form of
``xla_gat_attention`` (gat_attention.py:207-221).

bf16: a bf16 x (the JAX package's edge dtype under ``--dtype bfloat16``,
gnn.py:127-129) takes ``gat_attention_fwd_bf16``, the same kernel on bf16
rows, counted apart (``STATS_BF16``).  It follows the Pallas kernel, the
path the TPU ran, not the XLA fallback: s_src and s_dst (f32 inputs) are
rounded to bf16 (gat_attention.py:135, gat_attn_primitive.py:85) and so
is e before both sums (gat_attention.py:74; the fallback keeps s_src in
f32 and e unrounded, :207-220); the sums and both outputs are f32.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from snag_tpu_torch.data.graph import DeviceGraph
from snag_tpu_torch.ops.cuda._lib import (KernelStats, check, dtype_suffix,
                                          load_library, ptr, require,
                                          stream_of)

STATS = KernelStats("gat_attention_fwd")
STATS_BF16 = KernelStats("gat_attention_fwd_bf16")
# the wide path's launches (``wide``), counted apart
STATS_WIDE = KernelStats("gat_attention_fwd_wide")
STATS_BF16_WIDE = KernelStats("gat_attention_fwd_bf16_wide")
MAX_HEADS = 4       # heads a warp holds
MAX_GROUPS = 10     # slices a lane


def slice_width(c: int, *tensors: torch.Tensor) -> int:
    """The GAT kernels' slice width: 4 elements when C % 4 == 0 and every
    tensor is aligned to 4 of its elements (16 bytes of f32, 8 of bf16),
    else 1."""
    return 4 if c % 4 == 0 and all(t.data_ptr() % (4 * t.element_size()) == 0
                                   for t in tensors) else 1


def wide(c: int, h: int, vec: int) -> bool:
    """Whether both GAT kernels take their wide path at C, H and slice
    width vec (``csrc/gat_attention.cu``, ``csrc/gat_bwd.cu``): more than
    ``MAX_HEADS`` heads, or more than ``MAX_GROUPS`` slices a lane."""
    return h > MAX_HEADS or c // vec > 32 * MAX_GROUPS


def to_bf16(t: torch.Tensor) -> torch.Tensor:
    """t rounded to bf16 and back to f32 (the JAX package's astype)."""
    return t.to(torch.bfloat16).to(torch.float32)


def gat_attention_twin(x: torch.Tensor, s_src: torch.Tensor,
                       s_dst: torch.Tensor, graph: DeviceGraph
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain-PyTorch version: gather, weight, ``index_add_`` over rows;
    for a bf16 x with the Pallas kernel's roundings (module docstring)."""
    n, c = x.shape
    h = s_src.shape[1]
    row = graph.row
    col = graph.col.long()
    bf16 = x.dtype == torch.bfloat16
    if bf16:
        s_src, s_dst, x = to_bf16(s_src), to_bf16(s_dst), x.to(torch.float32)
    score = s_src[row] + s_dst[col]                          # (E, H)
    e = torch.exp(-F.leaky_relu(score, negative_slope=0.2))
    if bf16:
        e = to_bf16(e)
    vals = (e[:, :, None] * x[col][:, None, :]).reshape(-1, h * c)
    agg = torch.zeros(n, h * c, dtype=torch.float32, device=x.device)
    agg.index_add_(0, row, vals)
    rowsum = torch.zeros(n, h, dtype=torch.float32, device=x.device)
    rowsum.index_add_(0, row, e)
    return agg.reshape(n, h, c), rowsum


def _library():
    built = load_library("gat_attention")
    for fn in (built.lib.gat_attention_fwd, built.lib.gat_attention_fwd_bf16):
        if fn.argtypes is None:
            fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
    return built


def gat_attention_cuda(x: torch.Tensor, s_src: torch.Tensor,
                       s_dst: torch.Tensor, graph: DeviceGraph
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel; x must be f32 or bf16, the scores f32, the
    graph int32, every input contiguous and on the same CUDA device."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"gat_attention_cuda needs CUDA tensors, got {dev}")
    n, c = x.shape
    h = s_src.shape[1]
    if h < 1:
        raise ValueError("the GAT kernels need at least one head")
    if n != graph.n_nodes:
        raise ValueError(f"x has {n} rows, the graph {graph.n_nodes} nodes")
    dtype_suffix(x.dtype, "GAT kernels")
    require(x, "x", x.dtype, (n, c), dev)
    require(s_src, "s_src", torch.float32, (n, h), dev)
    require(s_dst, "s_dst", torch.float32, (n, h), dev)
    require(graph.row_ptr, "row_ptr", torch.int32, (n + 1,), dev)
    require(graph.col, "col", torch.int32, (graph.n_edges,), dev)

    agg = torch.empty(n, h, c, dtype=torch.float32, device=dev)
    rowsum = torch.empty(n, h, dtype=torch.float32, device=dev)
    vec = slice_width(c, x, agg)
    built = _library()
    bf16 = x.dtype == torch.bfloat16
    name = "gat_attention_fwd_bf16" if bf16 else "gat_attention_fwd"
    with torch.cuda.device(dev):
        err = getattr(built.lib, name)(
            ptr(x), ptr(s_src), ptr(s_dst), ptr(graph.row_ptr),
            ptr(graph.col), ptr(agg), ptr(rowsum), n, c, h, vec,
            stream_of(x))
    check(built, err, name)
    if wide(c, h, vec):
        (STATS_BF16_WIDE if bf16 else STATS_WIDE).launches += 1
    else:
        (STATS_BF16 if bf16 else STATS).launches += 1
    return agg, rowsum


def fused_gat_attention(x: torch.Tensor, s_src: torch.Tensor,
                        s_dst: torch.Tensor, graph: DeviceGraph
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (agg (N, H, C) f32, rowsum (N, H) f32): the kernel for CUDA
    tensors, the twin for CPU tensors; x f32 or bf16."""
    if x.device.type == "cuda":
        return gat_attention_cuda(x, s_src, s_dst, graph)
    if x.device.type != "cpu":
        raise ValueError(f"no GAT attention path for device {x.device}")
    (STATS_BF16 if x.dtype == torch.bfloat16 else STATS).twin_calls += 1
    return gat_attention_twin(x, s_src, s_dst, graph)
