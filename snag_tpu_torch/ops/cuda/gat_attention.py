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
kernels (``wide``; the backward shares the split), which walk each row's
edges once for up to ``WIDE_HEADS`` heads (``wide_plan``: a row on one
warp, or on a group of warps that split its columns; a block's tile of
rows has its column ids and weights staged in shared memory at once, and
its rows' edges are streamed with x rows in flight before their fmaf) to
the same sums; their launches are counted apart (``STATS_WIDE``,
``STATS_BF16_WIDE``).

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
# the wide kernels (csrc/gat_attention.cu): heads a warp holds, warps a
# row, row groups a block when a row takes one warp, rows a group walks in
# turn, edges a thread stages a chunk, the bytes of a warp's ring of x
# rows in shared memory, and its most slots
WIDE_HEADS = 8
WIDE_WARPS = 8
WIDE_ROWS = 4
WIDE_RUN = 4
WIDE_STAGE = 2
WIDE_RING = 9216
WIDE_DEPTH = 8


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


def wide_slice_width(c: int, h: int, *tensors: torch.Tensor
                     ) -> Tuple[int, bool]:
    """(slice width, wide): ``slice_width`` and whether both GAT kernels
    take the wide path (``wide``), where the width 1 becomes 2 elements (8
    bytes of f32, 4 of bf16) when C is even and every tensor is aligned to
    2 of its elements."""
    vec = slice_width(c, *tensors)
    is_wide = wide(c, h, vec)
    if vec == 1 and is_wide and c % 2 == 0 and all(
            t.data_ptr() % (2 * t.element_size()) == 0 for t in tensors):
        vec = 2
    return vec, is_wide


def wide_gw_options(hb: int, vec: int) -> Tuple[int, ...]:
    """The groups of 32 slices a lane that the wide kernels are built for
    at ``hb`` heads a warp and slice width ``vec`` (``launch_wide_gw``):
    96 accumulator floats at ``WIDE_HEADS`` heads, 48 at fewer, at most 12
    groups; and fewer for narrow rows: 1, 3 or 6 at ``WIDE_HEADS`` heads, 6
    for a row of pairs at fewer heads."""
    big = min(12, (96 if hb == WIDE_HEADS else 48) // (hb * vec))
    small = (1, 3, 6) if hb == WIDE_HEADS else (6,) if vec == 2 else ()
    return tuple(sorted({g for g in small if g < big} | {big}))


def wide_plan(c: int, h: int, vec: int, bf16: bool = False) -> dict:
    """The wide kernels' launch at width C, H heads and slice width vec
    (of bf16 rows with ``bf16``):
    heads in ``head_groups`` groups of ``hn`` (a warp holds ``hb`` >= hn,
    2, 4 or ``WIDE_HEADS``), ``gw`` groups of 32 slices a lane (the fewest
    of ``wide_gw_options`` that hold the row on one warp, else the most),
    ``warps`` warps a row (a row group; one warp a row takes ``WIDE_ROWS``
    groups a block), each group walking ``WIDE_RUN`` rows in turn, so a
    block takes a tile of ``tile`` rows; ``passes`` blocks over the
    columns (more than one only past ``WIDE_WARPS`` warps' columns),
    ``depth`` slots of a warp's ring of x rows in shared memory (as many as
    ``WIDE_RING`` bytes hold, 2 to ``WIDE_DEPTH``; a lane's slice there is
    ``slice_bytes``: 4 a float, 8 or 4 for bf16 slices of 4 or fewer), the
    block's rings in ``ring`` bytes, and its dynamic shared memory in all,
    ``smem`` (with a chunk's column ids and weights, ``chunk`` edges, and
    the tile's row offsets)."""
    groups = -(-(c // vec) // 32)
    head_groups = -(-h // WIDE_HEADS)
    hn = -(-h // head_groups)
    hb = 2 if hn <= 2 else 4 if hn <= 4 else WIDE_HEADS
    options = wide_gw_options(hb, vec)
    gw = next((g for g in options if g >= groups), options[-1])
    row_warps = -(-groups // gw)
    passes = -(-row_warps // WIDE_WARPS)
    warps = -(-row_warps // passes)
    slice_bytes = (8 if vec == 4 else 4) if bf16 else 4 * vec
    depth = min(WIDE_DEPTH, max(2, WIDE_RING // (32 * gw * slice_bytes)))
    rows = WIDE_ROWS if warps == 1 else 1
    threads = 32 * warps * rows
    ring = threads // 32 * depth * 32 * gw * slice_bytes
    chunk = WIDE_STAGE * threads
    tile = rows * WIDE_RUN
    return dict(hn=hn, hb=hb, head_groups=head_groups, gw=gw, warps=warps,
                rows=rows, tile=tile, passes=passes, depth=depth,
                slice_bytes=slice_bytes, ring=ring, chunk=chunk,
                smem=ring + 4 * chunk * (hb + 1) + 4 * (tile + 1))


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
            fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [
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
    vec, is_wide = wide_slice_width(c, h, x, agg)
    bf16 = x.dtype == torch.bfloat16
    plan = wide_plan(c, h, vec, bf16) if is_wide else dict(hn=0, gw=0,
                                                           warps=0)
    built = _library()
    name = "gat_attention_fwd_bf16" if bf16 else "gat_attention_fwd"
    with torch.cuda.device(dev):
        err = getattr(built.lib, name)(
            ptr(x), ptr(s_src), ptr(s_dst), ptr(graph.row_ptr),
            ptr(graph.col), ptr(agg), ptr(rowsum), n, c, h, vec,
            plan["hn"], plan["gw"], plan["warps"], stream_of(x))
    check(built, err, name)
    if is_wide:
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
