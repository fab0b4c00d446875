"""Sparse-GAT attention + aggregation backward: CUDA kernel and its twin.

Kernel: ``csrc/gat_bwd.cu``, replacing
``snag_tpu/ops/pallas/gat_bwd.py::fused_gat_backward_row``.  From the
cotangents G of ``agg`` (N, H, C) and r of ``rowsum`` (N, H), for every
edge i <- j of the CSR graph:

    e        = exp(-leakyrelu_0.2(s_src[i] + s_dst[j]))
    d_e      = <x[j], G[i, h]> + r[i, h]
    d_score  = -d_e * e * leaky'(s_src[i] + s_dst[j])
    d_x[j]     += sum_h e_h * G[i, h]
    d_s_dst[j] += d_score
    d_s_src[i] += d_score

The kernel reads each node's in-edges as its out-edges reversed, so it
needs the symmetric edge multiset that ``build_graph`` records, and its
``rev``: the first of its two launches, a warp per CSR row j, computes the
d_score of each edge (k, j) once, adds it into d_s_dst[j] and writes it to
an (E, H) scratch at that edge's position rev[p]; the second adds each
row's scratch into d_s_src in CSR order.  Beyond the main path's H <= 4
and C <= 1,280 (``gat_attention.wide``) its wide kernels walk each row's
edges once at any H and C (``wide_plan``: a row on one warp, or on a
block whose warps split its columns; an edge's heads in groups of four
with their G rows in flight together, each batch of 32 edges' d_scores
formed in shared memory), and the second launch adds d_s_dst as well.
Wide launches are counted apart (``STATS_WIDE``, ``STATS_BF16_WIDE``).

Twin: ``gat_backward_twin``, the same sums in ``index_add_`` form over the
edge list (no symmetry needed).

bf16: a bf16 x (with bf16 G, as ``gat_attn_primitive`` builds it) takes
``gat_bwd_bf16``, counted apart (``STATS_BF16``), with the rounding points
of the Pallas backward on the JAX package's bf16 path
(gat_attn_primitive.py:137-192, gat_bwd.py:95-125): s_src, s_dst and r
rounded to bf16, e in f32, each edge's d_score rounded to bf16, and its
d_x term the bf16 sum over heads of bf16(bf16(e_h) G_h); the edge sums run
in f32, d_x is returned in bf16 (x's dtype), d_s_src and d_s_dst in f32.
Its first launch has a body of its own: G and each d_x term stay bf16
pairs (the term by sm_90's ``mul.rn.bf16x2`` and ``add.rn.bf16x2``, each
rounded once, which gives round_bf16 of the f32 product and sum bit for
bit), and an edge's H x G dot partials are summed across the lanes by
one reduce-scatter with the butterflies' bits
(``tests/test_torch_gat_bwd_bf16_schedule.py``).
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
from snag_tpu_torch.ops.cuda.gat_attention import to_bf16, wide_slice_width

STATS = KernelStats("gat_bwd")
STATS_BF16 = KernelStats("gat_bwd_bf16")
# the wide path's launches (any H and C past the main path's)
STATS_WIDE = KernelStats("gat_bwd_wide")
STATS_BF16_WIDE = KernelStats("gat_bwd_bf16_wide")
# the wide pass (csrc/gat_bwd.cu): groups of 32 slices a lane at most,
# heads whose G rows a warp holds, warps a row at most, rows a block when
# a row takes one warp, and the shared memory of a block
WIDE_GROUPS = 3
WIDE_HEADS = 4
WIDE_WARPS = 16
WIDE_ROWS = 4
WIDE_SMEM = 48 * 1024

Grads = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def gat_backward_twin(x: torch.Tensor, s_src: torch.Tensor,
                      s_dst: torch.Tensor, g_agg: torch.Tensor,
                      g_rs: torch.Tensor, graph: DeviceGraph) -> Grads:
    """Plain-PyTorch version: per-edge terms, ``index_add_`` over the
    edge's column (d_x, d_s_dst) and row (d_s_src); for a bf16 x with the
    Pallas kernel's roundings (module docstring)."""
    n, c = x.shape
    row = graph.row
    col = graph.col.long()
    bf16 = x.dtype == torch.bfloat16
    if bf16:
        s_src, s_dst, g_rs = to_bf16(s_src), to_bf16(s_dst), to_bf16(g_rs)
        x, g_agg = x.to(torch.float32), g_agg.to(torch.float32)
    score = s_src[row] + s_dst[col]                             # (E, H)
    e = torch.exp(-F.leaky_relu(score, negative_slope=0.2))
    g_row = g_agg[row]                                          # (E, H, C)
    d_e = (x[col][:, None, :] * g_row).sum(dim=2) + g_rs[row]
    d_score = -d_e * e * torch.where(score > 0, 1.0, 0.2)
    if bf16:
        d_score = to_bf16(d_score)
        eb = to_bf16(e)
        term = to_bf16(eb[:, 0, None] * g_row[:, 0])
        for h in range(1, g_row.shape[1]):
            term = to_bf16(term + to_bf16(eb[:, h, None] * g_row[:, h]))
    else:
        term = (e[:, :, None] * g_row).sum(dim=1)
    d_x = torch.zeros_like(x).index_add_(0, col, term)
    d_s_dst = torch.zeros_like(s_dst).index_add_(0, col, d_score)
    d_s_src = torch.zeros_like(s_src).index_add_(0, row, d_score)
    if bf16:
        d_x = d_x.to(torch.bfloat16)
    return d_x, d_s_src, d_s_dst


def wide_row_bytes(batch: int, h: int, ng: int) -> int:
    """Shared memory of one row of the wide pass (``wide_row_bytes`` in
    ``csrc/gat_bwd.cu``): the batch's slots, columns, weights, leaky' and
    r, and its (head, group) sums, ``batch + 1`` floats apart."""
    raw = 12 * batch + 12 * h * batch + 4 * h * ng * (batch + 1)
    return -(-raw // 16) * 16


def wide_plan(c: int, h: int, vec: int) -> dict:
    """The wide pass's launch at width C, H heads and slice width vec:
    ``gw`` groups of 32 slices a lane (at most ``WIDE_GROUPS``; a row of at
    most 2 heads of pairs, up to twice as many on one warp) for ``heads``
    heads at a time, ``warps`` warps a row (a block; one warp a row takes
    ``WIDE_ROWS`` rows a block), ``passes`` launches over the columns (more
    than one only past ``WIDE_WARPS`` warps' columns), edge batches of
    ``batch`` (32, or fewer where the shared memory of 32 would pass
    ``WIDE_SMEM``) and that shared memory, ``smem``."""
    groups = -(-(c // vec) // 32)
    pairs = vec == 2 and h <= 2 and WIDE_GROUPS < groups <= 2 * WIDE_GROUPS
    gw = 2 * WIDE_GROUPS if pairs else min(groups, WIDE_GROUPS)
    warps = min(-(-groups // gw), WIDE_WARPS)
    rows = WIDE_ROWS if warps == 1 else 1
    ng = gw * warps
    batch = next((b for b in (32, 16, 8, 4, 2, 1)
                  if rows * wide_row_bytes(b, h, ng) <= WIDE_SMEM), 0)
    if not batch:
        raise ValueError(f"the GAT backward takes no {h} heads at C = {c}: "
                         f"one edge's sums pass {WIDE_SMEM} bytes of shared "
                         "memory")
    return dict(gw=gw, heads=2 if pairs else WIDE_HEADS, warps=warps,
                rows=rows, batch=batch, passes=-(-groups // ng),
                smem=rows * wide_row_bytes(batch, h, ng))


# the backward's slice width: the forward's (both take 2-element slices on
# the wide path)
backward_slice_width = wide_slice_width


def _library():
    built = load_library("gat_bwd")
    for fn in (built.lib.gat_bwd, built.lib.gat_bwd_bf16):
        if fn.argtypes is None:
            fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 7 + [
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
    return built


def gat_backward_cuda(x: torch.Tensor, s_src: torch.Tensor,
                      s_dst: torch.Tensor, g_agg: torch.Tensor,
                      g_rs: torch.Tensor, graph: DeviceGraph) -> Grads:
    """Launch the CUDA kernel; x and g_agg both f32 or both bf16, the
    scores and g_rs f32, the graph int32, every input contiguous and on the
    same CUDA device, and the graph symmetric."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"gat_backward_cuda needs CUDA tensors, got {dev}")
    if not graph.symmetric:
        raise ValueError("the GAT backward kernel needs a symmetric edge "
                         "multiset (build_graph's undirected graph)")
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
    require(g_agg, "g_agg", x.dtype, (n, h, c), dev)
    require(g_rs, "g_rs", torch.float32, (n, h), dev)
    require(graph.row_ptr, "row_ptr", torch.int32, (n + 1,), dev)
    require(graph.col, "col", torch.int32, (graph.n_edges,), dev)
    require(graph.rev, "rev", torch.int64, (graph.n_edges,), dev)

    d_x = torch.empty(n, c, dtype=x.dtype, device=dev)
    d_s_src = torch.empty(n, h, dtype=torch.float32, device=dev)
    d_s_dst = torch.empty(n, h, dtype=torch.float32, device=dev)
    scratch = torch.empty(graph.n_edges, h, dtype=torch.float32, device=dev)
    vec, is_wide = backward_slice_width(c, h, x, g_agg, d_x)
    bf16 = x.dtype == torch.bfloat16
    plan = dict(gw=0, warps=0, batch=0)
    stats = STATS_BF16 if bf16 else STATS
    if is_wide:
        plan = wide_plan(c, h, vec)
        stats = STATS_BF16_WIDE if bf16 else STATS_WIDE
    built = _library()
    entry = "gat_bwd_bf16" if bf16 else "gat_bwd"
    with torch.cuda.device(dev):
        err = getattr(built.lib, entry)(
            ptr(x), ptr(s_src), ptr(s_dst), ptr(g_agg), ptr(g_rs),
            ptr(graph.row_ptr), ptr(graph.col), ptr(graph.rev), ptr(d_x),
            ptr(d_s_src), ptr(d_s_dst), ptr(scratch), n, c, h, vec,
            plan["gw"], plan["warps"], plan["batch"], stream_of(x))
    check(built, err, entry)
    stats.launches += 1
    return d_x, d_s_src, d_s_dst


def fused_gat_backward(x: torch.Tensor, s_src: torch.Tensor,
                       s_dst: torch.Tensor, g_agg: torch.Tensor,
                       g_rs: torch.Tensor, graph: DeviceGraph) -> Grads:
    """Returns (d_x (N, C) in x's dtype, d_s_src (N, H), d_s_dst (N, H)
    f32): the kernel for CUDA tensors, the twin for CPU tensors."""
    if x.device.type == "cuda":
        return gat_backward_cuda(x, s_src, s_dst, g_agg, g_rs, graph)
    if x.device.type != "cpu":
        raise ValueError(f"no GAT backward path for device {x.device}")
    (STATS_BF16 if x.dtype == torch.bfloat16 else STATS).twin_calls += 1
    return gat_backward_twin(x, s_src, s_dst, g_agg, g_rs, graph)
