"""Weighted neighbour aggregation with its own backward.

Port of ``snag_tpu/ops/gat_agg.py::gat_aggregate`` (:62-115).  For every
head h and edge i <- j of the CSR graph:

    agg[i, h, :] = sum_j e[edge, h] * x[j, :]
    rowsum[i, h] = sum_j e[edge, h]

The forward is ``ops/cuda/tile_segment.py``'s weighted segment sum.  The
backward's d_x[j] = sum over edges i <- j of sum_h e[edge, h] g_agg[i, h]
is a reduction over j's in-edges; on the symmetric edge multiset those are
j's CSR row reversed (``DeviceGraph.rev``), so it is the same row kernel
run on g_agg with the weights e[rev], one launch per head.  When e is the
graph's own adjacency ``graph.w`` (the GCN's), e[rev] is ``graph.w_rev``,
gathered once per graph instead of on every backward.  The JAX package
instead reduces over a col-sorted copy of the edges (:89-112).

The GCN's edge weights are the constant adjacency ``graph.w``, so no path
needs d_e: an ``e`` that requires a gradient is refused.

bf16 x and e (the GCN under ``--dtype bfloat16``) follow ``_gat_bwd``'s
rounding points (:89-112): g_agg is rounded to bf16 (:94), each edge's
term e[rev] g of the reverse-edge launch is rounded to bf16 (:104) and
added in f32 (``round_term``), and that launch writes d_x in bf16 (:112,
``out_bf16``: the f32 sum rounded once).  JAX
rounds the sum over heads in bf16 as well; only the GCN, with one head,
reaches this path there, so a bf16 e of more than one head is refused.

``gat_dropout_aggregate`` is the GAT layer under attention dropout in
training (JAX's general path, ``snag_tpu/ops/gnn.py:160-174``): per head
h and edge k = i <- j, e = exp(-leakyrelu_0.2(s_src[i] + s_dst[j])),
rowsum[i] from the undropped e, the dropped e (kept w.p. 1 - p, scaled by
1/(1 - p)) weighting the rows h[j, h], and their sum divided by rowsum.
Every sum over edges runs on the weighted segment sum: a launch per head
for the rows, one narrow launch (C = 1) for the row sums of e.  Its
backward too: d_h is the reverse-edge launch of each head on the dropped
e[rev]; d_e[k] = <h[j], g[i] / rowsum[i]> is a gather and a dot per edge
(in chunks of edges); d_s_src and d_s_dst are the row sums of d_score and
of d_score[rev], one narrow launch.  Nothing is added by atomics, so two
identical steps give identical bits.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from snag_tpu_torch.data.graph import DeviceGraph
from snag_tpu_torch.ops.cuda.tile_segment import weighted_segment_sum


class _GatAggregate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, e, graph):
        ctx.graph = graph
        ctx.save_for_backward(e)
        return weighted_segment_sum(x, e, graph)

    @staticmethod
    def backward(ctx, g_agg, g_rs):
        (e,) = ctx.saved_tensors
        graph = ctx.graph
        e_rev = reverse_weights(e, graph)
        if e.dtype == torch.bfloat16:
            d_x, _ = weighted_segment_sum(
                g_agg[:, 0].to(torch.bfloat16).contiguous(), e_rev, graph,
                round_term=True, out_bf16=True)
            return d_x[:, 0], None, None
        d_x = None
        for h in range(e.shape[1]):
            part, _ = weighted_segment_sum(g_agg[:, h].contiguous(),
                                           e_rev[:, h:h + 1].contiguous(),
                                           graph)
            d_x = part[:, 0] if d_x is None else d_x + part[:, 0]
        return d_x, None, None


def reverse_weights(e: torch.Tensor, graph: DeviceGraph) -> torch.Tensor:
    """e[rev] (E, H): ``graph.w_rev`` (``w_rev_bf16``) when e is the
    graph's adjacency ``graph.w`` (``w_bf16``) as one head (the same
    memory), else gathered."""
    for w, w_rev in ((graph.w, graph.w_rev),
                     (graph.w_bf16, graph.w_rev_bf16)):
        if (w_rev is not None and e.shape == (graph.n_edges, 1)
                and e.device == w.device and e.dtype == w.dtype
                and e.data_ptr() == w.data_ptr()):
            return w_rev[:, None]
    return e[graph.rev]


def gat_aggregate(x: torch.Tensor, e: torch.Tensor, graph: DeviceGraph
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (N, C); e: (E, H) edge weights in CSR order, constant; both f32
    or both bf16 (one head).  Returns (agg (N, H, C) f32, rowsum (N, H)
    f32)."""
    if x.dtype == torch.bfloat16 and e.shape[1] != 1:
        raise NotImplementedError(
            f"gat_aggregate on bf16 operands takes one head (the GCN's), got "
            f"{e.shape[1]}: JAX rounds the backward's sum over heads in bf16 "
            "and no flag runs it (ROADMAP A: bf16 multi-head aggregation)")
    if e.requires_grad:
        raise ValueError("gat_aggregate has no gradient for the edge weights "
                         "e; pass a constant (the GCN's adjacency)")
    if graph.rev is None:
        raise ValueError("gat_aggregate's backward needs the reverse-edge "
                         "permutation of a symmetric edge multiset "
                         "(Graph.rev); this graph has none")
    return _GatAggregate.apply(x.contiguous(), e.contiguous(), graph)


EDGE_CHUNK = 1 << 15    # edges a chunk of d_e's gathers and dots
LEAKY_SLOPE = 0.2


def edge_row_sums(w: torch.Tensor, graph: DeviceGraph) -> torch.Tensor:
    """(N, K) sums of w (E, K) over each CSR row: the segment sum's
    rowsum, from a launch on a one-column x."""
    ones = w.new_ones((graph.n_nodes, 1))
    return weighted_segment_sum(ones, w.contiguous(), graph)[1]


def _head_sums(x: torch.Tensor, e: torch.Tensor,
               graph: DeviceGraph) -> torch.Tensor:
    """(N, H, F): sum over each row's edges of e[k, h] x[col[k], h], a
    launch per head."""
    return torch.stack([
        weighted_segment_sum(x[:, h].contiguous(), e[:, h:h + 1].contiguous(),
                             graph)[0][:, 0]
        for h in range(x.shape[1])], dim=1)


def _edge_dots(x: torch.Tensor, g: torch.Tensor,
               graph: DeviceGraph) -> torch.Tensor:
    """(E, H): <x[col[k], h], g[row[k], h]> for every edge k."""
    out = x.new_empty((graph.n_edges, x.shape[1]))
    for s in range(0, graph.n_edges, EDGE_CHUNK):
        t = min(s + EDGE_CHUNK, graph.n_edges)
        out[s:t] = (x[graph.col[s:t].long()] * g[graph.row[s:t]]).sum(-1)
    return out


def _dropped(e: torch.Tensor, keep: torch.Tensor, rate: float):
    """flax ``nn.Dropout``'s kept values: e / (1 - rate), else 0."""
    return torch.where(keep, e / (1.0 - rate), torch.zeros_like(e))


class _DropoutAggregate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, s_src, s_dst, keep, rate, graph):
        score = s_src[graph.row] + s_dst[graph.col.long()]       # (E, H)
        e = torch.exp(-F.leaky_relu(score, LEAKY_SLOPE))
        rowsum = edge_row_sums(e, graph)
        out = _head_sums(h, _dropped(e, keep, rate), graph) / rowsum[:, :, None]
        ctx.save_for_backward(h, score, e, keep, rowsum, out)
        ctx.rate, ctx.graph = rate, graph
        return out

    @staticmethod
    def backward(ctx, g):
        h, score, e, keep, rowsum, out = ctx.saved_tensors
        rate, graph = ctx.rate, ctx.graph
        n_head = h.shape[1]
        d_agg = g / rowsum[:, :, None]
        d_rowsum = -(g * out).sum(-1) / rowsum
        d_h = _head_sums(d_agg, _dropped(e, keep, rate)[graph.rev], graph)
        d_e = (_dropped(_edge_dots(h, d_agg, graph), keep, rate)
               + d_rowsum[graph.row])
        slope = torch.where(score >= 0, 1.0, LEAKY_SLOPE)
        d_score = -d_e * e * slope
        d_s = edge_row_sums(torch.cat([d_score, d_score[graph.rev]], 1),
                            graph)
        return d_h, d_s[:, :n_head], d_s[:, n_head:], None, None, None


def gat_dropout_aggregate(h: torch.Tensor, s_src: torch.Tensor,
                          s_dst: torch.Tensor, keep: torch.Tensor,
                          rate: float, graph: DeviceGraph) -> torch.Tensor:
    """h (N, H, F), s_src and s_dst (N, H), f32; keep (E, H) bool, the
    attention dropout's mask in CSR edge order.  Returns (N, H, F): each
    head's dropped attention sum over the row's edges divided by the
    undropped attention mass."""
    if graph.rev is None:
        raise ValueError("gat_dropout_aggregate's backward needs the "
                         "reverse-edge permutation of a symmetric edge "
                         "multiset (Graph.rev); this graph has none")
    if h.dtype != torch.float32:
        raise TypeError(f"gat_dropout_aggregate takes f32 rows, got {h.dtype}")
    return _DropoutAggregate.apply(h.contiguous(), s_src, s_dst, keep, rate,
                                   graph)
