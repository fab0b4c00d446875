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
"""

from __future__ import annotations

from typing import Tuple

import torch

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
