"""Graph encoders over the CSR edge list: GCN and multi-head sparse GAT.

Port of ``snag_tpu/ops/gnn.py``: ``GraphConvolution`` and ``GCN`` (:30-75)
and the diag hot path of the GAT (``MultiHeadGraphAttention`` :95-132 and
``GAT`` :177-218), following the reference layers
(SNAG_MMEA/model/layers.py:35-133, model/Tool_model.py:61-110,
EVA_tools.py:52-63).  Parameter names are the reference's:
``gc{1,2}.weight`` (in, out) and ``gc{1,2}.bias``;
``layer_stack.{i}.w`` (H, 1, F) and ``layer_stack.{i}.a_src_dst`` (H, 2F, 1).

With ``--instance_normalization`` the GAT first applies ``InstanceNorm``
(``norm.weight``, ``norm.bias``; the JAX package's ``in_scale`` and
``in_bias``).

Dropout is drawn from an explicit ``torch.Generator``: a forward given
``dropout_gen=None`` is deterministic (the JAX package's
``deterministic=True``).  A GAT layer in training with ``--attn_dropout``
above 0 takes JAX's general path (gnn.py:153-174): the dropped attention
of ``ops/gat_agg.gat_dropout_aggregate`` on the weighted segment sum;
otherwise, and in evaluation, the fused GAT kernels.

``dtype`` (GCN): under ``--dtype bfloat16`` a GCN layer's ``support`` is
the bf16 product of bf16 x and W (f32 accumulation, ``ops/fusion.Linear``'s
GEMM), summed with the bf16 adjacency ``graph.w_bf16`` into f32, then the
f32 bias is added (gnn.py:43-52); its backward follows ``ops/gat_agg.py``.

``dtype`` (GAT): under ``--dtype bfloat16`` the JAX package's GAT stays
f32 but for the rows its edges gather: the attention scores come from the
f32 x, and x enters the attention primitive as bf16 (gnn.py:121-133), whose
kernels then follow the Pallas rounding points.  The output is f32.
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from snag_tpu_torch.data.graph import DeviceGraph
from snag_tpu_torch.ops import inits
from snag_tpu_torch.ops.gat_agg import gat_aggregate, gat_dropout_aggregate
from snag_tpu_torch.ops.gat_attn_primitive import gat_attention
from snag_tpu_torch.ops.noise import dropout, keep_mask


class GraphConvolution(nn.Module):
    """One GCN layer: out = A_norm (x W) + b (layers.py:102-133); weight
    and bias ~ U(-1/sqrt(out), 1/sqrt(out)), f32 in either dtype."""

    def __init__(self, in_features: int, out_features: int,
                 generator: torch.Generator,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        stdv = 1.0 / math.sqrt(out_features)
        self.weight = nn.Parameter(inits.uniform_stdv(
            (in_features, out_features), stdv, generator))
        self.bias = nn.Parameter(inits.uniform_stdv(
            (out_features,), stdv, generator))

    def forward(self, x: torch.Tensor, graph: DeviceGraph) -> torch.Tensor:
        dt = self.compute_dtype
        if dt == torch.float32:
            support, w = x @ self.weight, graph.w
        else:
            support, w = x.to(dt) @ self.weight.to(dt), graph.w_bf16
        agg, _ = gat_aggregate(support, w[:, None], graph)
        return agg[:, 0, :] + self.bias


class GCN(nn.Module):
    """2-layer GCN: relu -> dropout -> layer (EVA_tools.py:52-63)."""

    def __init__(self, nfeat: int, nhid: int, nout: int,
                 generator: torch.Generator, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dropout = dropout
        self.gc1 = GraphConvolution(nfeat, nhid, generator, dtype)
        self.gc2 = GraphConvolution(nhid, nout, generator, dtype)

    def forward(self, x: torch.Tensor, graph: DeviceGraph,
                dropout_gen: Optional[torch.Generator] = None) -> torch.Tensor:
        x = F.relu(self.gc1(x, graph))
        x = dropout(x, self.dropout, dropout_gen)
        return self.gc2(x, graph)


class MultiHeadGraphAttention(nn.Module):
    """Sparse GAT layer, all heads at once (layers.py:35-100), diag mode:
    the projection is an elementwise per-head scale ``w`` (ones-initialized)
    and the attention vector a ~ U(-1/sqrt(2F), 1/sqrt(2F))
    (layers.py:60-63)."""

    def __init__(self, n_head: int, f_in: int, f_out: int,
                 generator: torch.Generator, attn_dropout: float = 0.0,
                 diag: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.edge_dtype = dtype
        if not diag:
            raise NotImplementedError("non-diag GAT is not ported")
        if f_in != f_out:
            raise ValueError(f"diag GAT needs f_in == f_out, got {f_in}, {f_out}")
        self.n_head, self.f_out = n_head, f_out
        self.attn_dropout = attn_dropout
        self.w = nn.Parameter(torch.ones(n_head, 1, f_out))
        self.a_src_dst = nn.Parameter(inits.uniform_stdv(
            (n_head, 2 * f_out, 1), 1.0 / math.sqrt(2 * f_out), generator))

    def forward(self, x: torch.Tensor, graph: DeviceGraph,
                dropout_gen: Optional[torch.Generator] = None) -> torch.Tensor:
        f = self.f_out
        wh = self.w[:, 0, :]                                  # (H, F)
        a_src = self.a_src_dst[:, :f, 0]
        a_dst = self.a_src_dst[:, f:, 0]
        if dropout_gen is not None and self.attn_dropout > 0:
            return self._dropout_forward(x, graph, dropout_gen, a_src, a_dst)
        # score of edge (i <- j) is h_i.a_src + h_j.a_dst; with the diag
        # projection both halves reduce to x @ (w_h * a_h)
        s_src = x @ (wh * a_src).T                            # (N, H)
        s_dst = x @ (wh * a_dst).T
        # the scores from the f32 x, the gathered rows in the edge dtype
        agg, rowsum = gat_attention(x.to(self.edge_dtype), s_src, s_dst,
                                    graph)
        # the diag projection commutes out of the neighbour sum
        agg = agg * wh[None, :, :]                            # (N, H, F)
        return agg / rowsum[:, :, None]

    def _dropout_forward(self, x, graph, dropout_gen, a_src, a_dst):
        """Training under attention dropout (JAX gnn.py:153-174): the
        projected rows h = x w_h in the compute dtype, then f32, their
        scores, and the dropped aggregation of ``gat_dropout_aggregate``."""
        dt = self.edge_dtype
        h = (x[:, None, :].to(dt) * self.w[:, 0, :][None].to(dt)
             ).to(torch.float32)                              # (N, H, F)
        s_src = torch.einsum("nhf,hf->nh", h, a_src)
        s_dst = torch.einsum("nhf,hf->nh", h, a_dst)
        keep = keep_mask((graph.n_edges, self.n_head), self.attn_dropout,
                         dropout_gen, x.device)
        return gat_dropout_aggregate(h, s_src, s_dst, keep, self.attn_dropout,
                                     graph)


class InstanceNorm(nn.Module):
    """``--instance_normalization``: the JAX package's affine over
    feature-channel statistics before the GAT stack (gnn.py:191-197),
    standing in for the reference's ``InstanceNorm1d(momentum=0,
    affine=True)``: (x - mean) / sqrt(var + 1e-5) * weight + bias, with the
    mean and population variance of each column over the rows; weight
    (JAX ``in_scale``) starts at ones, bias (``in_bias``) at zeros."""

    def __init__(self, num_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=0, keepdim=True)
        var = x.var(dim=0, unbiased=False, keepdim=True)
        return (x - mean) / torch.sqrt(var + 1e-5) * self.weight + self.bias


class GAT(nn.Module):
    """Stacked diag GAT with head-mean and ELU between layers
    (Tool_model.py:61-110), after ``InstanceNorm`` (``norm``) with
    ``instance_normalization``."""

    def __init__(self, n_units: List[int], n_heads: List[int],
                 generator: torch.Generator, dropout: float = 0.0,
                 attn_dropout: float = 0.0,
                 instance_normalization: bool = False, diag: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm = InstanceNorm(n_units[0]) if instance_normalization \
            else None
        self.dropout = dropout
        num_layer = len(n_units) - 1
        self.layer_stack = nn.ModuleList(
            MultiHeadGraphAttention(
                n_heads[i], n_units[i], n_units[i + 1], generator,
                attn_dropout=attn_dropout, diag=diag, dtype=dtype)
            for i in range(num_layer))

    def forward(self, x: torch.Tensor, graph: DeviceGraph,
                dropout_gen: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.norm is not None:
            x = self.norm(x)
        last = len(self.layer_stack) - 1
        for i, layer in enumerate(self.layer_stack):
            # input dropout of every layer but the last (gnn.py:202-203)
            if i < last:
                x = dropout(x, self.dropout, dropout_gen)
            x = layer(x, graph, dropout_gen).mean(dim=1)
            if i < last:
                x = F.elu(x)
        return x
