"""Whole-layer GAT attention primitive with its own backward.

Port of ``snag_tpu/ops/gat_attn_primitive.py::gat_attention`` (:105-219):
the complete sparse attention + aggregation of a diag-mode GAT layer
(reference SNAG_MMEA/model/layers.py:68-94) as a ``torch.autograd.Function``.
The forward is ``ops/cuda/gat_attention.py`` and the backward
``ops/cuda/gat_bwd.py``: kernels for CUDA tensors, their twins for CPU
tensors.  Both walk the CSR rows and gather x[col] themselves, so the JAX
package's ``[x | s_dst | 1]`` edge block and its residual are never built;
the backward keeps only x, s_src and s_dst.

x may be bf16 (the edge dtype of ``--dtype bfloat16``, JAX gnn.py:127-129)
with f32 scores: the backward then casts the cotangent G to bf16, as
``_build_gm`` builds the ``[G | r | s_src]`` block in x's dtype (JAX
gat_attn_primitive.py:90, :146); the kernels round r and the scores to
bf16 themselves, and d_x comes back in bf16, d_s_* in f32.
"""

from __future__ import annotations

from typing import Tuple

import torch

from snag_tpu_torch.data.graph import DeviceGraph
from snag_tpu_torch.ops.cuda.gat_attention import fused_gat_attention
from snag_tpu_torch.ops.cuda.gat_bwd import fused_gat_backward


class _GATAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, s_src, s_dst, graph):
        ctx.graph = graph
        ctx.save_for_backward(x, s_src, s_dst)
        return fused_gat_attention(x, s_src, s_dst, graph)

    @staticmethod
    def backward(ctx, g_agg, g_rs):
        x, s_src, s_dst = ctx.saved_tensors
        n, c = x.shape
        h = s_src.shape[1]
        g_agg = (x.new_zeros(n, h, c) if g_agg is None
                 else g_agg.to(x.dtype).contiguous())
        g_rs = (s_src.new_zeros(n, h) if g_rs is None
                else g_rs.contiguous())
        d_x, d_s_src, d_s_dst = fused_gat_backward(
            x, s_src, s_dst, g_agg, g_rs, ctx.graph)
        return d_x, d_s_src, d_s_dst, None


def gat_attention(x: torch.Tensor, s_src: torch.Tensor, s_dst: torch.Tensor,
                  graph: DeviceGraph) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (N, C) f32 or bf16; s_src/s_dst: (N, H) f32 attention score
    halves.  Returns (agg (N, H, C) f32, rowsum (N, H) f32)."""
    return _GATAttention.apply(x.contiguous(), s_src.contiguous(),
                               s_dst.contiguous(), graph)
