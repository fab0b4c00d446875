"""Whole-layer GAT attention primitive (forward).

Port of the forward of ``snag_tpu/ops/gat_attn_primitive.py::gat_attention``
(:105-124): the complete sparse attention + aggregation of a diag-mode GAT
layer (reference SNAG_MMEA/model/layers.py:68-94).  The kernel walks the
CSR rows and gathers x[col] itself, so the JAX package's ``[x | s_dst | 1]``
edge block is never built.

The backward kernel (``snag_tpu/ops/pallas/gat_bwd.py``) is not ported
yet, so a CUDA call that would need a gradient raises instead of
differentiating through the plain twin.
"""

from __future__ import annotations

from typing import Tuple

import torch

from snag_tpu_torch.data.graph import DeviceGraph
from snag_tpu_torch.ops.cuda.gat_attention import fused_gat_attention


def gat_attention(x: torch.Tensor, s_src: torch.Tensor, s_dst: torch.Tensor,
                  graph: DeviceGraph) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (N, C); s_src/s_dst: (N, H) attention score halves.
    Returns (agg (N, H, C) f32, rowsum (N, H) f32)."""
    if (x.device.type == "cuda" and torch.is_grad_enabled()
            and (x.requires_grad or s_src.requires_grad
                 or s_dst.requires_grad)):
        raise NotImplementedError(
            "GAT attention backward on CUDA needs the port of "
            "snag_tpu/ops/pallas/gat_bwd.py::fused_gat_backward_row, which "
            "is not written yet; run under torch.no_grad()")
    return fused_gat_attention(x, s_src, s_dst, graph)
