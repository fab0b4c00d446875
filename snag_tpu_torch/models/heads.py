"""Small shared heads (reference: SNAG_MMEA/model/layers.py:135-148).

Port of ``snag_tpu/models/heads.py``: ``ProjectionHead``, two bias-free
linear layers with a ReLU and dropout between them, under the reference
names ``l1`` and ``l2``.  Weights draw torch's ``nn.Linear`` default from
an explicit generator.  The head computes in f32 whatever its input's
dtype (flax ``Dense`` without a dtype promotes a bf16 input to its f32
kernel's dtype).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from snag_tpu_torch.ops import inits
from snag_tpu_torch.ops.noise import dropout


def _bias_free(in_features: int, out_features: int,
               generator: torch.Generator) -> nn.Linear:
    lin = nn.Linear(in_features, out_features, bias=False)
    with torch.no_grad():
        lin.weight.copy_(inits.torch_linear((out_features, in_features),
                                            in_features, generator))
    return lin


class ProjectionHead(nn.Module):
    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 generator: torch.Generator, dropout: float = 0.0):
        super().__init__()
        self.l1 = _bias_free(in_dim, hidden_dim, generator)
        self.l2 = _bias_free(hidden_dim, out_dim, generator)
        self.dropout = dropout

    def forward(self, x: torch.Tensor,
                dropout_gen: Optional[torch.Generator] = None) -> torch.Tensor:
        x = F.relu(self.l1(x.to(self.l1.weight.dtype)))
        x = dropout(x, self.dropout, dropout_gen)
        return self.l2(x)
