"""Modality fusion: port of ``snag_tpu/ops/fusion.py``.

``MformerFusion`` is the SNAG fusion transformer over per-entity modality
tokens (reference SNAG_MMEA/model/SNAG_tools.py:23-51 fusion head,
:158-298 BertLayer stack).  Module and parameter names are the reference's
torch names, so a reference state dict loads without renaming.

Training-mode dropout (rate 0.1, hardcoded in the reference) acts at the
sites of JAX fusion.py:157/162 (attention probabilities), :195 (attention
output) and :211 (intermediate output), with masks drawn from the
``dropout_gen`` a forward is given; ``dropout_gen=None`` is deterministic.
The token axis is tiny (M = 3-6), so the attention core is plain batched
``torch.matmul``, which the JAX package also leaves to its compiler.
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from snag_tpu_torch.ops import inits
from snag_tpu_torch.ops.noise import dropout

DROPOUT = 0.1   # every dropout of the reference's BertLayer (SNAG_tools.py)


def l2norm(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """torch F.normalize semantics (norm clamped at eps), with the clamp
    INSIDE the sqrt: the gradient at an exactly-zero row stays finite
    (zero-feature entities project to 0 at init)."""
    sq = torch.sum(x * x, dim=dim, keepdim=True)
    return x / torch.sqrt(torch.clamp(sq, min=eps * eps))


def tlinear(in_features: int, out_features: int, generator: torch.Generator,
            fan_in: Optional[int] = None) -> nn.Linear:
    """``nn.Linear`` with torch's default init drawn from ``generator`` at
    the REFERENCE's fan-in (``_tdense``, fusion.py:101-114): rel_fc's
    reference input is the 1000-column relation bag."""
    fan = in_features if fan_in is None else fan_in
    lin = nn.Linear(in_features, out_features)
    with torch.no_grad():
        lin.weight.copy_(inits.torch_linear((out_features, in_features), fan,
                                            generator))
        lin.bias.copy_(inits.torch_linear((out_features,), fan, generator))
    return lin


class BertSelfAttention(nn.Module):
    """Multi-head self-attention over the modality-token axis
    (SNAG_tools.py:158-209)."""

    def __init__(self, hidden_size: int, num_heads: int,
                 generator: torch.Generator):
        super().__init__()
        if hidden_size % num_heads:
            raise ValueError(f"hidden_size {hidden_size} is not a multiple "
                             f"of num_heads {num_heads}")
        self.num_heads = num_heads
        self.query = tlinear(hidden_size, hidden_size, generator)
        self.key = tlinear(hidden_size, hidden_size, generator)
        self.value = tlinear(hidden_size, hidden_size, generator)

    def forward(self, hidden: torch.Tensor,
                dropout_gen: Optional[torch.Generator] = None):
        n, m, d = hidden.shape
        h = self.num_heads
        dh = d // h

        def split(t):  # (N, M, d) -> (N, H, M, dh)
            return t.reshape(n, m, h, dh).transpose(1, 2)

        q = split(self.query(hidden))
        k = split(self.key(hidden))
        v = split(self.value(hidden))
        scores = torch.matmul(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(dh))
        probs = torch.softmax(scores, dim=-1)                 # (N, H, M, M)
        ctx = torch.matmul(dropout(probs, DROPOUT, dropout_gen), v)
        return ctx.transpose(1, 2).reshape(n, m, d), probs


class BertSelfOutput(nn.Module):
    def __init__(self, in_size: int, hidden_size: int,
                 generator: torch.Generator):
        super().__init__()
        self.dense = tlinear(in_size, hidden_size, generator)
        self.LayerNorm = nn.LayerNorm(hidden_size, eps=1e-12)

    def forward(self, x, residual, dropout_gen=None):
        out = dropout(self.dense(x), DROPOUT, dropout_gen)
        return self.LayerNorm(out + residual)


class BertAttention(nn.Module):
    def __init__(self, hidden_size: int, num_heads: int,
                 generator: torch.Generator):
        super().__init__()
        self.self = BertSelfAttention(hidden_size, num_heads, generator)
        self.output = BertSelfOutput(hidden_size, hidden_size, generator)

    def forward(self, hidden, dropout_gen=None):
        ctx, probs = self.self(hidden, dropout_gen)
        return self.output(ctx, hidden, dropout_gen), probs


class BertIntermediate(nn.Module):
    def __init__(self, hidden_size: int, intermediate_size: int,
                 generator: torch.Generator):
        super().__init__()
        self.dense = tlinear(hidden_size, intermediate_size, generator)

    def forward(self, x):
        return F.gelu(self.dense(x))          # exact (erf) GELU


class BertLayer(nn.Module):
    """Attention + residual LN (+ optional GELU intermediate) block
    (SNAG_tools.py:268-298); LN eps 1e-12."""

    def __init__(self, hidden_size: int, num_heads: int,
                 intermediate_size: int, use_intermediate: bool,
                 generator: torch.Generator):
        super().__init__()
        self.attention = BertAttention(hidden_size, num_heads, generator)
        self.use_intermediate = use_intermediate
        if use_intermediate:
            self.intermediate = BertIntermediate(hidden_size,
                                                 intermediate_size, generator)
            self.output = BertSelfOutput(intermediate_size, hidden_size,
                                         generator)

    def forward(self, hidden, dropout_gen=None):
        attention_output, probs = self.attention(hidden, dropout_gen)
        if not self.use_intermediate:
            return attention_output, probs
        out = self.output(self.intermediate(attention_output),
                          attention_output, dropout_gen)
        return out, probs


class MformerFusion(nn.Module):
    """SNAG fusion: transformer over modality tokens + two joint paths.

    Returns (joint_emb, joint_emb_fz, hidden_states, weight_norm, weight_fz):
    * ``weight_norm`` — per-entity modality weights from the LAST layer's
      attention: softmax(sum_heads sum_queries attn / sqrt(M*H))
      (SNAG_tools.py:41-43);
    * ``joint_emb``   — attention-weighted concat of normalized input embs;
    * ``joint_emb_fz`` — global learnable-weight path via ``weight_raw``
      (softmax over the full 6-slot vector, SNAG_tools.py:46-49).
    """

    def __init__(self, hidden_size: int, num_heads: int, num_layers: int,
                 intermediate_size: int, use_intermediate: bool,
                 generator: torch.Generator):
        super().__init__()
        self.num_heads = num_heads
        self.fusion_layer = nn.ModuleList(
            BertLayer(hidden_size, num_heads, intermediate_size,
                      use_intermediate, generator)
            for _ in range(num_layers))
        self.weight_raw = nn.Parameter(torch.ones(6))

    def forward(self, embs: List[Optional[torch.Tensor]],
                dropout_gen: Optional[torch.Generator] = None):
        active = [e for e in embs if e is not None]
        modal_num = len(active)
        hidden = torch.stack(active, dim=1)                   # (N, M, d)
        probs = None
        for layer in self.fusion_layer:
            hidden, probs = layer(hidden, dropout_gen)

        attention_pro = probs.sum(dim=1)                      # (N, M, M)
        attention_pro_comb = attention_pro.sum(dim=-2) / math.sqrt(
            modal_num * self.num_heads)                       # (N, M)
        weight_norm = torch.softmax(attention_pro_comb, dim=-1)

        normed = [l2norm(e) for e in active]
        joint_emb = torch.cat(
            [weight_norm[:, i:i + 1] * normed[i] for i in range(modal_num)],
            dim=1)
        # softmax spans all 6 slots even when fewer are active
        # (SNAG_tools.py:46: softmax over the full parameter)
        weight_fz = torch.softmax(self.weight_raw, dim=0)
        joint_emb_fz = torch.cat(
            [weight_fz[i] * normed[i] for i in range(modal_num)], dim=1)
        return joint_emb, joint_emb_fz, hidden, weight_norm, weight_fz
