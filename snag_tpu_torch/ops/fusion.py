"""Modality fusion: port of ``snag_tpu/ops/fusion.py``.

``MformerFusion`` is the SNAG fusion transformer over per-entity modality
tokens (reference SNAG_MMEA/model/SNAG_tools.py:23-51 fusion head,
:158-298 BertLayer stack); with ``with_fz=False`` it is MEAformer's
single-path variant, without ``weight_raw`` (MEAformer_tools.py:25-72).
``MeanFusion`` is MCLEA's learnable-softmax weighted mean
(MCLEA_tools.py:20-38).  Module and parameter names are the reference's
torch names, so a reference state dict loads without renaming.

Training-mode dropout (rate 0.1, hardcoded in the reference) acts at the
sites of JAX fusion.py:157/162 (attention probabilities), :195 (attention
output) and :211 (intermediate output), with masks drawn from the
``dropout_gen`` a forward is given; ``dropout_gen=None`` is deterministic.
The token axis is tiny (M = 3-6), so the attention core is plain batched
``torch.matmul``, which the JAX package also leaves to its compiler.

Compute dtype: every module takes ``dtype`` (float32 or bfloat16), the
flax ``Dense(dtype=...)`` / ``LayerNorm(dtype=...)`` semantics of the JAX
package under ``--dtype bfloat16``: parameters stay f32; a linear layer
casts its input, weight and bias to bf16, its product is bf16 and the bias
is added in bf16 (fusion.py:101-114); the attention scores and
probabilities are f32 and the probabilities are cast to bf16 before the
context product (``_tiny_scores_ctx``, :58-66); LayerNorm computes from
the bf16 sum in f32 and returns bf16 (:196-213); the token stack is cast
to the compute dtype (:242-244).  The rounding points are those, set
explicitly (no autocast).
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


class Linear(nn.Linear):
    """``nn.Linear`` with a compute dtype and f32 parameters (flax
    ``Dense(dtype=...)``): in bf16, x W^T is a bf16 product of bf16
    operands and the bf16 bias is added to it in bf16."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt == torch.float32:
            return super().forward(x)
        return F.linear(x.to(dt), self.weight.to(dt)) + self.bias.to(dt)


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` with a compute dtype and f32 parameters (flax
    ``LayerNorm(dtype=...)``): in bf16 the statistics and the affine map
    run in f32 on the bf16 input and the result is bf16."""

    def __init__(self, size: int, eps: float,
                 dtype: torch.dtype = torch.float32):
        super().__init__(size, eps=eps)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.compute_dtype == torch.float32:
            return super().forward(x)
        return F.layer_norm(x.to(torch.float32), self.normalized_shape,
                            self.weight, self.bias,
                            self.eps).to(self.compute_dtype)


def tlinear(in_features: int, out_features: int, generator: torch.Generator,
            fan_in: Optional[int] = None,
            dtype: torch.dtype = torch.float32) -> Linear:
    """``Linear`` with torch's default init drawn from ``generator`` at
    the REFERENCE's fan-in (``_tdense``, fusion.py:101-114): rel_fc's
    reference input is the 1000-column relation bag."""
    fan = in_features if fan_in is None else fan_in
    lin = Linear(in_features, out_features, dtype)
    with torch.no_grad():
        lin.weight.copy_(inits.torch_linear((out_features, in_features), fan,
                                            generator))
        lin.bias.copy_(inits.torch_linear((out_features,), fan, generator))
    return lin


class BertSelfAttention(nn.Module):
    """Multi-head self-attention over the modality-token axis
    (SNAG_tools.py:158-209)."""

    def __init__(self, hidden_size: int, num_heads: int,
                 generator: torch.Generator,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if hidden_size % num_heads:
            raise ValueError(f"hidden_size {hidden_size} is not a multiple "
                             f"of num_heads {num_heads}")
        self.num_heads = num_heads
        self.query = tlinear(hidden_size, hidden_size, generator, dtype=dtype)
        self.key = tlinear(hidden_size, hidden_size, generator, dtype=dtype)
        self.value = tlinear(hidden_size, hidden_size, generator, dtype=dtype)

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
        # scores and probabilities in f32 whatever the compute dtype
        scores = torch.matmul(q.to(torch.float32),
                              k.to(torch.float32).transpose(-1, -2)) * (
            1.0 / math.sqrt(dh))
        probs = torch.softmax(scores, dim=-1)                 # (N, H, M, M)
        ctx = torch.matmul(dropout(probs, DROPOUT, dropout_gen).to(v.dtype), v)
        return ctx.transpose(1, 2).reshape(n, m, d), probs


class BertSelfOutput(nn.Module):
    def __init__(self, in_size: int, hidden_size: int,
                 generator: torch.Generator,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dense = tlinear(in_size, hidden_size, generator, dtype=dtype)
        self.LayerNorm = LayerNorm(hidden_size, 1e-12, dtype)

    def forward(self, x, residual, dropout_gen=None):
        out = dropout(self.dense(x), DROPOUT, dropout_gen)
        return self.LayerNorm(out + residual)


class BertAttention(nn.Module):
    def __init__(self, hidden_size: int, num_heads: int,
                 generator: torch.Generator,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.self = BertSelfAttention(hidden_size, num_heads, generator,
                                      dtype)
        self.output = BertSelfOutput(hidden_size, hidden_size, generator,
                                     dtype)

    def forward(self, hidden, dropout_gen=None):
        ctx, probs = self.self(hidden, dropout_gen)
        return self.output(ctx, hidden, dropout_gen), probs


class BertIntermediate(nn.Module):
    def __init__(self, hidden_size: int, intermediate_size: int,
                 generator: torch.Generator,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dense = tlinear(hidden_size, intermediate_size, generator,
                             dtype=dtype)

    def forward(self, x):
        return F.gelu(self.dense(x))          # exact (erf) GELU


class BertLayer(nn.Module):
    """Attention + residual LN (+ optional GELU intermediate) block
    (SNAG_tools.py:268-298); LN eps 1e-12."""

    def __init__(self, hidden_size: int, num_heads: int,
                 intermediate_size: int, use_intermediate: bool,
                 generator: torch.Generator,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.attention = BertAttention(hidden_size, num_heads, generator,
                                       dtype)
        self.use_intermediate = use_intermediate
        if use_intermediate:
            self.intermediate = BertIntermediate(
                hidden_size, intermediate_size, generator, dtype)
            self.output = BertSelfOutput(intermediate_size, hidden_size,
                                         generator, dtype)

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
      (softmax over the full 6-slot vector, SNAG_tools.py:46-49).  With
      ``with_fz=False`` (MEAformer) there is no such path: ``joint_emb_fz``
      and ``weight_fz`` are None and the module has no ``weight_raw``.
    """

    def __init__(self, hidden_size: int, num_heads: int, num_layers: int,
                 intermediate_size: int, use_intermediate: bool,
                 generator: torch.Generator,
                 dtype: torch.dtype = torch.float32, with_fz: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.compute_dtype = dtype
        self.fusion_layer = nn.ModuleList(
            BertLayer(hidden_size, num_heads, intermediate_size,
                      use_intermediate, generator, dtype)
            for _ in range(num_layers))
        self.weight_raw = nn.Parameter(torch.ones(6)) if with_fz else None

    def forward(self, embs: List[Optional[torch.Tensor]],
                dropout_gen: Optional[torch.Generator] = None):
        active = [e for e in embs if e is not None]
        modal_num = len(active)
        # the stack in the compute dtype (the GAT's rows arrive f32)
        hidden = torch.stack([e.to(self.compute_dtype) for e in active],
                             dim=1)                           # (N, M, d)
        probs = None
        for layer in self.fusion_layer:
            hidden, probs = layer(hidden, dropout_gen)

        attention_pro = probs.sum(dim=1)                      # (N, M, M)
        attention_pro_comb = attention_pro.sum(dim=-2) / math.sqrt(
            modal_num * self.num_heads)                       # (N, M)
        weight_norm = torch.softmax(attention_pro_comb, dim=-1)

        # each modality normalised in its own dtype, then weighted in f32
        # (JAX promotes f32 weights times bf16 rows to f32)
        normed = [l2norm(e).to(torch.float32) for e in active]
        joint_emb = torch.cat(
            [weight_norm[:, i:i + 1] * normed[i] for i in range(modal_num)],
            dim=1)
        if self.weight_raw is None:
            return joint_emb, None, hidden, weight_norm, None
        # softmax spans all 6 slots even when fewer are active
        # (SNAG_tools.py:46: softmax over the full parameter)
        weight_fz = torch.softmax(self.weight_raw, dim=0)
        joint_emb_fz = torch.cat(
            [weight_fz[i] * normed[i] for i in range(modal_num)], dim=1)
        return joint_emb, joint_emb_fz, hidden, weight_norm, weight_fz


class MeanFusion(nn.Module):
    """MCLEA's MultiModalFusion (MCLEA_tools.py:20-38): softmax-weighted
    normalised embeddings, stacked and mean-pooled.  The softmax spans all
    ``modal_num`` slots; absent (None) embeddings are dropped after the
    weighting, as the reference's list comprehension drops them.  The
    result is f32 (f32 weights times the rows, as JAX promotes them)."""

    def __init__(self, modal_num: int):
        super().__init__()
        self.modal_num = modal_num
        self.weight = nn.Parameter(torch.ones(modal_num, 1))

    def forward(self, embs: List[Optional[torch.Tensor]]) -> torch.Tensor:
        weight_norm = torch.softmax(self.weight, dim=0)
        parts = [weight_norm[i] * l2norm(embs[i])
                 for i in range(self.modal_num) if embs[i] is not None]
        return torch.stack(parts, dim=1).mean(dim=1)
