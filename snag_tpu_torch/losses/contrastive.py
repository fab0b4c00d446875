"""Intra-modal contrastive loss (ICL, NT-Xent) over link batches.

Port of the NT-Xent part of ``snag_tpu/losses/contrastive.py``: the batched
core ``_icl_xent_batched`` (:77-201, its streaming branch), ``icl_loss``'s
simple route (:269-278), ``icl_loss_multi`` (:343), ``icl_loss_stacked``
(:370) and SNAG's fused bundle ``snag_bundle_losses`` (:411-533, its
streaming branch).  Reference: SNAG_MMEA/model/SNAG_loss.py:31-128.

An optional ``valid`` mask lets capacity-padded batches compute the value
the reference gets from its ragged last batch: invalid rows leave the
numerator and the denominator, and their columns leave the negative pool.

The core is a ``torch.autograd.Function`` whose forward is the streaming
row-logsumexp and whose backward the streaming gradient
(``ops/cuda/ntxent.py``): kernels for CUDA tensors, dense twins for CPU
tensors.  Only the (M, B) row statistics are kept for the backward.  The
bundle is the same over the mixture kernels (``ops/cuda/snag_loss.py``).
Rows must be L2-normalised (the kernels' static max).

``matmul_dtype`` (bf16 under ``--dtype bfloat16``, JAX snag.py:86-87): the
unit rows are cast to it after the l2norm (contrastive.py:257-261,
364-366, 384-386) and the kernels take bf16 operands; the positives, row
statistics and losses stay f32 (bf16 products are exact in f32), and the
gradients are returned in the rows' dtype (:150, :496-500).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from snag_tpu_torch.ops.cuda.ntxent import (stack, streaming_lse,
                                            streaming_ntxent_grad)
from snag_tpu_torch.ops.cuda.snag_loss import mixture_grad, mixture_lse
from snag_tpu_torch.ops.fusion import l2norm


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32)


def _pos_diag(zis: torch.Tensor, zjs: torch.Tensor, tau: float):
    """Positive-pair similarities: pos[m, i] = zis_i . zjs_i / tau, in f32
    (preferred_element_type=f32)."""
    return torch.einsum("mbd,mbd->mb", _f32(zis), _f32(zjs)) / tau


class _ICLXentBatched(torch.autograd.Function):
    """(M,) NT-Xent losses over M batches of paired rows (contrastive.py
    :109-151, streaming branch)."""

    @staticmethod
    def forward(ctx, zis, zjs, w_min, valid, tau, ab_weight):
        b = zis.shape[1]
        lse_a, lse_b = streaming_lse(zis, zjs, tau, valid)
        pos = _pos_diag(zis, zjs, tau)
        # invalid rows get a finite per-row value here; vf zeroes them
        per_a, per_b = lse_a - pos, lse_b - pos
        if valid is not None:
            vf = valid.to(torch.float32)
            denom = torch.clamp(vf.sum(), min=1.0)
        else:
            vf = torch.ones(b, dtype=torch.float32, device=zis.device)
            denom = torch.tensor(float(b), device=zis.device)
        w = vf[None, :] if w_min is None else w_min * vf[None, :]
        loss = (ab_weight * (per_a * w).sum(dim=1)
                + (1 - ab_weight) * (per_b * w).sum(dim=1)) / denom
        ctx.tau, ctx.ab_weight = tau, ab_weight
        ctx.save_for_backward(zis, zjs, w_min, valid, per_a, per_b, vf,
                              denom)
        return loss

    @staticmethod
    def backward(ctx, g):
        zis, zjs, w_min, valid, per_a, per_b, vf, denom = ctx.saved_tensors
        tau, ab = ctx.tau, ctx.ab_weight
        pos = _pos_diag(zis, zjs, tau)
        w = vf[None, :] if w_min is None else w_min * vf[None, :]
        ca = (g[:, None] * ab) * w / denom                      # (M, B)
        cb = (g[:, None] * (1 - ab)) * w / denom
        d_zis, d_zjs = streaming_ntxent_grad(
            zis, zjs, per_a + pos, per_b + pos, ca, cb, tau, valid)
        d_w = None
        if w_min is not None and ctx.needs_input_grad[2]:
            base = (ab * per_a + (1 - ab) * per_b) * vf[None, :]
            d_w = g[:, None] * base / denom
        return (d_zis.to(zis.dtype), d_zjs.to(zjs.dtype), d_w, None, None,
                None)


def icl_xent_batched(zis: torch.Tensor, zjs: torch.Tensor,
                     w_min: Optional[torch.Tensor],
                     valid: Optional[torch.Tensor], tau: float,
                     ab_weight: float) -> torch.Tensor:
    """zis/zjs (M, B, d) unit rows; w_min (M, B) or None; valid (B,) bool
    or None.  Returns the (M,) losses."""
    return _ICLXentBatched.apply(zis.contiguous(), zjs.contiguous(), w_min,
                                 valid, tau, ab_weight)


def _cast(zis, zjs, matmul_dtype):
    if matmul_dtype is None:
        return zis, zjs
    return zis.to(matmul_dtype), zjs.to(matmul_dtype)


def icl_loss(emb: torch.Tensor, links: torch.Tensor, tau: float = 0.1,
             ab_weight: float = 0.5,
             weight_norm: Optional[torch.Tensor] = None,
             valid: Optional[torch.Tensor] = None, neg_l=None, neg_r=None,
             norm: bool = True, with_replay_mining: bool = False,
             inversion: bool = False,
             matmul_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Intra-modal NT-Xent over a link batch (SNAG_loss.py:58-128), simple
    route only: the batched core with M = 1."""
    if neg_l is not None or neg_r is not None or with_replay_mining \
            or inversion:
        raise NotImplementedError(
            "icl_loss with replay negatives, mining or inversion "
            "(MEAformer's replay path) is not ported: ROADMAP A: the other "
            "families")
    if norm:
        emb = l2norm(emb)
    zis, zjs = _cast(emb[links[:, 0]], emb[links[:, 1]], matmul_dtype)
    w_min = None
    if weight_norm is not None:
        w_min = torch.minimum(weight_norm[links[:, 0]],
                              weight_norm[links[:, 1]])[None]
    return icl_xent_batched(zis[None], zjs[None], w_min, valid, tau,
                            ab_weight)[0]


def icl_loss_multi(embs: torch.Tensor, links: torch.Tensor, tau: float = 0.1,
                   ab_weight: float = 0.5,
                   w_min: Optional[torch.Tensor] = None,
                   valid: Optional[torch.Tensor] = None,
                   matmul_dtype: Optional[torch.dtype] = None
                   ) -> torch.Tensor:
    """M independent ICL losses in one batched computation.

    embs: (M, N, d) already L2-normalised rows; w_min: (M, B) per-row
    weights or None.  Returns (M,) losses."""
    zis, zjs = _cast(embs[:, links[:, 0], :], embs[:, links[:, 1], :],
                     matmul_dtype)
    return icl_xent_batched(zis, zjs, w_min, valid, tau, ab_weight)


def icl_loss_stacked(emb_list: Sequence[torch.Tensor], links: torch.Tensor,
                     tau: float = 0.1, ab_weight: float = 0.5,
                     valid: Optional[torch.Tensor] = None,
                     matmul_dtype: Optional[torch.dtype] = None
                     ) -> torch.Tensor:
    """Sum of independent ICL losses over several equally wide embedding
    tables, batched through one core call: SNAG's GMI = icl(joint) +
    icl(joint_fz) (SNAG.py:106)."""
    zis, zjs = _cast(torch.stack([l2norm(e[links[:, 0]]) for e in emb_list]),
                     torch.stack([l2norm(e[links[:, 1]]) for e in emb_list]),
                     matmul_dtype)
    return icl_xent_batched(zis, zjs, None, valid, tau, ab_weight).sum()


def _bundle_pos(zis, zjs, a_i, a_j, beta, tau):
    """(M + 2, B) positive-pair logits of every channel, in f32."""
    posk = torch.einsum("mbd,mbd->mb", _f32(zis), _f32(zjs))
    pos_a = torch.einsum("bm,bm,mb->b", a_i, a_j, posk)
    pos_f = torch.einsum("m,mb->b", beta, posk)
    return torch.cat([posk, pos_a[None], pos_f[None]], dim=0) / tau


def _bundle_weights(w_min, valid, m, b, device):
    """(row weights (M + 2, B), validity (B,) f32, denominator)."""
    if valid is None:
        vf = torch.ones(b, dtype=torch.float32, device=device)
        denom = torch.tensor(float(b), device=device)
    else:
        vf = valid.to(torch.float32)
        denom = torch.clamp(vf.sum(), min=1.0)
    wm = torch.ones(m, b, device=device) if w_min is None else w_min
    wt = torch.cat([wm * vf[None, :], vf[None, :], vf[None, :]], dim=0)
    return wt, vf, denom


class _BundleStreamed(torch.autograd.Function):
    """(M + 2,) bundle losses (contrastive.py:443-512): forward
    ``mixture_lse``, backward ``mixture_grad``; d w_min outside the kernel
    (:501-506)."""

    @staticmethod
    def forward(ctx, zis, zjs, a_i, a_j, beta, w_min, valid, tau, ab_weight):
        m, b, _ = zis.shape
        z, v = stack(zis, zjs, valid)
        alpha = torch.cat([a_i, a_j], dim=0).contiguous()      # (2B, M)
        lse = mixture_lse(z, alpha, beta, v, tau)              # (M + 2, 2B)
        pos = _bundle_pos(zis, zjs, a_i, a_j, beta, tau)
        per_a, per_b = lse[:, :b] - pos, lse[:, b:] - pos
        wt, vf, denom = _bundle_weights(w_min, valid, m, b, zis.device)
        loss = (ab_weight * (per_a * wt).sum(dim=1)
                + (1 - ab_weight) * (per_b * wt).sum(dim=1)) / denom
        ctx.tau, ctx.ab_weight = tau, ab_weight
        ctx.save_for_backward(z, v, alpha, beta, lse, per_a, per_b, wt, vf,
                              denom)
        return loss

    @staticmethod
    def backward(ctx, g):
        z, v, alpha, beta, lse, per_a, per_b, wt, vf, denom = \
            ctx.saved_tensors
        tau, ab = ctx.tau, ctx.ab_weight
        m = beta.shape[0]
        b = per_a.shape[1]
        ca = (g[:, None] * ab) * wt / denom                    # (M + 2, B)
        cb = (g[:, None] * (1 - ab)) * wt / denom
        coef = torch.cat([ca, cb], dim=1).contiguous()
        dz, dalpha, dbeta = mixture_grad(z, alpha, beta, lse, coef, v, tau)
        d_w = None
        if ctx.needs_input_grad[5]:
            base = (ab * per_a[:m] + (1 - ab) * per_b[:m]) * vf[None, :]
            d_w = g[:m, None] * base / denom
        return (dz[:, :b].to(z.dtype), dz[:, b:].to(z.dtype), dalpha[:b],
                dalpha[b:], dbeta, d_w, None, None, None)


def snag_bundle_losses(zis: torch.Tensor, zjs: torch.Tensor,
                       a_i: torch.Tensor, a_j: torch.Tensor,
                       beta: torch.Tensor,
                       w_min: Optional[torch.Tensor] = None,
                       valid: Optional[torch.Tensor] = None,
                       tau: float = 0.1, ab_weight: float = 0.5
                       ) -> torch.Tensor:
    """(M + 2,) NT-Xent losses over the shared modality similarities:
    per-modality ICL (ECIA channels, weighted by ``w_min``) and SNAG's two
    joint-path ICLs (GMI) from the factored similarities (reference math
    SNAG.py:106, SNAG_tools.py:44-49, SNAG_loss.py:58-128).

    zis/zjs: (M, B, d) unit rows; a_i/a_j: (B, M) L2-normalised per-row
    attention weights; beta: (M,) fz mixture (sums to 1); w_min: (M, B)."""
    return _BundleStreamed.apply(zis.contiguous(), zjs.contiguous(), a_i, a_j,
                                 beta.contiguous(), w_min, valid, tau,
                                 ab_weight)
