"""Intra-modal contrastive loss (ICL, NT-Xent) over link batches.

Port of the NT-Xent part of ``snag_tpu/losses/contrastive.py``: the batched
core ``_icl_xent_batched`` (:77-201, its streaming branch), ``icl_loss``'s
simple route (:269-278), ``icl_loss_multi`` (:343) and ``icl_loss_stacked``
(:370).  Reference: SNAG_MMEA/model/SNAG_loss.py:31-128.

An optional ``valid`` mask lets capacity-padded batches compute the value
the reference gets from its ragged last batch: invalid rows leave the
numerator and the denominator, and their columns leave the negative pool.

The core is a ``torch.autograd.Function`` whose forward is the streaming
row-logsumexp and whose backward the streaming gradient
(``ops/cuda/ntxent.py``): kernels for CUDA tensors, dense twins for CPU
tensors.  Only the (M, B) row statistics are kept for the backward.
Rows must be L2-normalised (the kernels' static max).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from snag_tpu_torch.ops.cuda.ntxent import (streaming_lse,
                                            streaming_ntxent_grad)
from snag_tpu_torch.ops.fusion import l2norm


def _pos_diag(zis: torch.Tensor, zjs: torch.Tensor, tau: float):
    """Positive-pair similarities: pos[m, i] = zis_i . zjs_i / tau."""
    return torch.einsum("mbd,mbd->mb", zis, zjs) / tau


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
        return d_zis, d_zjs, d_w, None, None, None


def icl_xent_batched(zis: torch.Tensor, zjs: torch.Tensor,
                     w_min: Optional[torch.Tensor],
                     valid: Optional[torch.Tensor], tau: float,
                     ab_weight: float) -> torch.Tensor:
    """zis/zjs (M, B, d) unit rows; w_min (M, B) or None; valid (B,) bool
    or None.  Returns the (M,) losses."""
    return _ICLXentBatched.apply(zis.contiguous(), zjs.contiguous(), w_min,
                                 valid, tau, ab_weight)


def icl_loss(emb: torch.Tensor, links: torch.Tensor, tau: float = 0.1,
             ab_weight: float = 0.5,
             weight_norm: Optional[torch.Tensor] = None,
             valid: Optional[torch.Tensor] = None, neg_l=None, neg_r=None,
             norm: bool = True, with_replay_mining: bool = False,
             inversion: bool = False) -> torch.Tensor:
    """Intra-modal NT-Xent over a link batch (SNAG_loss.py:58-128), simple
    route only: the batched core with M = 1."""
    if neg_l is not None or neg_r is not None or with_replay_mining \
            or inversion:
        raise NotImplementedError(
            "icl_loss with replay negatives, mining or inversion "
            "(MEAformer's replay path) is not ported: ROADMAP A6")
    if norm:
        emb = l2norm(emb)
    zis = emb[links[:, 0]]
    zjs = emb[links[:, 1]]
    w_min = None
    if weight_norm is not None:
        w_min = torch.minimum(weight_norm[links[:, 0]],
                              weight_norm[links[:, 1]])[None]
    return icl_xent_batched(zis[None], zjs[None], w_min, valid, tau,
                            ab_weight)[0]


def icl_loss_multi(embs: torch.Tensor, links: torch.Tensor, tau: float = 0.1,
                   ab_weight: float = 0.5,
                   w_min: Optional[torch.Tensor] = None,
                   valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """M independent ICL losses in one batched computation.

    embs: (M, N, d) already L2-normalised rows; w_min: (M, B) per-row
    weights or None.  Returns (M,) losses."""
    zis = embs[:, links[:, 0], :]
    zjs = embs[:, links[:, 1], :]
    return icl_xent_batched(zis, zjs, w_min, valid, tau, ab_weight)


def icl_loss_stacked(emb_list: Sequence[torch.Tensor], links: torch.Tensor,
                     tau: float = 0.1, ab_weight: float = 0.5,
                     valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sum of independent ICL losses over several equally wide embedding
    tables, batched through one core call: SNAG's GMI = icl(joint) +
    icl(joint_fz) (SNAG.py:106)."""
    zis = torch.stack([l2norm(e[links[:, 0]]) for e in emb_list])
    zjs = torch.stack([l2norm(e[links[:, 1]]) for e in emb_list])
    return icl_xent_batched(zis, zjs, None, valid, tau, ab_weight).sum()
