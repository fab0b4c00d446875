"""Alignment losses over link batches: ICL (NT-Xent), IAL (KL), NCA.

Port of ``snag_tpu/losses/contrastive.py``: the batched NT-Xent core
``_icl_xent_batched`` (:77-201, its streaming branch), ``icl_loss`` (its
simple route :269-277 on that core; its dense route with replay negatives,
the hardest-negative miner and ``inversion``, :279-335), ``icl_loss_multi``
(:343), ``icl_loss_stacked`` (:370), SNAG's fused bundle
``snag_bundle_losses`` (:411-533, its streaming branch), ``ial_loss``
(:536-596) and ``nca_loss`` (:599-630).  References:
SNAG_MMEA/model/SNAG_loss.py:31-202, MEAformer_loss.py:28-161,
EVA_tools.py:80-148.  The dense routes are plain tensor code in JAX too
(no Pallas kernel): their B x 2B products stay ``torch.matmul``.

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


LARGE_NUM = 1e9


def _colmask(valid: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(1, B): 0 on valid columns, -1e9 on padded ones, in ``dtype`` (JAX's
    weakly typed mask takes the logits' dtype)."""
    zero = torch.zeros((), dtype=dtype, device=valid.device)
    return torch.where(valid[None, :], zero, zero - LARGE_NUM)


def _masked_mean_xent(logits: torch.Tensor, valid: Optional[torch.Tensor],
                      w_min: Optional[torch.Tensor]) -> torch.Tensor:
    """softXEnt with diagonal targets: the mean over rows of
    -logprob[i, i] (SNAG_loss.py:42-54)."""
    b = logits.shape[0]
    per_row = -torch.diagonal(torch.log_softmax(logits, dim=1))[:b]
    if w_min is not None:
        per_row = per_row * w_min
    if valid is None:
        return per_row.mean()
    per_row = torch.where(valid, per_row, torch.zeros_like(per_row))
    return per_row.sum() / torch.clamp(valid.sum(), min=1)


def _mine_hardest(logits: torch.Tensor) -> torch.Tensor:
    """The hardest negative column of each row (MEAformer_loss.py:40-68):
    the row's argmax, or, where that is the row's own positive (column i),
    the argmax after that column is set to 0 (contrastive.py:330-336).
    Ties go to the first index, as ``jnp.argmax``'s do."""
    idx = torch.arange(logits.shape[0], device=logits.device)
    stg = torch.argmax(logits, dim=1)
    zeroed = logits.clone()
    zeroed[idx, stg] = 0.0
    stg2 = torch.argmax(zeroed, dim=1)
    return torch.where(idx == stg, stg2, stg)


def icl_loss(emb: torch.Tensor, links: torch.Tensor, tau: float = 0.1,
             ab_weight: float = 0.5,
             weight_norm: Optional[torch.Tensor] = None,
             valid: Optional[torch.Tensor] = None,
             neg_l: Optional[torch.Tensor] = None,
             neg_r: Optional[torch.Tensor] = None,
             neg_valid: Optional[torch.Tensor] = None,
             neg_valid_r: Optional[torch.Tensor] = None,
             norm: bool = True, with_replay_mining: bool = False,
             inversion: bool = False,
             matmul_dtype: Optional[torch.dtype] = None):
    """Intra-modal NT-Xent over a link batch (SNAG_loss.py:58-128).

    Without replay negatives, mining or ``inversion`` it is the batched
    core with M = 1 (the NT-Xent kernels).  Otherwise the dense route:
    logits rows [cross-KG ab | masked intra aa | replay negatives], labels
    the diagonal of ab; ``inversion`` takes the opposite KG's intra block
    ([ab | bb] / [ba | aa]) and drops the replay block.  With
    ``with_replay_mining`` it returns (loss, l_neg, r_neg), the mined
    logit columns of each side (``_mine_hardest``)."""
    if norm:
        emb = l2norm(emb)
    zis, zjs = _cast(emb[links[:, 0]], emb[links[:, 1]], matmul_dtype)
    w_min = None
    if weight_norm is not None:
        w_min = torch.minimum(weight_norm[links[:, 0]],
                              weight_norm[links[:, 1]])
    if neg_l is None and not inversion and not with_replay_mining:
        return icl_xent_batched(zis[None], zjs[None],
                                None if w_min is None else w_min[None],
                                valid, tau, ab_weight)[0]

    b = zis.shape[0]

    def sim(x, y):      # f32 products (preferred_element_type=f32)
        return torch.matmul(_f32(x), _f32(y).T) / tau
    eye = torch.eye(b, dtype=torch.float32, device=emb.device)
    z = torch.cat([zis, zjs])
    big = sim(z, z)
    logits_ab = big[:b, b:]
    logits_ba = logits_ab.T
    logits_aa = big[:b, :b] - eye * LARGE_NUM
    logits_bb = big[b:, b:] - eye * LARGE_NUM
    if valid is not None:
        # padded rows must not serve as negatives in any block
        colmask = _colmask(valid, torch.float32)
        logits_ab = logits_ab + colmask
        logits_ba = logits_ba + colmask
        logits_aa = logits_aa + colmask
        logits_bb = logits_bb + colmask

    if inversion:
        blocks_a, blocks_b = [logits_ab, logits_bb], [logits_ba, logits_aa]
    else:
        blocks_a, blocks_b = [logits_ab, logits_aa], [logits_ba, logits_bb]
    if neg_l is not None and not inversion:
        logits_ana = sim(zis, emb[neg_l].to(zis.dtype))
        logits_bnb = sim(zjs, emb[neg_r].to(zjs.dtype))
        if neg_valid is not None:
            nvr = neg_valid if neg_valid_r is None else neg_valid_r
            logits_ana = logits_ana + _colmask(neg_valid, torch.float32)
            logits_bnb = logits_bnb + _colmask(nvr, torch.float32)
        blocks_a.append(logits_ana)
        blocks_b.append(logits_bnb)
    logits_a = torch.cat(blocks_a, dim=1)
    logits_b = torch.cat(blocks_b, dim=1)
    loss = (ab_weight * _masked_mean_xent(logits_a, valid, w_min)
            + (1 - ab_weight) * _masked_mean_xent(logits_b, valid, w_min))
    if not with_replay_mining:
        return loss
    with torch.no_grad():
        return loss, _mine_hardest(logits_a), _mine_hardest(logits_b)


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


def ial_loss(src_emb: torch.Tensor, tar_emb: torch.Tensor,
             links: torch.Tensor, tau: float = 4.0, ab_weight: float = 0.5,
             zoom: float = 0.1, reduction: str = "mean",
             valid: Optional[torch.Tensor] = None, norm: bool = True,
             inversion: bool = False) -> torch.Tensor:
    """Unimodal -> joint KL alignment (SNAG_loss.py:130-202).

    KL(softmax(q) || softmax(p)) row by row, q from the (detached) joint
    rows, p from the modality's, as torch's ``kl_div(log_softmax(p),
    softmax(q))`` sums it, written out as q * (log_softmax(q) -
    log_softmax(p)) so that a masked column (q exactly 0) adds 0; mean
    over every element of the B x 2B matrix or sum (``reduction``).
    ``inversion`` takes the opposite KG's intra block.  Each side's logits
    keep their rows' dtype, as JAX's do (bf16 modality rows under
    ``--dtype bfloat16``)."""
    if norm:
        src_emb = l2norm(src_emb)
        tar_emb = l2norm(tar_emb)
    s_i, s_j = src_emb[links[:, 0]], src_emb[links[:, 1]]
    t_i, t_j = tar_emb[links[:, 0]], tar_emb[links[:, 1]]
    b = s_i.shape[0]
    eye = torch.eye(b, dtype=src_emb.dtype, device=src_emb.device)

    def blocks(x, y):
        # the intra block from y under inversion (the opposite side)
        intra = y if inversion else x
        ab = x @ y.T / tau
        aa = intra @ intra.T / tau - eye * LARGE_NUM
        if valid is not None:
            ab = ab + _colmask(valid, ab.dtype)
            aa = aa + _colmask(valid, aa.dtype)
        return torch.cat([ab, aa], dim=1)

    def kl(p, q):
        elem = torch.softmax(q, dim=1) * (torch.log_softmax(q, dim=1)
                                          - torch.log_softmax(p, dim=1))
        if valid is not None:
            elem = torch.where(valid[:, None], elem, torch.zeros_like(elem))
            rows = torch.clamp(valid.sum(), min=1)
        else:
            rows = p.shape[0]
        if reduction == "sum":
            return elem.sum()
        return elem.sum() / (rows * p.shape[1])

    with torch.no_grad():
        q_ab, q_ba = blocks(t_i, t_j), blocks(t_j, t_i)
    loss_a = kl(blocks(s_i, s_j), q_ab)
    loss_b = kl(blocks(s_j, s_i), q_ba)
    return zoom * (ab_weight * loss_a + (1 - ab_weight) * loss_b)


def nca_loss(emb: torch.Tensor, links: torch.Tensor, alpha: float = 15.0,
             beta: float = 10.0, ep: float = 0.0,
             valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """EVA's NCA alignment loss (EVA_tools.py:80-148).  Its row sums of
    exp(alpha * s), |s| <= 1, have no static max: ~1e10 a row at alpha 15
    and B = 3,500, well inside f32."""
    emb = l2norm(emb)
    im, s = emb[links[:, 0]], emb[links[:, 1]]
    b = im.shape[0]
    eye = torch.eye(b, dtype=emb.dtype, device=emb.device)
    scores = im @ s.T
    s_diag = eye * scores
    s_exp = torch.exp(alpha * (scores - ep))
    s_exp = s_exp - s_exp * eye
    if valid is not None:
        vm = valid.to(emb.dtype)
        s_exp = s_exp * vm[None, :] * vm[:, None]
        s_diag = s_diag * vm[:, None]
        denom = torch.clamp(valid.sum(), min=1)
    else:
        denom = b
    loss_diag = -torch.log(1 + torch.relu(s_diag.sum(dim=0)))
    per = (torch.log(1 + s_exp.sum(dim=0)) / alpha
           + torch.log(1 + s_exp.sum(dim=1)) / alpha + loss_diag * beta)
    if valid is not None:
        per = torch.where(valid, per, torch.zeros_like(per))
    return per.sum() / denom
