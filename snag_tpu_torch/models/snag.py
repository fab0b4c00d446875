"""SNAG — the paper's model (reference: SNAG_MMEA/model/SNAG.py).

Port of ``snag_tpu/models/snag.py``.  Loss bundle (SNAG.py:101-122):

* GMI  — ICL on both joint paths (attention-weighted + frozen-weight);
* ECIA — per-modality ICL weighted by each entity pair's min attention
  weight (SNAG.py:109, 143-162; SNAG_loss.py:65-71);
* IIR  — per-modality ICL on the post-transformer hidden slices
  (SNAG.py:112, 124-141; the slice labels follow the reference's hardcoded
  index order, including its gph/img swap against the fusion input order).

ECIA and IIR each run through the shared Kendall multi-task layer; an
optional AWL head combines the three (``--awloss``).  Eval embeds with the
frozen-weight joint path (SNAG.py:178-179).

With ``--fused_snag_loss 1`` (the default) GMI and ECIA come from one
fused bundle (``_fused_bundle``, JAX snag.py:143-195): the joint
similarities factor over the per-modality blocks ECIA computes, so the
mixture kernels (``losses/contrastive.snag_bundle_losses``) derive all
M + 2 channels from K_m = z_m z_m^T and the (B, M*d) joint products never
run.  With ``--fused_snag_loss 0``, or where the modalities differ in
width, GMI and ECIA are separate NT-Xent calls: the same loss
(tests/test_snag_bundle.py:100).  ECIA and IIR batch their modalities
into one call where they share a width, else run one per modality.

Under ``--dtype bfloat16`` every loss takes bf16 unit rows
(``_matmul_dtype``); each modality is normalised in its own dtype (bf16
projections and hidden slices, the f32 GAT rows) and a stack of mixed
dtypes is f32 before the cast, as JAX's ``jnp.stack`` promotes it.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from snag_tpu_torch.config import Config
from snag_tpu_torch.data.graph import DeviceGraph
from snag_tpu_torch.losses.contrastive import (icl_loss, icl_loss_multi,
                                               icl_loss_stacked,
                                               snag_bundle_losses)
from snag_tpu_torch.losses.multitask import (AutomaticWeightedLoss,
                                             KendallLossLayer)
from snag_tpu_torch.models.encoder import (FeaturePack, MultiModalEncoder,
                                           batch_rows)
from snag_tpu_torch.ops.fusion import l2norm

# fusion input order (SNAG_tools.py:154)
FUSION_ORDER = ("img", "att", "rel", "gph", "name", "char")


def stack_normed(embs) -> torch.Tensor:
    """(M, N, d) of the l2-normalised rows, each normalised in its own
    dtype, in their common dtype (f32 where any is f32)."""
    normed = [l2norm(e) for e in embs]
    dt = normed[0].dtype
    for e in normed[1:]:
        dt = torch.promote_types(dt, e.dtype)
    return torch.stack([e.to(dt) for e in normed], dim=0)


def weight_column(cfg: Config, modality: str) -> Optional[int]:
    """Column of ``weight_norm`` holding ``modality``'s attention weight:
    weight_norm columns follow the active fusion-input order, which reduces
    to the reference's hardcoded indices (SNAG.py:147-152)."""
    active = [m for m in FUSION_ORDER
              if {"img": cfg.w_img, "att": cfg.w_attr, "rel": cfg.w_rel,
                  "gph": cfg.w_gcn, "name": cfg.w_name, "char": cfg.w_char}[m]]
    return active.index(modality) if modality in active else None


class SNAG(nn.Module):
    def __init__(self, cfg: Config, ent_num: int, img_feature_dim: int,
                 attr_input_dim: int, rel_input_dim: int,
                 char_feature_dim: int, generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        self.multimodal_encoder = MultiModalEncoder(
            cfg, ent_num, img_feature_dim, attr_input_dim, rel_input_dim,
            char_feature_dim, generator)
        self.multi_loss_layer = KendallLossLayer(6)
        if cfg.awloss:
            self.multi_loss_layer_2 = AutomaticWeightedLoss(7)

    @classmethod
    def from_data(cls, cfg: Config, data, generator: torch.Generator) -> "SNAG":
        return cls(cfg, ent_num=data.ent_num, img_feature_dim=data.img_dim,
                   attr_input_dim=int(data.att_features.shape[1]),
                   rel_input_dim=int(data.rel_features.shape[1]),
                   char_feature_dim=data.char_dim, generator=generator)

    def generate_hidden_emb(self, hidden: torch.Tensor):
        """Fixed-slice extraction (SNAG.py:124-141)."""
        gph = l2norm(hidden[:, 0, :])
        rel = l2norm(hidden[:, 1, :])
        att = l2norm(hidden[:, 2, :])
        img = l2norm(hidden[:, 3, :]) if self.cfg.w_img else None
        if hidden.shape[1] >= 6:
            name = l2norm(hidden[:, 4, :])
            char = l2norm(hidden[:, 5, :])
        else:
            name = char = None
        return gph, rel, att, img, name, char

    def _matmul_dtype(self) -> Optional[torch.dtype]:
        """The losses' operand dtype (JAX snag.py:86-87): bf16 under
        ``--dtype bfloat16``, else None (the rows' own f32)."""
        return torch.bfloat16 if self.cfg.dtype == "bfloat16" else None

    def inner_view_loss(self, gph, rel, att, img, name, char, links, valid,
                        weight_norm: Optional[torch.Tensor] = None):
        """Per-modality ICL through the Kendall layer (SNAG.py:143-162): one
        batched call over the active modalities where they share a width
        (every shipped config), else one ``icl_loss`` per modality."""
        cfg = self.cfg
        md = self._matmul_dtype()
        named = [("gph", gph), ("rel", rel), ("att", att), ("img", img),
                 ("name", name), ("char", char)]
        active = [(m, e) for m, e in named if e is not None]
        if len({e.shape[-1] for _, e in active}) != 1:
            def one(modality, emb):
                if emb is None:
                    return 0.0
                w = None
                col = None if weight_norm is None \
                    else weight_column(cfg, modality)
                if col is not None:
                    # the reference scales the weights by mod_num (SNAG.py:146)
                    w = weight_norm[:, col] * weight_norm.shape[1]
                return icl_loss(emb, links, tau=cfg.tau,
                                ab_weight=cfg.ab_weight, weight_norm=w,
                                valid=valid, matmul_dtype=md)
            return self.multi_loss_layer([one(m, e) for m, e in named])
        stack = stack_normed([e for _, e in active])
        w_min = None
        if weight_norm is not None:
            # weight_norm: (N_ent, mod_num); the reference scales the
            # min weights by mod_num (SNAG.py:146)
            mod_num = weight_norm.shape[1]
            cols = [weight_column(cfg, m) for m, _ in active]
            wi = weight_norm[links[:, 0]][:, cols].T                 # (M, B)
            wj = weight_norm[links[:, 1]][:, cols].T
            w_min = torch.minimum(wi, wj) * mod_num
        per = icl_loss_multi(stack, links, tau=cfg.tau,
                             ab_weight=cfg.ab_weight, w_min=w_min,
                             valid=valid, matmul_dtype=md)
        it = iter(per)
        return self.multi_loss_layer(
            [0.0 if e is None else next(it) for _, e in named])

    def _fused_bundle(self, enc, links, valid):
        """(gmi, ecia) from the shared per-modality similarity blocks, or
        None where the factorisation does not apply (JAX snag.py:143-195).
        The joint rows are unit modality rows scaled by a = w / ||w|| (the
        attention path) and sqrt(beta), beta = u^2 / sum u^2 (the frozen
        path), so the factorisation is exact unless a modality row is all
        zeros."""
        cfg = self.cfg
        named = [("gph", enc.gph), ("rel", enc.rel), ("att", enc.att),
                 ("img", enc.img), ("name", enc.name), ("char", enc.char)]
        active = [(m, e) for m, e in named if e is not None]
        if len({e.shape[-1] for _, e in active}) != 1:
            return None
        stack = stack_normed([e for _, e in active])
        zis = stack[:, links[:, 0], :]
        zjs = stack[:, links[:, 1], :]
        md = self._matmul_dtype()
        if md is not None:
            zis, zjs = zis.to(md), zjs.to(md)
        mod_num = enc.weight_norm.shape[1]
        cols = [weight_column(cfg, m) for m, _ in active]
        wi = enc.weight_norm[links[:, 0]][:, cols]                  # (B, M)
        wj = enc.weight_norm[links[:, 1]][:, cols]
        w_min = (torch.minimum(wi, wj) * mod_num).T                 # (M, B)
        a_i = wi / torch.linalg.norm(wi, dim=1, keepdim=True)
        a_j = wj / torch.linalg.norm(wj, dim=1, keepdim=True)
        u = enc.weight_fz[cols]
        beta = u * u / torch.sum(u * u)
        per = snag_bundle_losses(zis, zjs, a_i, a_j, beta, w_min=w_min,
                                 valid=valid, tau=cfg.tau,
                                 ab_weight=cfg.ab_weight)
        m_act = len(active)
        gmi = per[m_act] + per[m_act + 1]
        it = iter(per[:m_act])
        ecia = self.multi_loss_layer(
            [0.0 if e is None else next(it) for _, e in named])
        return gmi, ecia

    def forward(self, links: torch.Tensor, valid: Optional[torch.Tensor],
                feats: FeaturePack, graph: DeviceGraph,
                entity_noise_gen: Optional[torch.Generator] = None,
                dropout_gen: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Training loss (SNAG.py:101-122) and its aux terms."""
        cfg = self.cfg
        rows = None
        if cfg.batch_encode:
            rows, links = batch_rows(links)
        enc = self.multimodal_encoder(feats, graph, entity_noise_gen,
                                      dropout_gen, rows=rows)
        gph_h, rel_h, att_h, img_h, name_h, char_h = \
            self.generate_hidden_emb(enc.hidden)

        bundle = self._fused_bundle(enc, links, valid) \
            if cfg.fused_snag_loss else None
        if bundle is not None:
            gmi, ecia = bundle
        else:
            gmi = icl_loss_stacked((enc.joint, enc.joint_fz), links,
                                   tau=cfg.tau, ab_weight=cfg.ab_weight,
                                   valid=valid,
                                   matmul_dtype=self._matmul_dtype())
            ecia = self.inner_view_loss(enc.gph, enc.rel, enc.att, enc.img,
                                        enc.name, enc.char, links, valid,
                                        weight_norm=enc.weight_norm)
        iir = self.inner_view_loss(gph_h, rel_h, att_h, img_h, name_h,
                                   char_h, links, valid)

        loss_list = [gmi, ecia, iir]
        if cfg.awloss:
            loss_all = self.multi_loss_layer_2(loss_list)
        else:
            loss_all = gmi + ecia + iir
        aux = {"joint_Intra_modal": gmi, "Intra_modal": ecia,
               "IIR_loss": iir,
               "weight_norm": enc.weight_norm.mean(dim=0).detach()}
        return loss_all, aux

    def joint_emb(self, feats: FeaturePack, graph: DeviceGraph):
        """Eval/IL embedding: (joint_emb_fz (N, M*d), weight_norm (N, M))."""
        enc = self.multimodal_encoder(feats, graph,
                                      keep=("joint_fz", "weight_norm"))
        return enc.joint_fz, enc.weight_norm
