"""MEAformer (reference: SNAG_MMEA/model/MEAformer.py).

Port of ``snag_tpu/models/meaformer.py``: the Mformer trunk with a single
joint path (no frozen-weight head, MEAformer_tools.py:25-72), the
cursor-based hidden slicing of ``generate_hidden_emb``
(MEAformer.py:168-202) and the optional replay of mined hard negatives
(``--replay 1``, MEAformer.py:55-61, 108-148).

Loss = ICL on the joint embedding + per-modality ICL on the modality rows
and on the post-transformer hidden slices, each set through the one
Kendall layer.  The per-modality sets share a width in every shipped
configuration and run as one batched NT-Xent call (M = 4 or 6).

The hidden slices are read in gph, rel, att, img order while the fusion
stacks its tokens img, att, rel, gph: the slice labelled gph is the img
token's, and so on.  That is the reference's quirk (JAX meaformer.py:
55-73), kept.

With ``--replay 1`` the joint loss takes the dense route with the replay
negatives of ``train/step.py`` (``replay_neg_*``) and returns the mined
columns in ``aux["l_neg"]`` / ``aux["r_neg"]``; the entity table is then
encoded whole (replay negatives index any entity).  Under ``--dtype
bfloat16`` the losses take bf16 unit rows (``_matmul_dtype``) but for the
dense replay route, which JAX keeps in f32.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from snag_tpu_torch.config import Config
from snag_tpu_torch.data.graph import DeviceGraph
from snag_tpu_torch.losses.contrastive import icl_loss, icl_loss_multi
from snag_tpu_torch.losses.multitask import KendallLossLayer
from snag_tpu_torch.models.encoder import (FeaturePack, MultiModalEncoder,
                                           batch_rows)
from snag_tpu_torch.models.snag import stack_normed
from snag_tpu_torch.ops.fusion import l2norm

LOSS_ORDER = ("gph", "rel", "att", "img", "name", "char")


class MEAformer(nn.Module):
    def __init__(self, cfg: Config, ent_num: int, img_feature_dim: int,
                 attr_input_dim: int, rel_input_dim: int,
                 char_feature_dim: int, generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        self.multimodal_encoder = MultiModalEncoder(
            cfg, ent_num, img_feature_dim, attr_input_dim, rel_input_dim,
            char_feature_dim, generator, fusion_kind="mformer_single")
        self.multi_loss_layer = KendallLossLayer(6)

    @classmethod
    def from_data(cls, cfg: Config, data,
                  generator: torch.Generator) -> "MEAformer":
        return cls(cfg, ent_num=data.ent_num, img_feature_dim=data.img_dim,
                   attr_input_dim=int(data.att_features.shape[1]),
                   rel_input_dim=int(data.rel_features.shape[1]),
                   char_feature_dim=data.char_dim, generator=generator)

    def generate_hidden_emb(self, hidden: torch.Tensor
                            ) -> Dict[str, Optional[torch.Tensor]]:
        """Cursor-based slicing (MEAformer.py:168-202): the tokens of the
        present modalities are read in gph, rel, att, img order."""
        cfg = self.cfg
        i = 0
        out: Dict[str, Optional[torch.Tensor]] = {}
        for m, flag in (("gph", cfg.w_gcn), ("rel", cfg.w_rel),
                        ("att", cfg.w_attr), ("img", cfg.w_img)):
            out[m] = None
            if flag:
                out[m] = l2norm(hidden[:, i, :])
                i += 1
        out["name"] = out["char"] = None
        if cfg.w_name and cfg.w_char:
            out["name"] = l2norm(hidden[:, i, :])
            out["char"] = l2norm(hidden[:, i + 1, :])
        return out

    def _matmul_dtype(self) -> Optional[torch.dtype]:
        return torch.bfloat16 if self.cfg.dtype == "bfloat16" else None

    def inner_view_loss(self, embs: Dict[str, Optional[torch.Tensor]],
                        links: torch.Tensor,
                        valid: Optional[torch.Tensor]) -> torch.Tensor:
        """Per-modality ICL through the Kendall layer: one batched call
        where the present modalities share a width, else one ``icl_loss``
        each (JAX meaformer.py:78-100)."""
        cfg = self.cfg
        active = [embs[m] for m in LOSS_ORDER if embs[m] is not None]
        if len({e.shape[-1] for e in active}) != 1:
            return self.multi_loss_layer([
                0.0 if embs[m] is None else
                icl_loss(embs[m], links, tau=cfg.tau,
                         ab_weight=cfg.ab_weight, valid=valid)
                for m in LOSS_ORDER])
        per = icl_loss_multi(stack_normed(active), links, tau=cfg.tau,
                             ab_weight=cfg.ab_weight, valid=valid,
                             matmul_dtype=self._matmul_dtype())
        it = iter(per)
        return self.multi_loss_layer([
            0.0 if embs[m] is None else next(it) for m in LOSS_ORDER])

    def forward(self, links: torch.Tensor, valid: Optional[torch.Tensor],
                feats: FeaturePack, graph: DeviceGraph,
                entity_noise_gen: Optional[torch.Generator] = None,
                dropout_gen: Optional[torch.Generator] = None,
                replay_neg_l: Optional[torch.Tensor] = None,
                replay_neg_r: Optional[torch.Tensor] = None,
                replay_neg_valid: Optional[torch.Tensor] = None,
                replay_neg_valid_r: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        cfg = self.cfg
        rows = None
        if cfg.batch_encode and not cfg.replay:
            rows, links = batch_rows(links)
        enc = self.multimodal_encoder(feats, graph, entity_noise_gen,
                                      dropout_gen, rows=rows)
        aux: Dict[str, torch.Tensor] = {}
        if cfg.replay:
            loss_joi, aux["l_neg"], aux["r_neg"] = icl_loss(
                enc.joint, links, tau=cfg.tau, ab_weight=cfg.ab_weight,
                valid=valid, neg_l=replay_neg_l, neg_r=replay_neg_r,
                neg_valid=replay_neg_valid, neg_valid_r=replay_neg_valid_r,
                with_replay_mining=True)
        else:
            loss_joi = icl_loss(enc.joint, links, tau=cfg.tau,
                                ab_weight=cfg.ab_weight, valid=valid,
                                matmul_dtype=self._matmul_dtype())
        modal = {"gph": enc.gph, "rel": enc.rel, "att": enc.att,
                 "img": enc.img, "name": enc.name, "char": enc.char}
        in_loss = self.inner_view_loss(modal, links, valid)
        out_loss = self.inner_view_loss(self.generate_hidden_emb(enc.hidden),
                                        links, valid)
        aux.update({"joint_Intra_modal": loss_joi, "Intra_modal": in_loss,
                    "IIR_loss": out_loss,
                    "weight_norm": enc.weight_norm.mean(dim=0).detach()})
        return loss_joi + in_loss + out_loss, aux

    def joint_emb(self, feats: FeaturePack, graph: DeviceGraph):
        """Eval/IL embedding: (joint (N, M * d), weight_norm (N, M))."""
        enc = self.multimodal_encoder(feats, graph,
                                      keep=("joint", "weight_norm"))
        return enc.joint, enc.weight_norm
