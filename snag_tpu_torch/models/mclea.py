"""MCLEA (reference: SNAG_MMEA/model/MCLEA.py).

Port of ``snag_tpu/models/mclea.py``: the shared encoder with mean fusion
(global learnable softmax weights, MCLEA_tools.py:20-38) and two Kendall
layers.  Loss = ICL on the joint embedding + per-modality ICL through
``multi_loss_layer`` + IAL (KL of each modality against the joint)
through ``align_multi_loss_layer``, times ``zoom``: ``ial_loss`` already
scales by ``zoom``, so the alignment term carries it twice, as the
reference's does (MCLEA.py:128-139, JAX mclea.py:82-84).

Under ``--dtype bfloat16`` the projections give bf16 rows, so their ICL
takes the bf16 NT-Xent entries; the GAT rows and the mean-fused joint
are f32.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from snag_tpu_torch.config import Config
from snag_tpu_torch.data.graph import DeviceGraph
from snag_tpu_torch.losses.contrastive import ial_loss, icl_loss
from snag_tpu_torch.losses.multitask import KendallLossLayer
from snag_tpu_torch.models.encoder import (FeaturePack, MultiModalEncoder,
                                           batch_rows)

# the Kendall layers' slot order (MCLEA.py:108-139)
LOSS_ORDER = ("gph", "rel", "att", "img", "name", "char")


class MCLEA(nn.Module):
    def __init__(self, cfg: Config, ent_num: int, img_feature_dim: int,
                 attr_input_dim: int, rel_input_dim: int,
                 char_feature_dim: int, generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        self.multimodal_encoder = MultiModalEncoder(
            cfg, ent_num, img_feature_dim, attr_input_dim, rel_input_dim,
            char_feature_dim, generator, fusion_kind="mean")
        self.multi_loss_layer = KendallLossLayer(6)
        self.align_multi_loss_layer = KendallLossLayer(6)

    @classmethod
    def from_data(cls, cfg: Config, data,
                  generator: torch.Generator) -> "MCLEA":
        return cls(cfg, ent_num=data.ent_num, img_feature_dim=data.img_dim,
                   attr_input_dim=int(data.att_features.shape[1]),
                   rel_input_dim=int(data.rel_features.shape[1]),
                   char_feature_dim=data.char_dim, generator=generator)

    def forward(self, links: torch.Tensor, valid: Optional[torch.Tensor],
                feats: FeaturePack, graph: DeviceGraph,
                entity_noise_gen: Optional[torch.Generator] = None,
                dropout_gen: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        cfg = self.cfg
        rows = None
        if cfg.batch_encode:
            rows, links = batch_rows(links)
        enc = self.multimodal_encoder(feats, graph, entity_noise_gen,
                                      dropout_gen, rows=rows)
        modal = {"gph": enc.gph, "rel": enc.rel, "att": enc.att,
                 "img": enc.img, "name": enc.name, "char": enc.char}

        loss_joi = icl_loss(enc.joint, links, tau=cfg.tau,
                            ab_weight=cfg.ab_weight, valid=valid)
        in_loss = self.multi_loss_layer([
            0.0 if modal[m] is None else
            icl_loss(modal[m], links, tau=cfg.tau, ab_weight=cfg.ab_weight,
                     valid=valid)
            for m in LOSS_ORDER])
        align_loss = self.align_multi_loss_layer([
            0.0 if modal[m] is None else
            ial_loss(modal[m], enc.joint, links, tau=cfg.tau2,
                     ab_weight=cfg.ab_weight, zoom=cfg.zoom,
                     reduction=cfg.reduction, valid=valid)
            for m in LOSS_ORDER]) * cfg.zoom
        aux = {"joint_Intra_modal": loss_joi, "Intra_modal": in_loss,
               "Inter_modal": align_loss}
        return loss_joi + in_loss + align_loss, aux

    def joint_emb(self, feats: FeaturePack, graph: DeviceGraph):
        """Eval/IL embedding: (mean-fused joint (N, d), None)."""
        enc = self.multimodal_encoder(feats, graph, keep=("joint",))
        return enc.joint, None
