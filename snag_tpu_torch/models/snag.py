"""SNAG — the paper's model (reference: SNAG_MMEA/model/SNAG.py).

Port of ``snag_tpu/models/snag.py``: the encoder, the Kendall multi-task
layer's parameters (so the state dict has the JAX package's keys) and
``joint_emb``, the frozen-weight joint path that eval embeds with
(SNAG.py:178-179).  The training loss bundle (GMI + ECIA + IIR) is not
ported yet.
"""

from __future__ import annotations

import torch
from torch import nn

from snag_tpu_torch.config import Config
from snag_tpu_torch.data.graph import DeviceGraph
from snag_tpu_torch.losses.multitask import (AutomaticWeightedLoss,
                                             KendallLossLayer)
from snag_tpu_torch.models.encoder import FeaturePack, MultiModalEncoder


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

    def forward(self, *args, **kwargs):
        raise NotImplementedError("SNAG training loss: not ported yet")

    def joint_emb(self, feats: FeaturePack, graph: DeviceGraph):
        """Eval/IL embedding: (joint_emb_fz (N, M*d), weight_norm (N, M))."""
        enc = self.multimodal_encoder(feats, graph)
        return enc.joint_fz, enc.weight_norm
