"""Shared multi-modal encoder (eval mode).

Port of ``snag_tpu/models/encoder.py::MultiModalEncoder`` (:70-210) with the
GAT structure encoder and Mformer fusion (reference
SNAG_MMEA/model/SNAG_tools.py:53-156).  Submodules carry the reference's
torch names (``entity_emb``, ``img_fc``, ``rel_fc``, ``att_fc``,
``cross_graph_model.layer_stack.{i}``, ``fusion.fusion_layer.{i}``,
``fusion.weight_raw``), so a reference state dict loads strictly.

Training-time parts (feature and entity noise, dropout, batch-row
encoding) are not ported yet: the encoder refuses training mode.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from snag_tpu_torch.config import Config
from snag_tpu_torch.data.graph import DeviceGraph
from snag_tpu_torch.ops import inits
from snag_tpu_torch.ops.fusion import MformerFusion, tlinear
from snag_tpu_torch.ops.gnn import GAT


class FeaturePack(NamedTuple):
    """Per-entity modality feature tables (None = modality absent)."""
    img: Optional[torch.Tensor]
    rel: Optional[torch.Tensor]
    att: Optional[torch.Tensor]
    name: Optional[torch.Tensor]
    char: Optional[torch.Tensor]


class EncoderOutput(NamedTuple):
    gph: Optional[torch.Tensor]
    img: Optional[torch.Tensor]
    rel: Optional[torch.Tensor]
    att: Optional[torch.Tensor]
    name: Optional[torch.Tensor]
    char: Optional[torch.Tensor]
    joint: torch.Tensor
    joint_fz: torch.Tensor
    hidden: torch.Tensor
    weight_norm: torch.Tensor
    weight_fz: torch.Tensor


class MultiModalEncoder(nn.Module):
    def __init__(self, cfg: Config, ent_num: int, img_feature_dim: int,
                 attr_input_dim: int, rel_input_dim: int,
                 char_feature_dim: int, generator: torch.Generator):
        super().__init__()
        if cfg.structure_encoder != "gat":
            raise NotImplementedError("the GCN structure encoder is not ported")
        if cfg.use_project_head:
            raise NotImplementedError("projection heads are not ported")
        self.cfg = cfg
        input_dim = cfg.n_units()[0]
        self.entity_emb = nn.Embedding(ent_num, input_dim)
        with torch.no_grad():
            self.entity_emb.weight.copy_(inits.normal_std(
                (ent_num, input_dim), 1.0 / math.sqrt(ent_num), generator))

        # rel_fc draws at the reference's fixed 1000-column fan-in
        # (src/data.py:521-538) whatever the width of our table
        if cfg.w_rel:
            self.rel_fc = tlinear(rel_input_dim, cfg.attr_dim, generator,
                                  fan_in=1000)
        if cfg.w_attr:
            self.att_fc = tlinear(attr_input_dim, cfg.attr_dim, generator)
        if cfg.w_img:
            self.img_fc = tlinear(img_feature_dim, cfg.img_dim, generator)
        if cfg.w_name:
            self.name_fc = tlinear(300, cfg.char_dim, generator)
        if cfg.w_char:
            self.char_fc = tlinear(char_feature_dim, cfg.char_dim, generator)

        if cfg.w_gcn:
            self.cross_graph_model = GAT(
                cfg.n_units(), cfg.n_heads(), generator, dropout=cfg.dropout,
                attn_dropout=cfg.attn_dropout,
                instance_normalization=cfg.instance_normalization, diag=True)
        self.fusion = MformerFusion(
            cfg.hidden_size, cfg.num_attention_heads, cfg.num_hidden_layers,
            cfg.intermediate_size, bool(cfg.use_intermediate), generator)

    def forward(self, feats: FeaturePack, graph: DeviceGraph) -> EncoderOutput:
        if self.training:
            raise NotImplementedError(
                "training mode (noise, dropout) is not ported; call .eval()")
        cfg = self.cfg
        gph = (self.cross_graph_model(self.entity_emb.weight, graph)
               if cfg.w_gcn else None)
        img = self.img_fc(feats.img) if cfg.w_img else None
        rel = self.rel_fc(feats.rel) if cfg.w_rel else None
        att = self.att_fc(feats.att) if cfg.w_attr else None
        name = self.name_fc(feats.name) if (cfg.w_name and feats.name is not None) else None
        char = self.char_fc(feats.char) if (cfg.w_char and feats.char is not None) else None

        joint, joint_fz, hidden, weight_norm, weight_fz = self.fusion(
            [img, att, rel, gph, name, char])
        return EncoderOutput(gph=gph, img=img, rel=rel, att=att, name=name,
                             char=char, joint=joint, joint_fz=joint_fz,
                             hidden=hidden, weight_norm=weight_norm,
                             weight_fz=weight_fz)


def prepare_features(cfg: Config, data, device) -> FeaturePack:
    """Feature tables on ``device``; image rows normalized (SNAG.py:23)."""
    img = np.asarray(data.img_features, dtype=np.float32)
    n = np.linalg.norm(img, axis=1, keepdims=True)
    img = img / np.maximum(n, 1e-12)

    def put(a):
        return None if a is None else torch.as_tensor(
            np.ascontiguousarray(a, dtype=np.float32), device=device)

    return FeaturePack(
        img=put(img), rel=put(data.rel_features), att=put(data.att_features),
        name=put(data.name_features) if cfg.w_name else None,
        char=put(data.char_features) if cfg.w_char else None)
