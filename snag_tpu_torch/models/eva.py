"""EVA (reference: SNAG_MMEA/model/EVA.py).

Port of ``snag_tpu/models/eva.py``.  A flat module tree under the
reference's names: ``ent_embed``, ``weight_raw``, the projections
``{img,att,rel}_fc`` (and ``name_fc`` / ``char_fc`` with
``--use_surface 1``), and the GCN as ``cross_graph_model``, which EVA
builds whatever ``--structure_encoder`` says (EVA.py:52).  Projection
kernels draw xavier-normal and their biases torch's uniform, both at the
reference's fan-in (1,000 for ``rel_fc``, 300 for ``name_fc``,
EVA.py:55-58); ``img_fc`` maps to ``attr_dim`` as the reference's does.

Loss: one NCA loss per modality and one on the joint embedding (alpha 5
for the graph view, 15 elsewhere, beta 10).  The joint embedding is the
detached weighted concat img / att / rel / gph [/ name / char] with
softmax(``weight_raw``) weights (EVA.py:146-165), so only the weights
learn through the joint loss.

EVA passes no dtype to any layer (JAX eva.py:51-66): it runs in f32
whatever ``--dtype`` says, its GCN included.  Under a mesh its
projections split their rows over the ranks as the shared encoder's do
(``models/encoder.py``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from snag_tpu_torch.config import Config
from snag_tpu_torch.data.graph import DeviceGraph
from snag_tpu_torch.losses.contrastive import nca_loss
from snag_tpu_torch.models.encoder import (FeaturePack, batch_rows,
                                           split_rows)
from snag_tpu_torch.ops import inits
from snag_tpu_torch.ops import noise as noise_ops
from snag_tpu_torch.ops.fusion import l2norm
from snag_tpu_torch.ops.gnn import GCN
from snag_tpu_torch.parallel.mesh import gather_rows


def _xlinear(in_features: int, out_features: int, ref_fan_in: int,
             generator: torch.Generator) -> nn.Linear:
    """EVA's ``_xdense`` (JAX eva.py:27-35): xavier-normal weight, torch
    uniform bias, both at the reference's fan-in."""
    lin = nn.Linear(in_features, out_features)
    with torch.no_grad():
        lin.weight.copy_(inits.xavier_normal_fan(
            (out_features, in_features), ref_fan_in, generator))
        lin.bias.copy_(inits.torch_linear((out_features,), ref_fan_in,
                                          generator))
    return lin


class EVA(nn.Module):
    def __init__(self, cfg: Config, ent_num: int, img_feature_dim: int,
                 attr_input_dim: int, rel_input_dim: int,
                 char_feature_dim: int, generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        self.mesh = None
        u = cfg.n_units()
        self.ent_embed = nn.Embedding(ent_num, u[0])
        with torch.no_grad():
            self.ent_embed.weight.copy_(inits.xavier_normal((ent_num, u[0]),
                                                            generator))
        self.weight_raw = nn.Parameter(torch.ones(cfg.inner_view_num))
        self.rel_fc = _xlinear(rel_input_dim, cfg.attr_dim, 1000, generator)
        self.att_fc = _xlinear(attr_input_dim, cfg.attr_dim, attr_input_dim,
                               generator)
        self.img_fc = _xlinear(img_feature_dim, cfg.attr_dim,
                               img_feature_dim, generator)
        self.cross_graph_model = GCN(u[0], u[1], u[2], generator,
                                     dropout=cfg.dropout)
        self.surface = bool(cfg.w_name and cfg.w_char)
        if self.surface:
            self.name_fc = _xlinear(300, cfg.char_dim, 300, generator)
            self.char_fc = _xlinear(char_feature_dim, cfg.char_dim,
                                    char_feature_dim, generator)

    @classmethod
    def from_data(cls, cfg: Config, data, generator: torch.Generator) -> "EVA":
        return cls(cfg, ent_num=data.ent_num, img_feature_dim=data.img_dim,
                   attr_input_dim=int(data.att_features.shape[1]),
                   rel_input_dim=int(data.rel_features.shape[1]),
                   char_feature_dim=data.char_dim, generator=generator)

    def _embs(self, feats: FeaturePack, graph: DeviceGraph,
              entity_noise_gen: Optional[torch.Generator],
              dropout_gen: Optional[torch.Generator],
              rows: Optional[torch.Tensor] = None):
        cfg = self.cfg
        ent = self.ent_embed.weight
        if entity_noise_gen is not None:
            ent = noise_ops.entity_noise(entity_noise_gen, ent,
                                         cfg.noise_ratio, cfg.mask_ratio)
        gph = self.cross_graph_model(ent, graph, dropout_gen)

        # batch-subset encoding after the graph encoder, on this rank's
        # share of the rows under a mesh (encoder.py)
        n = ent.shape[0] if rows is None else rows.shape[0]
        sel, _, mesh = split_rows(self.mesh, rows, n, None)
        surface = self.surface and feats.name is not None
        gph, img, rel, att, name, char = sel(
            [gph, feats.img, feats.rel, feats.att]
            + ([feats.name, feats.char] if surface else [None, None]))
        img, rel, att = self.img_fc(img), self.rel_fc(rel), self.att_fc(att)
        if surface:
            name, char = self.name_fc(name), self.char_fc(char)
        out = [gph, img, rel, att, name, char]
        return tuple(out if mesh is None else gather_rows(mesh, out, n))

    def _joint(self, gph, img, rel, att, name, char) -> torch.Tensor:
        """The detached weighted concat, img / att / rel / gph [/ name /
        char] (EVA.py:146-165)."""
        w = torch.softmax(self.weight_raw, dim=0)
        parts = [img, att, rel, gph] + ([] if name is None else [name, char])
        return torch.cat([w[i] * l2norm(e).detach()
                          for i, e in enumerate(parts)], dim=1)

    def forward(self, links: torch.Tensor, valid: Optional[torch.Tensor],
                feats: FeaturePack, graph: DeviceGraph,
                entity_noise_gen: Optional[torch.Generator] = None,
                dropout_gen: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Training loss (EVA.py:101-143) and its aux terms."""
        rows = None
        if self.cfg.batch_encode:
            rows, links = batch_rows(links)
        gph, img, rel, att, name, char = self._embs(
            feats, graph, entity_noise_gen, dropout_gen, rows)
        joint = self._joint(gph, img, rel, att, name, char)

        def nca(emb, alpha):
            return nca_loss(emb, links, alpha=alpha, beta=10, valid=valid)
        aux = {"gcn": nca(gph, 5), "rel": nca(rel, 15), "att": nca(att, 15),
               "img": nca(img, 15), "joi": nca(joint, 15)}
        loss_all = (aux["joi"] + aux["att"] + aux["rel"] + aux["gcn"]
                    + aux["img"])
        if name is not None:
            aux["name"], aux["char"] = nca(name, 15), nca(char, 15)
            loss_all = loss_all + aux["name"] + aux["char"]
        aux["weight_norm"] = torch.softmax(self.weight_raw, dim=0).detach()
        return loss_all, aux

    def joint_emb(self, feats: FeaturePack, graph: DeviceGraph):
        """Eval/IL embedding: (joint (N, M * d), softmax(weight_raw))."""
        joint = self._joint(*self._embs(feats, graph, None, None))
        return joint, torch.softmax(self.weight_raw, dim=0)
