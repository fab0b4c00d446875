"""Shared multi-modal encoder.

Port of ``snag_tpu/models/encoder.py::MultiModalEncoder`` (:70-210) with
the GAT or GCN structure encoder (``--structure_encoder``, :99-109), the
optional projection heads (``--use_project_head``, :127-133, :169) and a
fusion chosen by ``fusion_kind`` (:76, :111-126, :196-206): ``mformer``
(SNAG, reference SNAG_MMEA/model/SNAG_tools.py:53-156), ``mformer_single``
(MEAformer: no frozen-weight path), ``mean`` (MCLEA) or ``none``.
Submodules carry the reference's torch names (``entity_emb``, ``img_fc``,
``rel_fc``, ``att_fc``, ``cross_graph_model.layer_stack.{i}`` or
``cross_graph_model.gc{1,2}``, ``fusion.fusion_layer.{i}``,
``fusion.weight_raw`` or ``fusion.weight``, ``{img,att,rel,gph}_pro.l{1,2}``),
so a reference state dict loads strictly.

Training inputs of the forward: ``entity_noise_gen`` (entity-embedding
noise at half rates, :151-153), ``dropout_gen`` (None = deterministic) and
``rows`` (encode only a batch's entities after the graph encoder,
:155-167).  Feature-table noise is applied by the caller, once per epoch
(``apply_feature_noise``).

Under a mesh of N > 1 ranks (``mesh``, set by ``parallel.mesh.attach``)
the structure encoder runs whole on every rank, the per-entity work after
it (the five projections, the heads, the fusion) on this rank's share of
the rows (``Mesh.rows``), its dropout masks drawn at the full row count
(``ops.noise.RowSlice``), and one differentiable gather
(``parallel.mesh.gather_rows``) puts every per-row output back in order
on every rank; ``weight_fz`` is no per-row output and is not gathered.
There each rank holds its share of every feature table
(``place_features``): a forward over every entity reads its own rows, and
a batch's rows of every table come from their owners in one fetch
(``parallel.mesh.take``).

``--dtype bfloat16`` (the JAX package's ``dtype`` property, :78-80): the
five projections and the fusion stack compute in bf16 with f32
parameters, the GAT gathers bf16 rows and returns f32, ``entity_emb``,
the feature tables and their noise stay f32, and the joint embeddings are
f32 (f32 weights times modality rows).  The GCN computes its layers'
``support`` in bf16 and sums it with the bf16 adjacency into f32
(``ops/gnn.py``); EVA's GCN (``models/eva.py``) stays f32.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch import nn

from snag_tpu_torch.config import Config
from snag_tpu_torch.data.graph import DeviceGraph
from snag_tpu_torch.ops import inits
from snag_tpu_torch.ops import noise as noise_ops
from snag_tpu_torch.ops.fusion import MeanFusion, MformerFusion, tlinear
from snag_tpu_torch.ops.gnn import GAT, GCN
from snag_tpu_torch.parallel.mesh import (Table, gather_rows, shard_table,
                                          take)


class FeaturePack(NamedTuple):
    """Per-entity modality feature tables (None = modality absent), each
    whole or, under a mesh of N > 1 ranks, this rank's ``RowShard``."""
    img: Optional[Table]
    rel: Optional[Table]
    att: Optional[Table]
    name: Optional[Table]
    char: Optional[Table]


class FeatureStats(NamedTuple):
    """Column statistics for noise-masking (img over image-bearing rows)."""
    img: noise_ops.TableStats
    rel: noise_ops.TableStats
    att: noise_ops.TableStats


class EncoderOutput(NamedTuple):
    """None where the fusion kind has no such output: ``joint_fz`` and
    ``weight_fz`` outside ``mformer``, ``hidden`` and ``weight_norm``
    outside the Mformer kinds, everything fused under ``none``."""
    gph: Optional[torch.Tensor]
    img: Optional[torch.Tensor]
    rel: Optional[torch.Tensor]
    att: Optional[torch.Tensor]
    name: Optional[torch.Tensor]
    char: Optional[torch.Tensor]
    joint: Optional[torch.Tensor]
    joint_fz: Optional[torch.Tensor]
    hidden: Optional[torch.Tensor]
    weight_norm: Optional[torch.Tensor]
    weight_fz: Optional[torch.Tensor]


def compute_dtype(cfg: Config) -> torch.dtype:
    """The encoder's compute dtype from ``--dtype``."""
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


FUSION_KINDS = ("mformer", "mformer_single", "mean", "none")


class MultiModalEncoder(nn.Module):
    def __init__(self, cfg: Config, ent_num: int, img_feature_dim: int,
                 attr_input_dim: int, rel_input_dim: int,
                 char_feature_dim: int, generator: torch.Generator,
                 fusion_kind: str = "mformer"):
        super().__init__()
        if fusion_kind not in FUSION_KINDS:
            raise ValueError(f"fusion_kind {fusion_kind!r} is not one of "
                             f"{FUSION_KINDS}")
        self.cfg = cfg
        self.fusion_kind = fusion_kind
        self.mesh = None
        dt = compute_dtype(cfg)
        input_dim = cfg.n_units()[0]
        self.entity_emb = nn.Embedding(ent_num, input_dim)
        with torch.no_grad():
            self.entity_emb.weight.copy_(inits.normal_std(
                (ent_num, input_dim), 1.0 / math.sqrt(ent_num), generator))

        # rel_fc draws at the reference's fixed 1000-column fan-in
        # (src/data.py:521-538) whatever the width of our table
        if cfg.w_rel:
            self.rel_fc = tlinear(rel_input_dim, cfg.attr_dim, generator,
                                  fan_in=1000, dtype=dt)
        if cfg.w_attr:
            self.att_fc = tlinear(attr_input_dim, cfg.attr_dim, generator,
                                  dtype=dt)
        if cfg.w_img:
            self.img_fc = tlinear(img_feature_dim, cfg.img_dim, generator,
                                  dtype=dt)
        if cfg.w_name:
            self.name_fc = tlinear(300, cfg.char_dim, generator, dtype=dt)
        if cfg.w_char:
            self.char_fc = tlinear(char_feature_dim, cfg.char_dim, generator,
                                   dtype=dt)

        if cfg.w_gcn and cfg.structure_encoder == "gcn":
            u = cfg.n_units()
            self.cross_graph_model = GCN(u[0], u[1], u[2], generator,
                                         dropout=cfg.dropout, dtype=dt)
        elif cfg.w_gcn:
            self.cross_graph_model = GAT(
                cfg.n_units(), cfg.n_heads(), generator, dropout=cfg.dropout,
                attn_dropout=cfg.attn_dropout,
                instance_normalization=cfg.instance_normalization, diag=True,
                dtype=dt)
        if fusion_kind in ("mformer", "mformer_single"):
            self.fusion = MformerFusion(
                cfg.hidden_size, cfg.num_attention_heads,
                cfg.num_hidden_layers, cfg.intermediate_size,
                bool(cfg.use_intermediate), generator, dt,
                with_fz=fusion_kind == "mformer")
        elif fusion_kind == "mean":
            self.fusion = MeanFusion(cfg.inner_view_num)

        if cfg.use_project_head:
            from snag_tpu_torch.models.heads import ProjectionHead
            u2 = cfg.n_units()[2]
            self.img_pro = ProjectionHead(cfg.img_dim, cfg.img_dim,
                                          cfg.img_dim, generator, cfg.dropout)
            self.att_pro = ProjectionHead(cfg.attr_dim, cfg.attr_dim,
                                          cfg.attr_dim, generator, cfg.dropout)
            self.rel_pro = ProjectionHead(cfg.attr_dim, cfg.attr_dim,
                                          cfg.attr_dim, generator, cfg.dropout)
            self.gph_pro = ProjectionHead(u2, u2, u2, generator, cfg.dropout)

    def forward(self, feats: FeaturePack, graph: DeviceGraph,
                entity_noise_gen: Optional[torch.Generator] = None,
                dropout_gen: Optional[torch.Generator] = None,
                rows: Optional[torch.Tensor] = None,
                keep: Optional[Sequence[str]] = None) -> EncoderOutput:
        """``keep``: the per-row fields to return (None: all), the others
        None; under a mesh only those are gathered (the evaluation's
        embedding needs two of the ten)."""
        cfg = self.cfg
        n = self.entity_emb.num_embeddings if rows is None else rows.shape[0]
        sel, row_gen, mesh = split_rows(self.mesh, rows, n, dropout_gen)
        gph = None
        if cfg.w_gcn:
            ent = self.entity_emb.weight
            if entity_noise_gen is not None:
                ent = noise_ops.entity_noise(entity_noise_gen, ent,
                                             cfg.noise_ratio, cfg.mask_ratio)
            gph = self.cross_graph_model(ent, graph, dropout_gen)

        gph, img, rel, att, name, char = sel([
            gph, feats.img if cfg.w_img else None,
            feats.rel if cfg.w_rel else None,
            feats.att if cfg.w_attr else None,
            feats.name if cfg.w_name else None,
            feats.char if cfg.w_char else None])
        img = None if img is None else self.img_fc(img)
        rel = None if rel is None else self.rel_fc(rel)
        att = None if att is None else self.att_fc(att)
        name = None if name is None else self.name_fc(name)
        char = None if char is None else self.char_fc(char)

        if cfg.use_project_head:
            def head(mod, e):
                return None if e is None else mod(e, row_gen)
            gph = head(self.gph_pro, gph)
            img = head(self.img_pro, img)
            rel = head(self.rel_pro, rel)
            att = head(self.att_pro, att)

        fusion_inputs = [img, att, rel, gph, name, char]
        joint = joint_fz = hidden = weight_norm = weight_fz = None
        if self.fusion_kind in ("mformer", "mformer_single"):
            joint, joint_fz, hidden, weight_norm, weight_fz = self.fusion(
                fusion_inputs, row_gen)
        elif self.fusion_kind == "mean":
            joint = self.fusion(fusion_inputs)
        rows_out = dict(gph=gph, img=img, rel=rel, att=att, name=name,
                        char=char, joint=joint, joint_fz=joint_fz,
                        hidden=hidden, weight_norm=weight_norm)
        if keep is not None:
            rows_out = {k: v if k in keep else None
                        for k, v in rows_out.items()}
        if mesh is not None:
            rows_out = dict(zip(rows_out, gather_rows(
                mesh, list(rows_out.values()), n)))
        return EncoderOutput(**rows_out, weight_fz=weight_fz)


def split_rows(mesh, rows: Optional[torch.Tensor], n: int,
               dropout_gen: Optional[torch.Generator]):
    """(sel, row_gen, mesh) of a forward over ``n`` entity rows (``rows``,
    or every entity where None): ``sel`` takes a list of per-entity
    tensors (the structure encoder's output, the feature tables, whole or
    this rank's ``RowShard``; None passes through) to the rows this rank
    computes, fetching every table's other rows in one ``take``;
    ``row_gen`` is the dropout generator of those rows, and ``mesh`` is
    None where one rank computes every row (no mesh, or a mesh of one:
    its forward is the plain one, bit for bit)."""
    if mesh is None or mesh.world == 1:
        return ((lambda ts: list(ts)) if rows is None else
                (lambda ts: [None if t is None else t[rows] for t in ts]),
                dropout_gen, None)
    lo, hi = mesh.rows(n)
    local = slice(lo, hi) if rows is None else rows[lo:hi]
    return ((lambda ts: take(mesh, ts, local)),
            noise_ops.row_slice(dropout_gen, lo, hi, n), mesh)


def _host_tables(cfg: Config, data):
    """Each feature table's name and host array (None = absent); image
    rows normalized (SNAG.py:23)."""
    img = np.asarray(data.img_features, dtype=np.float32)
    n = np.linalg.norm(img, axis=1, keepdims=True)
    return {"img": img / np.maximum(n, 1e-12), "rel": data.rel_features,
            "att": data.att_features,
            "name": data.name_features if cfg.w_name else None,
            "char": data.char_features if cfg.w_char else None}


def place_features(cfg: Config, data, device, mesh=None):
    """(tables, noise statistics or None) of a run.  Each table is put on
    ``device`` alone; with ``--add_noise`` its statistics come from the
    whole table (SNAG.py:77-84: the image's over the image-bearing rows of
    the normalised table, rel/att over all rows); then, under a mesh of
    N > 1 ranks, only this rank's share is kept
    (``parallel.mesh.shard_table``).  So the device holds one whole table
    at most, and the statistics are the plain run's bit for bit."""
    w_img = (torch.as_tensor(np.asarray(data.ent_w_img, dtype=np.int64),
                             device=device) if cfg.add_noise else None)
    tables, stats = {}, {}
    for name, a in _host_tables(cfg, data).items():
        t = None if a is None else torch.as_tensor(
            np.ascontiguousarray(a, dtype=np.float32), device=device)
        if t is not None and cfg.add_noise and name in FeatureStats._fields:
            stats[name] = noise_ops.table_stats(
                t, valid_rows=w_img if name == "img" else None)
        tables[name] = None if t is None else shard_table(mesh, t)
        del t       # before the next table is put
    return (FeaturePack(**tables),
            FeatureStats(**stats) if cfg.add_noise else None)


def batch_rows(links: torch.Tensor):
    """(rows, local_links) for batch-subset encoding: rows stacks the left
    then the right link entities; local_links index into that stack."""
    b = links.shape[0]
    rows = torch.cat([links[:, 0], links[:, 1]])
    ar = torch.arange(b, dtype=links.dtype, device=links.device)
    return rows, torch.stack([ar, b + ar], dim=1)


def apply_feature_noise(gen: torch.Generator, feats: FeaturePack,
                        stats: FeatureStats, noise_ratio: float,
                        mask_ratio: float) -> FeaturePack:
    """Per-epoch noisy views of img/rel/att (update_noise, SNAG.py:86-91);
    name/char features are never noised in the reference."""
    def noised(x, st):
        return noise_ops.noise_mask_table(gen, x, st, noise_ratio, mask_ratio)
    return feats._replace(img=noised(feats.img, stats.img),
                          rel=noised(feats.rel, stats.rel),
                          att=noised(feats.att, stats.att))
