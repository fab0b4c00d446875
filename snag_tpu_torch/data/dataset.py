"""Dataset orchestration: files or the synthetic KG -> one host-side container.

Port of ``snag_tpu/data/dataset.py`` (``load_data`` -> ``_load_files`` or
``_load_synthetic`` -> ``_assemble``), returning the same ``KGData``
fields.  Everything here is numpy; the runner moves what the model reads
to its device.
"""

from __future__ import annotations

import logging
import os.path as osp
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from snag_tpu_torch.config import Config
from snag_tpu_torch.data import features as F
from snag_tpu_torch.data import io
from snag_tpu_torch.data.graph import Graph, build_graph
from snag_tpu_torch.data.synthetic import generate_synthetic_kg


@dataclass
class KGData:
    ent_num: int
    rel_num: int
    graph: Graph
    triples: List[Tuple[int, int, int]]

    img_features: np.ndarray              # (N, d_img) raw (un-normalized)
    rel_features: np.ndarray              # (N, <=1000)
    att_features: np.ndarray              # (N, <=1000)
    name_features: Optional[np.ndarray]   # (N, 300) row-normalized or None
    char_features: Optional[np.ndarray]   # (N, n_bigram) row-normalized or None
    ent_wo_img: List[int]
    ent_w_img: List[int]

    train_ill: np.ndarray                 # (T, 2) int32
    test_ill: np.ndarray                  # (Te, 2) int32
    test_ill_set: Set[Tuple[int, int]]
    left_ents: List[int]
    right_ents: List[int]
    left_non_train: List[int]
    right_non_train: List[int]

    kg1_triples: List[Tuple[int, int, int]] = field(default_factory=list)
    kg2_triples: List[Tuple[int, int, int]] = field(default_factory=list)
    kg1_entities: List[int] = field(default_factory=list)
    kg2_entities: List[int] = field(default_factory=list)

    @property
    def img_dim(self) -> int:
        return int(self.img_features.shape[1])

    @property
    def char_dim(self) -> int:
        return int(self.char_features.shape[1]) if self.char_features is not None else 100


def _split_ills(ills, data_rate: float, rng: np.random.Generator):
    """Shuffle + split ILLs by data_rate (src/data.py:153, 207-210)."""
    ills = list(ills)
    rng.shuffle(ills)
    n_train = int(len(ills) * data_rate)
    train_ill = np.asarray(ills[:n_train], dtype=np.int32)
    test_ill_ = ills[n_train:]
    test_ill = np.asarray(test_ill_, dtype=np.int32)
    return train_ill, test_ill, test_ill_


def _generate_sup_triples(train_ill, kg1_triples, kg2_triples):
    """Cross-KG triple copying for MSNEA (``snag_tpu/data/dataset.py:75``,
    reference src/data_msnea.py:405-427): for each training link (e1, e2),
    graft e1's KG1 neighbourhood onto e2 and vice versa.  The lists are
    built by the same set operations in the same order as the JAX
    package's, so they hold the same triples in the same order: MSNEA's
    positive triples are sequential slices of them."""
    rt1: Dict[int, Set] = {}
    hr1: Dict[int, Set] = {}
    for h, r, t in kg1_triples:
        rt1.setdefault(h, set()).add((r, t))
        hr1.setdefault(t, set()).add((h, r))
    rt2: Dict[int, Set] = {}
    hr2: Dict[int, Set] = {}
    for h, r, t in kg2_triples:
        rt2.setdefault(h, set()).add((r, t))
        hr2.setdefault(t, set()).add((h, r))

    new1, new2 = set(), set()
    for e1, e2 in train_ill:
        e1, e2 = int(e1), int(e2)
        for r, t in rt1.get(e1, ()):  # e1's edges, head replaced by e2
            new1.add((e2, r, t))
        for h, r in hr1.get(e1, ()):
            new1.add((h, r, e2))
        for r, t in rt2.get(e2, ()):
            new2.add((e1, r, t))
        for h, r in hr2.get(e2, ()):
            new2.add((h, r, e1))
    out1 = list(set(kg1_triples) | new1)
    out2 = list(set(kg2_triples) | new2)
    return out1, out2


def load_data(cfg: Config, logger: Optional[logging.Logger] = None) -> KGData:
    logger = logger or logging.getLogger("snag_tpu_torch")
    if cfg.data_choice == "SYNTH":
        return _load_synthetic(cfg, logger)
    return _load_files(cfg, logger)


def _load_synthetic(cfg: Config, logger) -> KGData:
    (ills, triples, img_dict, ent_attrs, left_ents, right_ents,
     kg1_triples, kg2_triples, _names) = generate_synthetic_kg(
        n_ents=cfg.synth_ents, n_rels=cfg.synth_rels,
        n_triples=cfg.synth_triples, img_dim=cfg.synth_img_dim,
        seed=cfg.random_seed)
    rng = np.random.default_rng(cfg.random_seed)
    n_ent = cfg.synth_ents
    img, ent_wo_img, ent_w_img = F.assemble_image_features(n_ent, img_dict, rng)
    rel = F.build_relation_features(n_ent, triples, 1000)
    att = F.build_attr_features(n_ent, ent_attrs, 1000)

    name_feat = char_feat = None
    if cfg.w_name or cfg.w_char:
        # synthetic "names": noisy latent views, normalized like the real path
        name_feat = F.l2_normalize_rows(
            rng.normal(size=(n_ent, 300)).astype(np.float32))
        char_feat = F.l2_normalize_rows(
            rng.normal(size=(n_ent, 100)).astype(np.float32))

    train_ill, test_ill, test_ill_ = _split_ills(ills, cfg.data_rate, rng)
    return _assemble(cfg, logger, n_ent, cfg.synth_rels, triples, img,
                     ent_wo_img, ent_w_img, rel, att, name_feat, char_feat,
                     train_ill, test_ill, test_ill_, left_ents, right_ents,
                     kg1_triples, kg2_triples)


def _load_files(cfg: Config, logger) -> KGData:
    """One dataset directory in the reference's on-disk layout
    (``data/export_reference.py`` writes it)."""
    if "OEA" in cfg.data_choice:
        file_dir = osp.join(cfg.data_path, "OpenEA", cfg.data_choice)
    else:
        file_dir = osp.join(cfg.data_path, cfg.data_choice, cfg.data_split)
    ent2id, ills, triples, r_hs, _, _ = io.read_raw_data(file_dir)
    left_ents = io.get_ids(osp.join(file_dir, "ent_ids_1"))
    right_ents = io.get_ids(osp.join(file_dir, "ent_ids_2"))
    n_ent = len(ent2id)
    n_rel = len(r_hs)

    img_path = io.resolve_img_pickle(cfg.data_path, cfg.data_choice,
                                     cfg.data_split, cfg.ratio)
    img, ent_wo_img, ent_w_img = F.load_img_pickle(n_ent, img_path,
                                                   cfg.random_seed)
    logger.info(f"image feature shape: {img.shape}; {len(ent_wo_img)} "
                "entities without image")

    name_feat = char_feat = None
    if cfg.data_choice == "DBP15K" and (cfg.w_name or cfg.w_char):
        name_path = osp.join(cfg.data_path, "DBP15K", "translated_ent_name",
                             f"dbp_{cfg.data_split}.json")
        w2v_path = osp.join(cfg.data_path, "embedding", "glove.6B.300d.txt")
        name_feat, char_feat = F.build_name_char_features(
            n_ent, io.read_ent_names(name_path), F.load_word2vec(w2v_path),
            np.random.default_rng(cfg.random_seed))

    if cfg.unsup:
        feats = {"char": char_feat, "name": name_feat}.get(
            cfg.unsup_mode, F.l2_normalize_rows(img))
        if feats is None:
            raise ValueError(f"--unsup_mode {cfg.unsup_mode} needs the "
                             "surface features: pass --use_surface 1 with "
                             "DBP15K")
        train_ill = F.visual_pivot_induction(left_ents, right_ents, feats,
                                             cfg.unsup_k)
        test_ill_ = list(ills)
        np.random.default_rng(cfg.random_seed).shuffle(test_ill_)
        test_ill = np.asarray(test_ill_, dtype=np.int32)
    else:
        # the reference seeds the legacy global RNG at start and its first
        # draw is this shuffle (main.py:41 -> src/data.py:153): the same
        # seed gives the reference's train/test split
        train_ill, test_ill, test_ill_ = _split_ills(
            ills, cfg.data_rate, np.random.RandomState(cfg.random_seed))

    rel = F.build_relation_features(n_ent, triples, 1000)
    ent_attrs = io.read_attrs([osp.join(file_dir, "training_attrs_1"),
                               osp.join(file_dir, "training_attrs_2")], ent2id)
    att = F.build_attr_features(n_ent, ent_attrs, 1000)
    kg1 = io.read_tuples([osp.join(file_dir, "triples_1")])
    kg2 = io.read_tuples([osp.join(file_dir, "triples_2")])
    return _assemble(cfg, logger, n_ent, n_rel, triples, img, ent_wo_img,
                     ent_w_img, rel, att, name_feat, char_feat, train_ill,
                     test_ill, test_ill_, left_ents, right_ents, kg1, kg2)


def _assemble(cfg, logger, n_ent, n_rel, triples, img, ent_wo_img,
              ent_w_img, rel, att, name_feat, char_feat, train_ill, test_ill,
              test_ill_, left_ents, right_ents, kg1_triples, kg2_triples
              ) -> KGData:
    graph = build_graph(n_ent, triples)
    left_non_train = list(set(left_ents) - set(train_ill[:, 0].tolist()))
    right_non_train = list(set(right_ents) - set(train_ill[:, 1].tolist()))

    if cfg.model_name == "MSNEA":
        kg1_triples, kg2_triples = _generate_sup_triples(
            train_ill, kg1_triples, kg2_triples)

    logger.info("----- dataset summary -----")
    logger.info(f"triples: {len(triples)}  entities: {n_ent}  relations: {n_rel}")
    logger.info(f"graph edges (self-loops included): {graph.n_edges}")
    logger.info(f"train ill: {train_ill.shape[0]}  test ill: {test_ill.shape[0]}")
    logger.info(f"non-train: {len(left_non_train)} left / {len(right_non_train)} right")

    return KGData(
        ent_num=n_ent, rel_num=n_rel, graph=graph, triples=list(triples),
        img_features=np.asarray(img, dtype=np.float32),
        rel_features=np.asarray(rel, dtype=np.float32),
        att_features=np.asarray(att, dtype=np.float32),
        name_features=name_feat, char_features=char_feat,
        ent_wo_img=ent_wo_img, ent_w_img=ent_w_img,
        train_ill=train_ill, test_ill=test_ill,
        test_ill_set=set(map(tuple, test_ill_)),
        left_ents=list(left_ents), right_ents=list(right_ents),
        left_non_train=left_non_train, right_non_train=right_non_train,
        kg1_triples=list(kg1_triples), kg2_triples=list(kg2_triples),
        kg1_entities=list(left_ents), kg2_entities=list(right_ents),
    )
