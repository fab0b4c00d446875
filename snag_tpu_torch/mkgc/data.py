"""MKGC data pipeline: a numpy copy of ``snag_tpu/mkgc/data.py``.

Datasets: DB15K, MKG-W, MKG-Y (SNAG_MKGC/readme.md:16).  On disk:

  <data_path>/<DATASET>/
      train.txt | train.tsv     h \t r \t t   (ids or names)
      valid.txt, test.txt       (or OpenKE's train2id.txt ...: h t r,
                                 a count on the first line)
      entity2id.txt, relation2id.txt          (optional; derived if absent)
      visual.pkl / <DATASET>_visual.pkl       {entity: np vector}
      textual.pkl / <DATASET>_textual.pkl

Entities missing from a loaded pickle get N(mean, std) fills, as the MMEA
image loader gives imageless entities (src/data.py:551-581).  An entirely
ABSENT pickle is a hard error unless --allow_missing_features 1 is passed
(triples-only structural runs), so a typo'd data_path cannot silently train
on random tables.  Every array is drawn from the same numpy generator in
the same order as the JAX package's loader, so both return the same bits.
"""

from __future__ import annotations

import logging
import os.path as osp
import pickle
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from snag_tpu_torch.mkgc.config import MKGCConfig


@dataclass
class MKGCData:
    ent_num: int
    rel_num: int
    train: np.ndarray        # (n, 3) int32
    valid: np.ndarray
    test: np.ndarray
    visual: np.ndarray       # (E, dv) float32
    textual: np.ndarray      # (E, dt)
    ent_wo_visual: List[int]
    # filtered-eval structures: all true triples grouped by (h, r) and (r, t)
    hr_to_t: Dict[Tuple[int, int], List[int]]
    rt_to_h: Dict[Tuple[int, int], List[int]]


def _read_triples(path: str, ent2id, rel2id, order: str = "hrt") -> np.ndarray:
    """``order``: "hrt" (tab files) or "htr" (OpenKE train2id-style)."""
    out = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 3:
                parts = line.split()
            if len(parts) < 3:
                continue  # OpenKE first line = count
            if order == "htr":
                h, t, r = parts[0], parts[1], parts[2]
            else:
                h, r, t = parts[0], parts[1], parts[2]
            out.append((ent2id.setdefault(h, len(ent2id)),
                        rel2id.setdefault(r, len(rel2id)),
                        ent2id.setdefault(t, len(ent2id))))
    return np.asarray(out, dtype=np.int32)


def _load_id_map(path: str) -> Optional[Dict[str, int]]:
    if not osp.exists(path):
        return None
    out = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 2:
                parts = line.split()
            if len(parts) >= 2:
                try:
                    out[parts[0]] = int(parts[1])
                except ValueError:
                    out[parts[1]] = int(parts[0])
    return out or None


def _feature_table(n_ent: int, pkl_paths: List[str], ent2id,
                   fallback_dim: int, rng, logger,
                   allow_missing: bool = False) -> Tuple[np.ndarray, List[int]]:
    table_dict = None
    for p in pkl_paths:
        if osp.exists(p):
            with open(p, "rb") as f:
                raw = pickle.load(f)
            table_dict = {}
            for k, v in raw.items():
                if isinstance(k, str):
                    if k in ent2id:
                        table_dict[ent2id[k]] = np.asarray(v)
                else:
                    table_dict[int(k)] = np.asarray(v)
            logger.info(f"loaded features {p}: {len(table_dict)} entities")
            break
    if not table_dict:
        # a typo'd data_path would otherwise train a plausible-looking model
        # on pure noise; the per-entity N(mean, std) fill below handles
        # PARTIAL coverage (reference src/data.py:551-581)
        if not allow_missing:
            raise FileNotFoundError(
                f"no feature pickle found among {pkl_paths}; training would "
                f"silently use random feature tables.  Pass "
                f"--allow_missing_features 1 to run on triples-only dumps.")
        logger.warning(f"no feature pickle among {pkl_paths}; filling random "
                       f"(--allow_missing_features)")
        table = rng.normal(size=(n_ent, fallback_dim)).astype(np.float32)
        return table, list(range(n_ent))

    dim = next(iter(table_dict.values())).shape[-1]
    known = np.stack([v.reshape(-1) for v in table_dict.values()])
    mean, std = known.mean(0), known.std(0)
    table = np.empty((n_ent, dim), dtype=np.float32)
    missing = []
    for i in range(n_ent):
        v = table_dict.get(i)
        if v is None:
            table[i] = rng.normal(mean, std)
            missing.append(i)
        else:
            table[i] = v.reshape(-1)
    return table, missing


def _group_filters(triples_list):
    hr_to_t: Dict[Tuple[int, int], List[int]] = {}
    rt_to_h: Dict[Tuple[int, int], List[int]] = {}
    for h, r, t in triples_list:
        hr_to_t.setdefault((int(h), int(r)), []).append(int(t))
        rt_to_h.setdefault((int(r), int(t)), []).append(int(h))
    return hr_to_t, rt_to_h


def load_mkgc_data(cfg: MKGCConfig, logger=None) -> MKGCData:
    logger = logger or logging.getLogger("snag_tpu_torch")
    if cfg.data_choice == "SYNTH":
        return _synthetic(cfg, logger)

    d = osp.join(cfg.data_path, cfg.data_choice)
    ent2id = _load_id_map(osp.join(d, "entity2id.txt")) or {}
    rel2id = _load_id_map(osp.join(d, "relation2id.txt")) or {}

    def tri(name):
        for stem, order in ((name, cfg.triple_order),
                            (name + "2id", "htr")):      # OpenKE layout
            for ext in (".txt", ".tsv"):
                p = osp.join(d, stem + ext)
                if osp.exists(p):
                    return _read_triples(p, ent2id, rel2id, order)
        raise FileNotFoundError(f"{name} triples not found under {d}")

    train, valid, test = tri("train"), tri("valid"), tri("test")
    n_ent, n_rel = len(ent2id), len(rel2id)
    rng = np.random.default_rng(cfg.random_seed)

    allow = bool(getattr(cfg, "allow_missing_features", 0))
    visual, wo_vis = _feature_table(
        n_ent, [osp.join(d, "visual.pkl"),
                osp.join(d, f"{cfg.data_choice}_visual.pkl")],
        ent2id, 4096, rng, logger, allow_missing=allow)
    textual, _ = _feature_table(
        n_ent, [osp.join(d, "textual.pkl"),
                osp.join(d, f"{cfg.data_choice}_textual.pkl")],
        ent2id, 768, rng, logger, allow_missing=allow)

    allt = np.concatenate([train, valid, test])
    hr_to_t, rt_to_h = _group_filters(allt)
    logger.info(f"MKGC {cfg.data_choice}: {n_ent} ents, {n_rel} rels, "
                f"{len(train)}/{len(valid)}/{len(test)} triples")
    return MKGCData(ent_num=n_ent, rel_num=n_rel, train=train, valid=valid,
                    test=test, visual=visual, textual=textual,
                    ent_wo_visual=wo_vis, hr_to_t=hr_to_t, rt_to_h=rt_to_h)


def _synthetic(cfg: MKGCConfig, logger) -> MKGCData:
    """Learnable toy LP task: entity latents; relation = latent offset;
    modality features are noisy latent views."""
    rng = np.random.default_rng(cfg.random_seed)
    e, r = cfg.synth_ents, cfg.synth_rels
    lat = rng.normal(size=(e, 16))
    rel_off = rng.normal(size=(r, 16))

    if e * e * r <= 2e8:
        # deterministic nearest-neighbour targets -> exactly TransE-shaped;
        # enumerate all (h, r) pairs and keep a shuffled subset
        targets = lat[:, None, :] + rel_off[None, :, :]      # (e, r, 16)
        d2 = ((targets[:, :, None, :] - lat[None, None, :, :]) ** 2).sum(-1)
        tails = d2.argmin(axis=2)                            # (e, r)
        hs, rs = np.meshgrid(np.arange(e), np.arange(r), indexing="ij")
        triples = np.stack([hs.ravel(), rs.ravel(), tails.ravel()], axis=1)
        triples = triples[triples[:, 0] != triples[:, 2]]
        rng.shuffle(triples)
        triples = triples[:cfg.synth_triples].astype(np.int32)
    else:
        # large scale (throughput benchmarking): random triples — structure
        # quality is irrelevant, only shapes matter
        hs = rng.integers(0, e, size=cfg.synth_triples)
        rs = rng.integers(0, r, size=cfg.synth_triples)
        ts = rng.integers(0, e, size=cfg.synth_triples)
        keep = hs != ts
        triples = np.stack([hs[keep], rs[keep], ts[keep]], axis=1).astype(np.int32)
    rng.shuffle(triples)
    n = len(triples)
    train = triples[:int(0.8 * n)]
    valid = triples[int(0.8 * n):int(0.9 * n)]
    test = triples[int(0.9 * n):]

    def view(dim):
        proj = rng.normal(size=(16, dim)) / 4
        return (lat @ proj + 0.3 * rng.normal(size=(e, dim))).astype(np.float32)

    hr_to_t, rt_to_h = _group_filters(triples)
    return MKGCData(ent_num=e, rel_num=r, train=train, valid=valid, test=test,
                    visual=view(cfg.synth_vis_dim),
                    textual=view(cfg.synth_txt_dim), ent_wo_visual=[],
                    hr_to_t=hr_to_t, rt_to_h=rt_to_h)
