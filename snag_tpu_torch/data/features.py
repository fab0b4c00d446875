"""Feature-table builders (pure numpy), the synthetic-dataset subset of
``snag_tpu/data/features.py``.

* ``build_relation_features``  — SNAG_MMEA/src/data.py:521-538 ``load_relation``
* ``build_attr_features``      — SNAG_MMEA/src/data.py:489-519 ``load_attr``
* ``assemble_image_features``  — SNAG_MMEA/src/data.py:551-581 ``load_img``

Same numpy code as the JAX package, so the same inputs and RNG give
bit-identical tables.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np


def build_relation_features(n_ent: int, triples: Sequence[Tuple[int, int, int]],
                            top_r: int = 1000) -> np.ndarray:
    """Bag-of-relations counts over the top-R most frequent relations.

    Both head and tail of a triple are credited (load_relation).
    """
    rels = [t[1] for t in triples]
    top = Counter(rels).most_common(top_r)
    rel_index = {r: i for i, (r, _) in enumerate(top)}
    width = min(top_r, len(top)) if top else top_r
    mat = np.zeros((n_ent, max(width, 1)), dtype=np.float32)
    for h, r, t in triples:
        j = rel_index.get(r)
        if j is not None:
            mat[h, j] += 1.0
            mat[t, j] += 1.0
    return mat


def build_attr_features(n_ent: int, ent_attrs: Dict[int, Iterable[str]],
                        top_a: int = 1000) -> np.ndarray:
    """Binary bag over the top-A most frequent attributes (load_attr)."""
    cnt: Counter = Counter()
    for attrs in ent_attrs.values():
        cnt.update(attrs)
    top = cnt.most_common(min(top_a, len(cnt)))
    attr2id = {a: i for i, (a, _) in enumerate(top)}
    mat = np.zeros((n_ent, max(len(attr2id), 1)), dtype=np.float32)
    for e, attrs in ent_attrs.items():
        for a in attrs:
            j = attr2id.get(a)
            if j is not None:
                mat[e, j] = 1.0
    return mat


def assemble_image_features(
    n_ent: int, img_dict: Dict[int, np.ndarray], rng: np.random.Generator,
) -> Tuple[np.ndarray, List[int], List[int]]:
    """Pack per-entity image vectors; fill missing rows with N(mean, std).

    Returns (features (N, d), ent_wo_img ids, ent_w_img ids)  (load_img).
    """
    known = np.asarray(list(img_dict.values()), dtype=np.float64)
    mean = known.mean(axis=0)
    std = known.std(axis=0)
    d = known.shape[1]
    feats = np.empty((n_ent, d), dtype=np.float64)
    ent_wo_img, ent_w_img = [], []
    for i in range(n_ent):
        v = img_dict.get(i)
        if v is None:
            feats[i] = rng.normal(mean, std, d)
            ent_wo_img.append(i)
        else:
            feats[i] = v
            ent_w_img.append(i)
    return feats.astype(np.float32), ent_wo_img, ent_w_img


def l2_normalize_rows(x: np.ndarray, eps: float = 1e-12) -> np.ndarray:
    n = np.linalg.norm(x, axis=1, keepdims=True)
    return x / np.maximum(n, eps)
