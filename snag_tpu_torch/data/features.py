"""Feature-table builders (pure numpy), port of ``snag_tpu/data/features.py``.

* ``build_relation_features``  — SNAG_MMEA/src/data.py:521-538 ``load_relation``
* ``build_attr_features``      — SNAG_MMEA/src/data.py:489-519 ``load_attr``
* ``assemble_image_features``  — SNAG_MMEA/src/data.py:551-581 ``load_img``
* ``load_img_pickle``          — the image pickle into ``assemble_image_features``
* ``build_name_char_features`` — SNAG_MMEA/src/data.py:318-365
* ``load_word2vec``            — GloVe-format text embeddings
* ``visual_pivot_induction``   — SNAG_MMEA/src/data.py:367-402

Same numpy code as the JAX package, so the same inputs and RNG give
bit-identical tables.
"""

from __future__ import annotations

import pickle
from collections import Counter
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

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


def load_img_pickle(n_ent: int, path: str, seed: int = 0):
    """``{id: float32[d]}`` pickle -> ``assemble_image_features``, missing
    rows drawn from ``default_rng(seed)``.  Reads the JAX package's
    exports and the port's alike (both write plain dicts of numpy rows)."""
    with open(path, "rb") as f:
        img_dict = pickle.load(f)
    return assemble_image_features(n_ent, img_dict, np.random.default_rng(seed))


def build_name_char_features(
    n_ent: int,
    ent_names: Sequence[Tuple[int, Sequence[str]]],
    word_vecs: Dict[str, np.ndarray],
    rng: Optional[np.random.Generator] = None,
    word_dim: int = 300,
) -> Tuple[np.ndarray, np.ndarray]:
    """Mean word embedding + char-bigram counts per entity, row-normalized.

    (load_word_char_features; bigram vocabulary built in first-seen order as
    in load_char_bigram.)
    """
    rng = rng or np.random.default_rng(0)
    char2id: Dict[str, int] = {}
    for _, name in ent_names:
        for word in name:
            w = word.lower()
            for k in range(len(w) - 1):
                bg = w[k:k + 2]
                if bg not in char2id:
                    char2id[bg] = len(char2id)

    ent_vec = np.zeros((n_ent, word_dim))
    char_vec = np.zeros((n_ent, max(len(char2id), 1)))
    for i, name in ent_names:
        k = 0
        for word in name:
            w = word.lower()
            if w in word_vecs:
                ent_vec[i] += word_vecs[w]
                k += 1
            for j in range(len(w) - 1):
                char_vec[i, char2id[w[j:j + 2]]] += 1
        if k:
            ent_vec[i] /= k
        else:
            ent_vec[i] = rng.random(word_dim) - 0.5
        if char_vec[i].sum() == 0:
            char_vec[i] = rng.random(char_vec.shape[1]) - 0.5
        ent_vec[i] = ent_vec[i] / np.linalg.norm(ent_vec[i])
        char_vec[i] = char_vec[i] / np.linalg.norm(char_vec[i])
    return ent_vec.astype(np.float32), char_vec.astype(np.float32)


def load_word2vec(path: str, dim: int = 300) -> Dict[str, np.ndarray]:
    """GloVe-format text embeddings (load_word2vec); lines of another width
    or with an unparsable number are skipped."""
    word2vec = {}
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip("\n").split(" ")
            if len(parts) != dim + 1:
                continue
            try:
                word2vec[parts[0].lower()] = np.asarray(parts[1:], dtype=np.float64)
            except ValueError:
                continue
    return word2vec


def visual_pivot_induction(
    left_ents: Sequence[int], right_ents: Sequence[int],
    features: np.ndarray, topk: int,
) -> np.ndarray:
    """Unsupervised seeding: top-k mutual image-similarity pairs as pseudo
    training links (visual_pivot_induction).  Greedy top-(100k) scan with a
    used-set, like the reference."""
    l = features[np.asarray(left_ents)]
    r = features[np.asarray(right_ents)]
    sim = l @ r.T
    flat = sim.ravel()
    k = min(topk * 100, flat.size)
    idx = np.argpartition(-flat, k - 1)[:k]
    idx = idx[np.argsort(-flat[idx])]
    w = sim.shape[1]
    used = set()
    links = []
    for ind in idx:
        i, j = int(ind // w), int(ind % w)
        le, re_ = left_ents[i], right_ents[j]
        if le in used or re_ in used:
            continue
        used.add(le)
        used.add(re_)
        links.append((le, re_))
        if len(links) == topk:
            break
    return np.asarray(links, dtype=np.int32)
