"""Synthetic miniature MMEA dataset.

A learnable two-KG alignment task used by the test-suite and smoke benches
(no reference equivalent — fills the fixture role SURVEY.md §4 calls for).
Aligned entity pairs share a latent vector; all modality features are noisy
views of it, so contrastive alignment converges within a few hundred steps.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def generate_synthetic_kg(
    n_ents: int = 200,
    n_rels: int = 20,
    n_triples: int = 800,
    img_dim: int = 64,
    seed: int = 0,
    latent_dim: int = 16,
    noise: float = 0.3,
    mirror_p: float = 0.7,
    unalignable_frac: float = 0.0,
    img_coverage: float = 0.9,
):
    """Returns (ills, triples, img_dict, ent_attrs, left_ents, right_ents,
    kg1_triples, kg2_triples, ent_names).

    Entities [0, n1) form KG1, [n1, n) form KG2; pair (i, n1 + i) is aligned.
    ``1 - img_coverage`` (default 10%) of entities have no image, which
    exercises the missing-image fill path — but that fill is a random draw
    seeded independently per framework, so cross-framework weight-import
    tests should pass ``img_coverage=1.0``.

    Hard-mode knobs (the non-saturated parity-oracle operating points —
    at the defaults the task converges to MRR ~1.0 where any roughly-correct
    implementation passes):
    * ``noise``: feature-noise scale on every modality view;
    * ``mirror_p``: probability a KG1 triple is mirrored into KG2 (structure
      signal strength);
    * ``unalignable_frac``: fraction of test pairs whose right-side entity
      gets an INDEPENDENT latent — no modality carries their alignment, so
      achievable MRR is capped well below 1.
    """
    rng = np.random.default_rng(seed)
    n1 = n_ents // 2
    n2 = n_ents - n1
    n_pairs = min(n1, n2)

    latent = rng.normal(size=(n_pairs, latent_dim))
    latent_r = latent.copy()
    if unalignable_frac > 0:
        k = int(n_pairs * unalignable_frac)
        broken = rng.choice(n_pairs, size=k, replace=False)
        latent_r[broken] = rng.normal(size=(k, latent_dim))

    def noisy_view(dim: int) -> np.ndarray:
        proj = rng.normal(size=(latent_dim, dim)) / np.sqrt(latent_dim)
        both = np.concatenate([latent, latent_r], axis=0) @ proj
        return both + noise * rng.normal(size=both.shape)

    img = noisy_view(img_dim)

    img_dict: Dict[int, np.ndarray] = {}
    for k in range(2 * n_pairs):
        ent = k if k < n_pairs else n1 + (k - n_pairs)
        # (kept as `> 1 - coverage` so the default keeps the exact RNG
        # acceptance pattern the calibrated parity fixtures were minted on)
        if rng.random() > 1.0 - img_coverage:
            img_dict[ent] = img[k]

    # attributes: latent-bucketed attribute names shared across KGs
    ent_attrs: Dict[int, List[str]] = {}
    n_attr_names = 50
    attr_proj = rng.normal(size=(latent_dim, n_attr_names))
    logits_l = latent @ attr_proj
    logits_r = latent_r @ attr_proj
    for k in range(2 * n_pairs):
        ent = k if k < n_pairs else n1 + (k - n_pairs)
        row = (logits_l if k < n_pairs else logits_r)[k % n_pairs]
        chosen = np.argsort(-row)[:5]
        ent_attrs[ent] = [f"attr_{c}" for c in chosen]

    # entity names: latent-bucketed word lists (surface-modality signal;
    # every word lands in the exported fake GloVe so neither framework
    # hits its missing-word random fallback — features stay comparable)
    ent_names: Dict[int, List[str]] = {}
    n_words = 60
    name_proj = rng.normal(size=(latent_dim, n_words))
    nlog_l = latent @ name_proj
    nlog_r = latent_r @ name_proj
    for ent in range(n_ents):
        if ent < n1 and ent < n_pairs:
            row = nlog_l[ent]
        elif ent >= n1 and (ent - n1) < n_pairs:
            row = nlog_r[ent - n1]
        else:
            row = rng.normal(size=(n_words,))
        chosen = np.argsort(-row)[:3]
        ent_names[ent] = [f"word{c:02d}" for c in chosen]

    # triples: correlated structure — if (h1, r, t1) in KG1, mirror in KG2
    # w.p. mirror_p
    triples: List[Tuple[int, int, int]] = []
    kg1_triples: List[Tuple[int, int, int]] = []
    while len(kg1_triples) < n_triples // 2:
        h, t = rng.integers(0, n1, size=2)
        if h == t:
            continue
        r = int(rng.integers(0, n_rels // 2))
        kg1_triples.append((int(h), r, int(t)))
    kg2_triples: List[Tuple[int, int, int]] = []
    for h, r, t in kg1_triples:
        if h < n_pairs and t < n_pairs and rng.random() < mirror_p:
            kg2_triples.append((n1 + h, n_rels // 2 + r, n1 + t))
    while len(kg2_triples) < n_triples - len(kg1_triples):
        h, t = rng.integers(0, n2, size=2)
        if h == t:
            continue
        r = int(rng.integers(n_rels // 2, n_rels))
        kg2_triples.append((n1 + int(h), r, n1 + int(t)))
    triples = kg1_triples + kg2_triples

    ills = [(i, n1 + i) for i in range(n_pairs)]
    left_ents = list(range(n1))
    right_ents = list(range(n1, n_ents))
    return (ills, triples, img_dict, ent_attrs, left_ents, right_ents,
            kg1_triples, kg2_triples, ent_names)
