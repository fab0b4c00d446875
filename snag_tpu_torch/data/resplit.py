"""Offline image-ratio resplit tool, port of ``snag_tpu/data/resplit.py``
(reference: SNAG_MMEA/src/data.py:79-133
``re_splite_data``): subsample an image-feature pickle so only ``ratio`` of
the ILL entities keep images, writing the ``*_<ratio>.pkl`` inputs the
``--ratio`` ablations consume.
"""

from __future__ import annotations

import pickle
import random
from typing import Dict, Sequence, Tuple

import numpy as np


def resplit_image_dict(img_dict: Dict[int, np.ndarray],
                       ills: Sequence[Tuple[int, int]],
                       ratio: float, seed: int = 0) -> Dict[int, np.ndarray]:
    """Return a copy of img_dict with images removed until only
    ``ratio * len(all ILL entities)`` ILL entities keep one."""
    rng = random.Random(seed)
    all_ent = [i[0] for i in ills] + [i[1] for i in ills]
    ent_w_img_ill = list({e for e in all_ent if e in img_dict})
    remain = int(ratio * len(all_ent))
    out = dict(img_dict)
    if remain < len(ent_w_img_ill):
        num_remove = len(ent_w_img_ill) - remain
        for e in rng.sample(ent_w_img_ill, num_remove):
            del out[e]
    return out


def resplit_pickle(src_path: str, dst_path: str,
                   ills: Sequence[Tuple[int, int]], ratio: float,
                   seed: int = 0) -> str:
    with open(src_path, "rb") as f:
        img_dict = pickle.load(f)
    out = resplit_image_dict(img_dict, ills, ratio, seed)
    with open(dst_path, "wb") as f:
        pickle.dump(out, f)
    return dst_path
