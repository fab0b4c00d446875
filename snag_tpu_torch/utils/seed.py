"""Seeding (reference: SNAG_MMEA/torchlight/utils.py:31-40).

Only python/numpy are seeded globally (the data pipeline's shuffles and
splits); model randomness flows through explicit ``torch.Generator``s
derived from the same seed.
"""

import random

import numpy as np


def set_seed(seed: int) -> None:
    random.seed(seed)
    np.random.seed(seed)
