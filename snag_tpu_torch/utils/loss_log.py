"""Training-loss history (reference: SNAG_MMEA/src/utils.py:110-200).

Port of the parts of ``snag_tpu/utils/loss_log.py`` that the runner reads:
one mean loss per epoch after a sentinel, and its minimum.
"""

from __future__ import annotations

from typing import List


class LossLog:
    def __init__(self):
        self.loss: List[float] = [999999.0]

    def update(self, value: float):
        self.loss.append(value)

    def get_min_loss(self) -> float:
        return min(self.loss)
