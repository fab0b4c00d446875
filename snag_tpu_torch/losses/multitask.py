"""Learnable multi-task loss weighting layers.

Port of ``snag_tpu/losses/multitask.py``:

* ``KendallLossLayer`` — homoscedastic-uncertainty weighting
  sum_i exp(-s_i) L_i + s_i (reference SNAG_MMEA/model/SNAG_loss.py:12-29).
  The reference always passes a length-6 list with literal 0 for missing
  modalities, so every log-variance contributes its +s_i term;
* ``AutomaticWeightedLoss`` — sum_i 0.5/p_i^2 L_i + log(1+p_i^2)
  (model/Tool_model.py:14-39).
"""

from __future__ import annotations

from typing import List, Union

import torch
from torch import nn

Scalar = Union[torch.Tensor, float]


class KendallLossLayer(nn.Module):
    def __init__(self, loss_num: int):
        super().__init__()
        self.log_vars = nn.Parameter(torch.zeros(loss_num))

    def forward(self, loss_list: List[Scalar]) -> torch.Tensor:
        if len(loss_list) > self.log_vars.shape[0]:
            raise ValueError(f"{len(loss_list)} losses for "
                             f"{self.log_vars.shape[0]} log-variances")
        precision = torch.exp(-self.log_vars)
        total = self.log_vars.new_zeros(())
        for i, loss in enumerate(loss_list):
            total = total + precision[i] * loss + self.log_vars[i]
        return total


class AutomaticWeightedLoss(nn.Module):
    def __init__(self, num: int = 2):
        super().__init__()
        self.params = nn.Parameter(torch.ones(num))

    def forward(self, loss_list: List[Scalar]) -> torch.Tensor:
        total = self.params.new_zeros(())
        for i, loss in enumerate(loss_list):
            p2 = self.params[i] ** 2
            total = total + 0.5 / p2 * loss + torch.log(1 + p2)
        return total
