"""Multi-task loss weighting layers: their parameters.

Port of the parameters of ``snag_tpu/losses/multitask.py`` so the SNAG
state dict carries the JAX package's keys:

* ``KendallLossLayer.log_vars`` — homoscedastic-uncertainty weighting
  sum_i exp(-s_i) L_i + s_i (reference SNAG_MMEA/model/SNAG_loss.py:12-29);
* ``AutomaticWeightedLoss.params`` — sum_i 0.5/p_i^2 L_i + log(1+p_i^2)
  (model/Tool_model.py:14-39).

The loss ``forward`` comes with the training loss bundle.
"""

from __future__ import annotations

import torch
from torch import nn


class KendallLossLayer(nn.Module):
    def __init__(self, loss_num: int):
        super().__init__()
        self.log_vars = nn.Parameter(torch.zeros(loss_num))


class AutomaticWeightedLoss(nn.Module):
    def __init__(self, num: int = 2):
        super().__init__()
        self.params = nn.Parameter(torch.ones(num))
