"""Optimizer and LR schedules.

Port of ``snag_tpu/train/optim.py`` (reference ``set_optim``,
SNAG_MMEA/src/utils.py:25-80):

* SNAG's three parameter groups by name: ``multi_loss_layer`` (which also
  catches ``multi_loss_layer_2``) at 5x LR without decay; ``weight_raw`` and
  biases without decay; everything else with ``--weight_decay``;
* the other families' one group, ``--weight_decay`` on every parameter,
  biases and Kendall log-variances included (optim.py:83-90);
* ``torch.optim.AdamW`` with ``eps = --adam_epsilon`` (``--optim adam``:
  Adam, no decay), which decays from the parameters before the update,
  like optax's ``adamw``;
* linear / cosine schedules with warmup (HF get_*_schedule_with_warmup,
  main.py:77-92) or a fixed LR, evaluated at the step count before the
  update (optax's convention, so step 0 has LR 0 under warmup);
* global grad-norm clipping (main.py:272) before the update
  (``clip_and_step``);
* ``--accumulation_steps k`` (optax ``MultiSteps``, optim.py:93-94): the
  schedule over optimizer updates; the accumulation itself is
  ``train/step.py::TrainStep``'s.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List

import torch
from torch import nn

from snag_tpu_torch.config import Config

GROUP_LR_SCALE = {"decay": 1.0, "no_decay": 1.0, "large": 5.0}


def make_lr_schedule(cfg: Config, lr: float, total_steps: int,
                     warmup_steps: int) -> Callable[[int], float]:
    """gradient step -> LR (optim.py:26-50).  With ``--accumulation_steps
    k`` the horizon counts optimizer updates: ``total_steps / k`` and
    ``warmup_steps / k`` micro-steps' worth (:28-30)."""
    acc = max(cfg.accumulation_steps, 1)
    total = max(int(total_steps / acc), 1)
    warmup = int(warmup_steps / acc)

    if cfg.scheduler == "fixed":
        return lambda step: lr

    def sched(step: int) -> float:
        if step < warmup:
            return lr * step / max(warmup, 1)
        if cfg.scheduler == "linear":
            return lr * max(0.0, (total - step) / max(total - warmup, 1))
        progress = (step - warmup) / max(total - warmup, 1)
        return lr * max(0.0, 0.5 * (1.0 + math.cos(math.pi * progress)))
    return sched


def param_label(name: str) -> str:
    """Reference param-group label of one parameter (src/utils.py:46-54)."""
    if "multi_loss_layer" in name:
        return "large"
    if "weight_raw" in name or name.endswith("bias"):
        return "no_decay"
    return "decay"


def build_optimizer(cfg: Config, model: nn.Module, lr: float
                    ) -> torch.optim.Optimizer:
    """SNAG's param groups, or the other families' single ``decay`` group;
    each group carries its ``lr_scale``."""
    groups: Dict[str, List[nn.Parameter]] = {k: [] for k in GROUP_LR_SCALE}
    for name, p in model.named_parameters():
        label = param_label(name) if cfg.model_name == "SNAG" else "decay"
        groups[label].append(p)
    adamw = cfg.optim == "adamw"
    param_groups = [
        {"params": ps, "lr": lr * GROUP_LR_SCALE[label],
         "lr_scale": GROUP_LR_SCALE[label],
         "weight_decay": cfg.weight_decay if (adamw and label == "decay")
         else 0.0}
        for label, ps in groups.items() if ps]
    cls = torch.optim.AdamW if adamw else torch.optim.Adam
    return cls(param_groups, lr=lr, eps=cfg.adam_epsilon)


def clip_and_step(opt: torch.optim.Optimizer, params: List[nn.Parameter],
                  lr: float, clip: float) -> None:
    """Global grad-norm clip, then one update at ``lr`` (times each group's
    scale).  A parameter without a gradient gets a zero one, so it is
    still decayed, as optax does."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    torch.nn.utils.clip_grad_norm_(params, clip)
    for g in opt.param_groups:
        g["lr"] = lr * g["lr_scale"]
    opt.step()

