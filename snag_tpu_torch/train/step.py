"""The per-epoch noise function and one training step.

Port of ``snag_tpu/train/step.py`` (``make_noise_fn`` :53,
``make_train_step`` :70): epoch-seeded feature noise, then per step entity
noise -> encode -> loss -> backward -> clip -> optimizer update.  Batches
arrive capacity-padded with a validity mask (see the runner).

Randomness: feature and entity noise come from generators seeded from
(seed, epoch), so every step of an epoch sees the same noise draws (the
reference's update_noise cadence); dropout from (seed, step).  A step with
``deterministic=True`` runs without dropout, as the JAX package's
``deterministic`` flag does; noise follows ``--add_noise`` alone.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from snag_tpu_torch.config import Config
from snag_tpu_torch.data.graph import DeviceGraph
from snag_tpu_torch.models.encoder import (FeaturePack, FeatureStats,
                                           apply_feature_noise)
from snag_tpu_torch.ops.noise import derive_seed, generator
from snag_tpu_torch.train.optim import (build_optimizer, clip_and_step,
                                        make_lr_schedule)

# stream tags of derive_seed(seed, counter, tag)
FEATURE_NOISE, ENTITY_NOISE, DROPOUT = 0, 1, 2


def make_noise_fn(cfg: Config, stats: FeatureStats
                  ) -> Callable[[FeaturePack, int], FeaturePack]:
    """Per-epoch noisy feature tables (update_noise, main.py:253-254),
    computed once per epoch outside the step."""
    def noise_fn(feats: FeaturePack, epoch: int) -> FeaturePack:
        gen = generator(derive_seed(cfg.random_seed, epoch, FEATURE_NOISE),
                        feats.img.device)
        return apply_feature_noise(gen, feats, stats, cfg.noise_ratio,
                                   cfg.mask_ratio)
    return noise_fn


class TrainStep:
    """One optimizer step of ``model``'s training loss; ``count`` is the
    optimizer step counter (the JAX ``TrainState.step``), and
    ``total_steps`` / ``warmup_steps`` the schedule's horizon."""

    def __init__(self, cfg: Config, model: torch.nn.Module, lr: float,
                 total_steps: int, warmup_steps: int):
        self.cfg = cfg
        self.model = model
        self.params = list(model.parameters())
        self.opt = build_optimizer(cfg, model, lr)
        self.total_steps = total_steps
        self.warmup_steps = warmup_steps
        self.sched = make_lr_schedule(cfg, lr, total_steps, warmup_steps)
        self.count = 0

    def lr(self) -> float:
        """LR of the base group at the next step."""
        return self.sched(self.count)

    def __call__(self, links: torch.Tensor, valid: torch.Tensor,
                 feats: FeaturePack, graph: DeviceGraph, epoch: int,
                 deterministic: bool = False
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        cfg = self.cfg
        dev = links.device
        entity_gen: Optional[torch.Generator] = None
        if cfg.add_noise:
            entity_gen = generator(
                derive_seed(cfg.random_seed, epoch, ENTITY_NOISE), dev)
        dropout_gen = None if deterministic else generator(
            derive_seed(cfg.random_seed, self.count, DROPOUT), dev)

        self.opt.zero_grad(set_to_none=True)
        loss, aux = self.model(links, valid, feats, graph, entity_gen,
                               dropout_gen)
        loss.backward()
        clip_and_step(self.opt, self.params, self.sched(self.count),
                      cfg.clip)
        self.count += 1
        return loss.detach(), {k: v.detach() for k, v in aux.items()}
