"""The per-epoch noise function, one training step, MEAformer's replay
and MSNEA's triple step.

Port of ``snag_tpu/train/step.py`` (``make_noise_fn`` :53,
``make_train_step`` :70, ``replay_negative_mask`` :107,
``make_meaformer_replay_step`` :121 and ``make_msnea_train_step`` :199): epoch-seeded feature noise, then per
step entity noise -> encode -> loss -> backward -> clip -> optimizer
update.  Batches arrive capacity-padded with a validity mask (see the
runner).

Randomness: feature and entity noise come from generators seeded from
(seed, epoch), so every step of an epoch sees the same noise draws (the
reference's update_noise cadence); dropout and MSNEA's negative triples
from (seed, step).  A step with ``deterministic=True`` runs without
dropout, as the JAX package's ``deterministic`` flag does; noise follows
``--add_noise`` alone (MSNEA draws none, as in JAX step.py:77).

Gradient accumulation (``--accumulation_steps k``, JAX's
``optax.MultiSteps(..., every_k_schedule=k)``, optax 0.2.6): each step is
a micro-step whose gradient joins the running mean of its cycle
(acc + (g - acc) / (i + 1) at the cycle's i-th micro-step); the k-th
clips that mean and steps AdamW once (weight decay included) at the LR
of the update count, and the others leave the parameters as they are.
``count`` counts micro-steps, as JAX's ``TrainState.step`` does, and so
do the RNG streams and MSNEA's positive slices.  The cycle's position is
``count % k``; the mean (``accum``) is train state, saved by the
checkpoint.

Under a mesh (``mesh``) each micro-step's gradients are first averaged
over the ranks, in one all-reduce (``Mesh.all_reduce_mean``); the
encoders' row gather (``parallel.mesh.gather_rows``) makes that mean the
one-rank gradient.  MSNEA's step runs whole on every rank, so its mean is
of equal gradients.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch

from snag_tpu_torch.config import Config
from snag_tpu_torch.data.graph import DeviceGraph
from snag_tpu_torch.models.encoder import (FeaturePack, FeatureStats,
                                           apply_feature_noise)
from snag_tpu_torch.models.msnea import TripleBank, sample_triple_batch
from snag_tpu_torch.ops.noise import derive_seed, generator
from snag_tpu_torch.train.optim import (build_optimizer, clip_and_step,
                                        make_lr_schedule)

# stream tags of derive_seed(seed, counter, tag)
FEATURE_NOISE, ENTITY_NOISE, DROPOUT, TRIPLES = 0, 1, 2, 3


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
    """One (micro-)step of ``model``'s training loss; ``count`` is the step
    counter (the JAX ``TrainState.step``), ``total_steps`` /
    ``warmup_steps`` the schedule's horizon in micro-steps, ``every`` the
    micro-steps an optimizer update and ``accum`` the running mean of the
    current cycle's gradients (None at a cycle's start)."""

    def __init__(self, cfg: Config, model: torch.nn.Module, lr: float,
                 total_steps: int, warmup_steps: int, mesh=None):
        self.cfg = cfg
        self.model = model
        self.mesh = mesh
        self.params = list(model.parameters())
        self.opt = build_optimizer(cfg, model, lr)
        self.total_steps = total_steps
        self.warmup_steps = warmup_steps
        self.sched = make_lr_schedule(cfg, lr, total_steps, warmup_steps)
        self.every = max(cfg.accumulation_steps, 1)
        self.accum: Optional[List[torch.Tensor]] = None
        self.count = 0

    @property
    def updates(self) -> int:
        """Optimizer updates so far (optax's ``gradient_step``)."""
        return self.count // self.every

    def lr(self) -> float:
        """LR of the base group at the next optimizer update."""
        return self.sched(self.updates)

    def _update(self) -> None:
        """Fold this micro-step's gradients (their mean over the mesh's
        ranks) into the cycle's running mean (the first one is the mean)
        and, at the cycle's end, clip the mean and step AdamW on it."""
        i = self.count % self.every
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in self.params]
        if self.mesh is not None:
            grads = self.mesh.all_reduce_mean(grads)
        if self.accum is None:
            self.accum = grads
        else:
            for a, g in zip(self.accum, grads):
                a.add_((g - a) / (i + 1))
        if i == self.every - 1:
            for p, a in zip(self.params, self.accum):
                p.grad = a
            clip_and_step(self.opt, self.params, self.sched(self.updates),
                          self.cfg.clip)
            self.accum = None

    def __call__(self, links: torch.Tensor, valid: torch.Tensor,
                 feats: FeaturePack, graph: DeviceGraph, epoch: int,
                 deterministic: bool = False, **model_kwargs
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        cfg = self.cfg
        dev = links.device
        entity_gen: Optional[torch.Generator] = None
        if cfg.add_noise and cfg.model_name != "MSNEA":
            entity_gen = generator(
                derive_seed(cfg.random_seed, epoch, ENTITY_NOISE), dev)
        dropout_gen = None if deterministic else generator(
            derive_seed(cfg.random_seed, self.count, DROPOUT), dev)

        self.opt.zero_grad(set_to_none=True)
        loss, aux = self.model(links, valid, feats, graph, entity_gen,
                               dropout_gen, **model_kwargs)
        loss.backward()
        self._update()
        self.count += 1
        return loss.detach(), {k: v.detach() for k, v in aux.items()}


def msnea_step(step: TrainStep, bank: TripleBank, links: torch.Tensor,
               valid: torch.Tensor, feats: FeaturePack, graph: DeviceGraph,
               epoch: int) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One MSNEA step (JAX ``make_msnea_train_step``, step.py:199-222): a
    triple batch of the links' size, positives at the step count,
    negatives drawn from the step's ``TRIPLES`` generator, then the loss
    and the update of ``step``."""
    cfg = step.cfg
    gen = generator(derive_seed(cfg.random_seed, step.count, TRIPLES),
                    links.device)
    pos, neg = sample_triple_batch(gen, bank, links.shape[0], step.count,
                                   cfg.neg_triple_num)
    return step(links, valid, feats, graph, epoch, pos_triples=pos,
                neg_triples=neg)


def replay_negative_mask(neg: torch.Tensor, batch_ents: torch.Tensor,
                         valid: torch.Tensor) -> torch.Tensor:
    """Fixed-shape form of the reference's replay filter
    ``list(set(neg) - set(batch_ents))`` (MEAformer.py:118-124): a slot
    survives iff its entity was mined (>= 0), its row is valid, the entity
    is not in the batch (pads included, as in JAX step.py:107-119) and no
    earlier valid slot holds it (set semantics)."""
    pos = torch.arange(neg.shape[0], device=neg.device)
    in_batch = (neg[:, None] == batch_ents[None, :]).any(dim=1)
    earlier_equal = ((neg[:, None] == neg[None, :]) & valid[None, :]
                     & (pos[None, :] < pos[:, None]))
    return (neg >= 0) & valid & ~in_batch & ~earlier_equal.any(dim=1)


def col_to_ent(col: torch.Tensor, first: torch.Tensor,
               second: torch.Tensor) -> torch.Tensor:
    """The entity a mined logit column denotes: a column of the ab block
    is the paired entity (``first``), one past it the same side's
    (``second``); a replay column maps to the last row's, as in JAX
    (step.py:176-179)."""
    b = first.shape[0]
    in_ab = col < b
    idx = torch.where(in_ab, col, torch.clamp(col - b, max=b - 1))
    return torch.where(in_ab, first[idx], second[idx])


def update_replay_buffer(buffer: torch.Tensor, ids: torch.Tensor,
                         values: torch.Tensor, valid: torch.Tensor) -> None:
    """buffer[ids[i]] = values[i] for the valid rows, in place; where a
    valid id repeats, the last valid row wins.  Padded rows write nothing
    (the JAX step writes their entity's old value back, so it loses a
    valid update of the pads' entity 0, ROADMAP C "Reference gaps").  The
    scatter has no duplicate target holding different values, so it is
    deterministic, and it reads nothing back to the host."""
    pos = torch.arange(ids.shape[0], device=ids.device)
    later_equal = ((ids[:, None] == ids[None, :]) & valid[None, :]
                   & (pos[None, :] > pos[:, None]))
    keep = valid & ~later_equal.any(dim=1)
    n = buffer.shape[0]
    # every row that does not write goes to a sink slot past the end, all
    # with the same value
    ext = torch.cat([buffer, buffer.new_full((1,), -1)])
    ext[torch.where(keep, ids, n)] = torch.where(
        keep, values.to(buffer.dtype), -1)
    buffer.copy_(ext[:n])


def replay_step(step: TrainStep, buffer: torch.Tensor, ready: bool,
                links: torch.Tensor, valid: torch.Tensor, feats: FeaturePack,
                graph: DeviceGraph, epoch: int, deterministic: bool = False
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor],
                           torch.Tensor]:
    """One MEAformer step with replay negatives (MEAformer.py:102-148, JAX
    ``make_meaformer_replay_step``).  ``buffer`` (N,) holds the last mined
    hardest negative entity of each entity, or -1; its entries for the
    batch are the replay negatives, kept by ``replay_negative_mask`` once
    ``ready``.  The step's mined columns are mapped to entities and
    written back into ``buffer`` in place.  Returns (loss, aux, the
    number of valid replay negatives fed, a device scalar)."""
    neg_l, neg_r = buffer[links[:, 0]], buffer[links[:, 1]]
    batch_ents = torch.cat([links[:, 0], links[:, 1]])
    neg_l_valid = replay_negative_mask(neg_l, batch_ents, valid) & ready
    neg_r_valid = replay_negative_mask(neg_r, batch_ents, valid) & ready
    loss, aux = step(links, valid, feats, graph, epoch, deterministic,
                     replay_neg_l=torch.clamp(neg_l, min=0),
                     replay_neg_r=torch.clamp(neg_r, min=0),
                     replay_neg_valid=neg_l_valid,
                     replay_neg_valid_r=neg_r_valid)
    l_ent = col_to_ent(aux.pop("l_neg"), links[:, 1], links[:, 0])
    r_ent = col_to_ent(aux.pop("r_neg"), links[:, 0], links[:, 1])
    update_replay_buffer(buffer, links[:, 0], l_ent, valid)
    update_replay_buffer(buffer, links[:, 1], r_ent, valid)
    return loss, aux, neg_l_valid.sum() + neg_r_valid.sum()
