"""MKGC trainer: margin-ranking steps and filtered full-entity evaluation.

Port of ``snag_tpu/mkgc/train.py``.  Training loop contract from
SNAG_MKGC/readme.md: NUM_BATCH batches per epoch over shuffled train
triples, NEG_NUM uniform corruptions per positive (head xor tail), Adam
with two LR groups (LR for the embeddings, LRG for the fusion/projection
stack), Gaussian noise-masking of the visual/textual tables at epoch or
step cadence, early stopping on valid MRR, a final filtered
MRR/Hits@{1,3,10} on test.

The train triples stay on the device; each epoch shuffles them there
and drops the tail beyond whole batches.  Every random draw comes from a
``torch.Generator`` seeded by ``derive_seed(seed, counter, tag)``: the
epoch for the shuffle and epoch-cadence noise, the step counter for the
corruptions, dropout and step-cadence noise.  So a resumed run needs only
the counters to repeat an uninterrupted one, and ``jax.random``'s
streams are matched in distribution, not in values.  Each step's loss
stays on the device; ``train_epoch`` reads their mean once.

``--mesh_shape data:N`` (``parallel/mesh.py``, JAX train.py:343-414):
every rank holds the model whole and its share of both feature tables
(``place_mkgc_features``, after the noise statistics are taken from the
whole tables; the noise draws are made at the whole tables' shapes), and
draws the same batches; the batch size is rounded down to a multiple of
N, each step's corruptions and dropout masks are drawn at the whole
batch's shapes and each rank takes its rows (and fetches their table rows
from their owners), and one all-reduce averages the gradients and the
loss, so N ranks step as one.  The filtered evaluation splits its
chunks over the ranks and gathers their ranks.  Rank 0 alone writes the
checkpoint and the ``--save_model`` snapshot.
"""

from __future__ import annotations

import os
import os.path as osp
import re
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from snag_tpu_torch.mkgc.config import MKGCConfig
from snag_tpu_torch.mkgc.data import MKGCData, load_mkgc_data
from snag_tpu_torch.mkgc.model import (MKGCFeatures, MKGCModel,
                                       avg_pool_features)
from snag_tpu_torch.ops import noise as noise_ops
from snag_tpu_torch.ops.noise import derive_seed, generator
from snag_tpu_torch.parallel import mesh as mesh_mod
from snag_tpu_torch.utils.checkpoint import (load_mkgc_checkpoint,
                                             save_mkgc_checkpoint)

# stream tags of derive_seed(seed, counter, tag)
EPOCH_NOISE, STEP_NOISE, SAMPLES, DROPOUT, SHUFFLE = 0, 1, 2, 3, 4

# the exact top-level module scopes of MKGCModel that form the
# fusion/projection stack, matched exactly (not as substrings), as the
# JAX package's optimizer labels do (train.py:50-70)
_FUSION_SCOPES = frozenset(
    ["vis_proj", "txt_proj", "vis_proj2", "txt_proj2", "gate",
     "modal_weight"])
_FUSION_SCOPE_RE = re.compile(r"fusion_\d+")


def place_mkgc_features(cfg: MKGCConfig, data: MKGCData, device, mesh=None):
    """(tables, noise statistics or None) of a run: each table pooled on
    the host and put on ``device`` alone, its column statistics
    (``--add_noise``; the visual one over the entities that have an image
    only) taken from the whole table, then, under a mesh of N > 1 ranks,
    only this rank's share kept (``parallel.mesh.shard_table``)."""
    host = (data.visual, data.textual)
    if cfg.use_pool:
        host = [avg_pool_features(a, cfg.pool_dim) for a in host]
    w_vis = torch.as_tensor(np.setdiff1d(
        np.arange(data.ent_num),
        np.asarray(data.ent_wo_visual, dtype=np.int64)), device=device)
    tables, stats = [], []
    for a, rows in zip(host, (w_vis, None)):
        t = torch.as_tensor(a, device=device)
        if cfg.add_noise:
            stats.append(noise_ops.table_stats(t, rows))
        tables.append(mesh_mod.shard_table(mesh, t))
        del t       # before the next table is put
    return MKGCFeatures(*tables), tuple(stats) if cfg.add_noise else None


def param_group(name: str) -> str:
    """"fusion" (LRG) for the fusion/projection stack, "main" (LR) for the
    rest, by the parameter's top-level scope."""
    top = name.split(".")[0]
    if top in _FUSION_SCOPES or _FUSION_SCOPE_RE.fullmatch(top):
        return "fusion"
    return "main"


def build_mkgc_optimizer(cfg: MKGCConfig,
                         model: MKGCModel) -> torch.optim.Adam:
    """Two Adam groups, ``main`` at ``lr`` and ``fusion`` at ``lrg`` (optax
    ``multi_transform`` of two ``adam``s: no decay, clipping or
    schedule)."""
    groups = {"main": [], "fusion": []}
    for name, p in model.named_parameters():
        groups[param_group(name)].append(p)
    return torch.optim.Adam([
        {"params": groups["main"], "lr": cfg.lr, "name": "main"},
        {"params": groups["fusion"], "lr": cfg.lrg, "name": "fusion"}],
        betas=(0.9, 0.999), eps=1e-8)


@torch.no_grad()
def noisy_features(cfg: MKGCConfig, gen: torch.Generator,
                   feats: MKGCFeatures, stats) -> MKGCFeatures:
    """Both tables noise-masked from ``gen``, visual first."""
    stats_vis, stats_txt = stats
    return MKGCFeatures(
        visual=noise_ops.noise_mask_table(gen, feats.visual, stats_vis,
                                          cfg.noise_ratio, cfg.mask_ratio),
        textual=noise_ops.noise_mask_table(gen, feats.textual, stats_txt,
                                           cfg.noise_ratio, cfg.mask_ratio))


def epoch_noise(cfg: MKGCConfig, feats: MKGCFeatures, stats,
                epoch: int) -> MKGCFeatures:
    """The epoch's noisy tables (noise_update=epoch), made once."""
    gen = generator(derive_seed(cfg.random_seed, epoch, EPOCH_NOISE),
                    feats.visual.device)
    return noisy_features(cfg, gen, feats, stats)


def epoch_batches(cfg: MKGCConfig, triples: torch.Tensor, epoch: int,
                  batch: int) -> torch.Tensor:
    """(n // batch, batch, 3): the resident triples shuffled on their
    device, the tail beyond whole batches dropped."""
    n = triples.shape[0]
    gen = generator(derive_seed(cfg.random_seed, epoch, SHUFFLE),
                    triples.device)
    perm = torch.randperm(n, generator=gen, device=triples.device)
    s = n // batch
    return triples[perm[:s * batch]].reshape(s, batch, 3)


class MKGCStep:
    """One margin-ranking step of ``model`` and its two-group Adam;
    ``count`` is the step counter (the JAX ``MKGCState.step``).  With
    ``stats`` and ``--noise_update step`` the step noise-masks the tables
    it is given.  Under ``mesh`` the step is this rank's share of it."""

    def __init__(self, cfg: MKGCConfig, model: MKGCModel, stats=None,
                 mesh=None):
        self.cfg = cfg
        self.model = model
        self.mesh = mesh
        self.opt = build_mkgc_optimizer(cfg, model)
        self.step_noise = (bool(cfg.add_noise) and cfg.noise_update == "step"
                           and stats is not None)
        self.stats = stats
        self.count = 0

    def sample(self, b: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """(rand_ent, corrupt_head) of this step: (b, neg_num) uniform
        entities and a fair coin for the corrupted side, no rejection of
        the gold entity (train.py:115-118)."""
        cfg = self.cfg
        gen = generator(derive_seed(cfg.random_seed, self.count, SAMPLES),
                        device)
        shape = (b, cfg.neg_num)
        corrupt_head = torch.rand(shape, generator=gen, device=device) < 0.5
        rand_ent = torch.randint(0, self.model.ent_num, shape, generator=gen,
                                 device=device)
        return rand_ent, corrupt_head

    def __call__(self, pos: torch.Tensor, feats: MKGCFeatures,
                 samples: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                 deterministic: bool = False
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The step on ``pos`` (B, 3); ``samples`` injects (rand_ent,
        corrupt_head) in place of this step's draw."""
        cfg = self.cfg
        dev = pos.device
        if self.step_noise:
            feats = noisy_features(cfg, generator(
                derive_seed(cfg.random_seed, self.count, STEP_NOISE), dev),
                feats, self.stats)
        rand_ent, corrupt_head = (samples if samples is not None
                                  else self.sample(pos.shape[0], dev))
        dropout_gen = None if deterministic else generator(
            derive_seed(cfg.random_seed, self.count, DROPOUT), dev)
        split = None
        if self.mesh is not None:
            split = (*self.mesh.rows(pos.shape[0]), pos.shape[0])
            rows = slice(split[0], split[1])
            pos, rand_ent, corrupt_head = (pos[rows], rand_ent[rows],
                                           corrupt_head[rows])
        self.opt.zero_grad(set_to_none=True)
        loss, aux = self.model(pos, rand_ent, corrupt_head, feats,
                               dropout_gen, split)
        loss.backward()
        if self.mesh is not None:
            # the rows' means averaged: the whole batch's (equal shares)
            params = [p for p in self.model.parameters()
                      if p.grad is not None]
            *grads, loss = self.mesh.all_reduce_mean(
                [p.grad for p in params] + [loss.detach()])
            for p, g in zip(params, grads):
                p.grad = g
            # a view of the reduced bucket: the epoch keeps every step's
            # loss, which would keep every step's bucket
            loss = loss.clone()
        self.opt.step()
        self.count += 1
        return loss.detach(), {k: v.detach() for k, v in aux.items()}


def _ranks(q, cand, gold, filt, filt_mask):
    """Filtered rank of each gold candidate: squared L2 by the
    norms-plus-matmul identity, clamped at 0, in fp32; the candidates
    strictly closer than the gold, minus the strictly closer known-true
    ones, plus 1."""
    d2 = torch.clamp(torch.sum(q * q, dim=1)[:, None]
                     + torch.sum(cand * cand, dim=1)[None, :]
                     - 2.0 * (q @ cand.T), min=0.0)                 # (C, E)
    rows = torch.arange(q.shape[0], device=q.device)
    gold_d = d2[rows, gold]
    smaller_all = (d2 < gold_d[:, None]).sum(dim=1)
    filt_d = torch.take_along_dim(d2, filt, dim=1)                  # (C, F)
    smaller_filt = ((filt_d < gold_d[:, None]) & filt_mask).sum(dim=1)
    return smaller_all - smaller_filt + 1


def _scan_dir(rel_emb, jh, jt, trip_c, filt_c, mask_c, head: bool):
    """(S, chunk) ranks of S chunks of triples."""
    out = [torch.zeros((0, trip_c.shape[1]), dtype=torch.int64,
                       device=jh.device)]
    for trip, filt, msk in zip(trip_c, filt_c, mask_c):
        r = rel_emb[trip[:, 1]]
        if head:
            rk = _ranks(jt[trip[:, 2]] - r, jh, trip[:, 0], filt, msk)
        else:
            rk = _ranks(jh[trip[:, 0]] + r, jt, trip[:, 2], filt, msk)
        out.append(rk[None])
    return torch.cat(out)


def make_score_fn(model: MKGCModel, mesh=None):
    """The filtered-rank evaluator of ``model``: every entity's joint in
    both roles, then both directions over the chunked triples and filters
    (``filtered_ranks`` builds them), on the model's device.  With
    ``mesh`` each rank ranks its share of the chunks (``Mesh.rows``) and
    one all-gather a direction gives every rank every rank (JAX
    ``make_score_fn``'s shard_map, train.py:175-258)."""

    def scan(rel, jh, jt, trip, filt, mask, head):
        if mesh is None:
            return _scan_dir(rel, jh, jt, trip, filt, mask, head).reshape(-1)
        lo, hi = mesh.rows(trip.shape[0])
        rk = _scan_dir(rel, jh, jt, trip[lo:hi], filt[lo:hi], mask[lo:hi],
                       head)
        return mesh.gather_shards(rk, trip.shape[0]).reshape(-1)

    @torch.no_grad()
    def eval_ranks(feats, t_trip, t_filt, t_mask, h_trip, h_filt, h_mask):
        jh = model.all_joint(feats, role=0)
        jt = model.all_joint(feats, role=1)
        rel = model.rel_emb
        return (scan(rel, jh, jt, t_trip, t_filt, t_mask, head=False),
                scan(rel, jh, jt, h_trip, h_filt, h_mask, head=True))

    return eval_ranks


def _padded_filters(data: MKGCData, triples: np.ndarray, direction: str):
    """(T, Fmax) known-true candidate ids + bool mask; padding repeats the
    gold id (strictly-smaller-than-itself is always False, so inert)."""
    lists = []
    for h, r, t in triples:
        if direction == "tail":
            lst = data.hr_to_t.get((int(h), int(r)), [])
        else:
            lst = data.rt_to_h.get((int(r), int(t)), [])
        # dedupe: the strict-count subtraction must count each filtered
        # candidate once (duplicate triples in the source would double-count)
        lists.append(sorted(set(lst)))
    fmax = max(1, max(len(lst) for lst in lists) if lists else 1)
    gold = triples[:, 2] if direction == "tail" else triples[:, 0]
    filt = np.tile(gold[:, None], (1, fmax)).astype(np.int32)
    mask = np.zeros((len(triples), fmax), dtype=bool)
    for i, lst in enumerate(lists):
        if lst:
            filt[i, :len(lst)] = lst
            mask[i, :len(lst)] = True
    return filt, mask


def _to_chunks(arr: np.ndarray, chunk: int) -> np.ndarray:
    """(T, ...) -> (S, chunk, ...), last row repeated into the padding."""
    n = len(arr)
    s = -(-n // chunk)
    pad = s * chunk - n
    if pad:
        arr = np.concatenate([arr, np.tile(arr[-1:], (pad,) + (1,) *
                                           (arr.ndim - 1))])
    return arr.reshape((s, chunk) + arr.shape[1:])


def filtered_ranks(model: MKGCModel, feats: MKGCFeatures, data: MKGCData,
                   triples: np.ndarray, chunk: int = 256, score_fn=None,
                   filter_cache: Optional[dict] = None) -> np.ndarray:
    """Filtered link-prediction ranks for both directions, ordered
    [tail..., head...].  ``filter_cache``: a per-split dict that keeps the
    device-resident chunked triple/filter arrays between evaluations of
    the same split."""
    eval_ranks = score_fn if score_fn is not None else make_score_fn(model)
    n = len(triples)
    if filter_cache is not None and "packs" in filter_cache:
        packs = filter_cache["packs"]
    else:
        dev = model.ent_emb.device
        packs = []
        for direction in ("tail", "head"):
            filt, mask = _padded_filters(data, triples, direction)
            packs += [torch.as_tensor(_to_chunks(triples.astype(np.int64),
                                                 chunk), device=dev),
                      torch.as_tensor(_to_chunks(filt.astype(np.int64),
                                                 chunk), device=dev),
                      torch.as_tensor(_to_chunks(mask, chunk), device=dev)]
        packs = tuple(packs)
        if filter_cache is not None:
            filter_cache["packs"] = packs
    rt, rh = eval_ranks(feats, *packs)
    return torch.cat([rt[:n], rh[:n]]).cpu().numpy()


def summarize_lp(ranks: np.ndarray) -> Dict[str, float]:
    return {
        "mrr": float((1.0 / ranks).mean()),
        "hits1": float((ranks <= 1).mean()),
        "hits3": float((ranks <= 3).mean()),
        "hits10": float((ranks <= 10).mean()),
        "mr": float(ranks.mean()),
    }


def _clone(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in state.items()}


class MKGCRunner:
    """Port of the JAX ``MKGCRunner`` (train.py:335-556): eval every
    ``eval_epoch`` with a copy of the best params and an early stop after
    ``early_stop_patience`` non-improving evals, a final test from the best
    params, ``save_model`` / ``load_model``
    (``<data_path>/<data_choice>/save/<exp_id>.pt``, the state dict; the
    JAX package writes flax ``.msgpack``, which the port does not read),
    ``--checkpoint_every`` / ``--resume_from`` (``utils/checkpoint.py``)."""

    def __init__(self, cfg: MKGCConfig, logger,
                 data: Optional[MKGCData] = None):
        self.cfg = cfg
        self.logger = logger
        self.device = torch.device(cfg.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"--device {cfg.device}: torch.cuda is not "
                               "available (pass --device cpu to run on the "
                               "CPU)")
        self.mesh = None
        n_ranks = mesh_mod.parse_mesh_shape(cfg.mesh_shape)
        if n_ranks:
            self.mesh = mesh_mod.make_mesh(n_ranks, cfg.device, logger)
            self.device = self.mesh.device
        self.main_process = self.mesh is None or self.mesh.rank == 0
        self.data = data if data is not None else load_mkgc_data(cfg, logger)
        self.feats, self.stats = place_mkgc_features(cfg, self.data,
                                                     self.device, self.mesh)
        self.model = MKGCModel(
            cfg, self.data.ent_num, self.data.rel_num,
            int(self.feats.visual.shape[1]), int(self.feats.textual.shape[1]),
            torch.Generator().manual_seed(cfg.random_seed)).to(self.device)
        mesh_mod.attach(self.model, self.mesh)
        n_params = sum(p.numel() for p in self.model.parameters())
        logger.info(f"MKGC params: {n_params}  device: {self.device}")
        self.step = MKGCStep(cfg, self.model, self.stats, self.mesh)
        self.batch_size = max(1, len(self.data.train) // cfg.num_batch)
        if self.mesh is not None:
            # each rank takes an equal share of every batch
            w = self.mesh.world
            self.batch_size = max(w, self.batch_size // w * w)
            logger.info(f"mesh batch_size: {self.batch_size}")
        self._score_fn = make_score_fn(self.model, self.mesh)
        self.train_triples = torch.as_tensor(
            self.data.train.astype(np.int64), device=self.device)
        self._filter_caches: Dict[str, dict] = {}
        self._valid_cap_logged = False
        self.best_mrr = 0.0
        self.best_params: Optional[Dict[str, torch.Tensor]] = None
        self.bad_evals = 0
        self.epoch = 0
        self.start_epoch = 0
        self.losses: List[float] = []       # each trained epoch's mean loss
        self.last_metrics: Optional[Dict[str, float]] = None
        if cfg.resume_from:
            load_mkgc_checkpoint(self, cfg.resume_from)
            self.start_epoch = self.epoch + 1
            logger.info(f"resumed from {cfg.resume_from} (epoch {self.epoch},"
                        f" best valid MRR {self.best_mrr:.4f})")

    def train_epoch(self, epoch: int) -> float:
        """One epoch; the mean of its steps' losses (one device read)."""
        feats = self.feats
        if self.stats is not None and self.cfg.noise_update != "step":
            feats = epoch_noise(self.cfg, self.feats, self.stats, epoch)
        batches = epoch_batches(self.cfg, self.train_triples, epoch,
                                self.batch_size)
        if batches.shape[0] == 0:
            return 0.0
        losses = [self.step(pos, feats)[0] for pos in batches]
        return float(torch.stack(losses).mean())

    def evaluate(self, split: str = "valid") -> Dict[str, float]:
        triples = getattr(self.data, split)
        if split == "valid" and len(triples) > self.cfg.valid_max:
            if not self._valid_cap_logged:
                self.logger.info(
                    f"valid split capped for early-stopping: using first "
                    f"{self.cfg.valid_max} of {len(triples)} triples "
                    f"({len(triples) - self.cfg.valid_max} dropped; raise "
                    f"--valid_max to use all)")
                self._valid_cap_logged = True
            triples = triples[:self.cfg.valid_max]
        cache = self._filter_caches.setdefault(split, {})
        ranks = filtered_ranks(self.model, self.feats, self.data, triples,
                               score_fn=self._score_fn, filter_cache=cache)
        return summarize_lp(ranks)

    def checkpoint_path(self) -> str:
        d = self.cfg.checkpoint_dir or osp.join(
            self.cfg.data_path, self.cfg.data_choice, "ckpt")
        return osp.join(d, f"{self.cfg.exp_id}.pt")

    def save_path(self) -> str:
        return osp.join(self.cfg.data_path, self.cfg.data_choice, "save",
                        f"{self.cfg.exp_id}.pt")

    def save_model(self) -> str:
        """The best params (the current ones before any eval) as a state
        dict (the MMEA layout, main.py:481-500)."""
        path = self.save_path()
        os.makedirs(osp.dirname(path), exist_ok=True)
        params = (self.best_params if self.best_params is not None
                  else self.model.state_dict())
        torch.save({k: v.detach().cpu() for k, v in params.items()}, path)
        self.logger.info(f"saving [{path}] done!")
        return path

    def load_model(self, path: str) -> None:
        """Load a snapshot written by ``save_model`` (every parameter
        present, no other)."""
        sd = torch.load(path, map_location="cpu", weights_only=True)
        self.model.load_state_dict(sd, strict=True)
        self.best_params = _clone(self.model.state_dict())
        self.logger.info(f"loaded params from [{path}]")

    def run(self) -> Dict[str, float]:
        cfg = self.cfg
        t0 = time.time()
        if cfg.only_test and not cfg.resume_from:
            # never evaluate a random init silently: load this exp_id's
            # save_model snapshot, or fail
            path = self.save_path()
            if not osp.exists(path):
                raise RuntimeError(
                    f"--only_test 1 needs trained params: pass --resume_from "
                    f"or train with --save_model first (looked for {path})")
            self.load_model(path)
        if not cfg.only_test:
            for epoch in range(self.start_epoch, cfg.epoch):
                self.epoch = epoch
                loss = self.train_epoch(epoch)
                self.losses.append(loss)
                if (epoch + 1) % cfg.log_every == 0 or epoch == 0:
                    self.logger.info(f"MKGC Ep {epoch}: loss {loss:.4f} "
                                     f"({time.time() - t0:.1f}s)")
                stop = False
                if (epoch + 1) % cfg.eval_epoch == 0:
                    m = self.evaluate("valid")
                    self.logger.info(f"MKGC Ep {epoch} valid: {m}")
                    if m["mrr"] > self.best_mrr:
                        self.best_mrr = m["mrr"]
                        self.best_params = _clone(self.model.state_dict())
                        self.bad_evals = 0
                    else:
                        self.bad_evals += 1
                        if self.bad_evals >= cfg.early_stop_patience:
                            self.logger.info(f"early stop at epoch {epoch}")
                            stop = True
                if cfg.checkpoint_every and \
                        (epoch + 1) % cfg.checkpoint_every == 0:
                    if self.main_process:
                        path = save_mkgc_checkpoint(self,
                                                    self.checkpoint_path())
                        self.logger.info(f"checkpoint saved to {path}")
                    if self.mesh is not None:
                        self.mesh.barrier()
                if stop:
                    break
        if self.best_params is not None:
            self.model.load_state_dict(self.best_params)
        m = self.evaluate("test")
        self.logger.info(f"MKGC test: {m}")
        self.last_metrics = m
        if cfg.save_model and not cfg.only_test and self.main_process:
            self.save_model()
        return m
