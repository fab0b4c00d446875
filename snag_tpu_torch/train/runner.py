"""Training and evaluation orchestrator.

Port of ``snag_tpu/train/runner.py::Runner`` (reference
SNAG_MMEA/main.py:31-529): the two-stage schedule with the il_start
transition (LR/5, 3x horizon, reload of the best weights, a mid-run test,
main.py:158-175), pseudo-label mining every ``semi_learn_step`` epochs and
promotion every ``semi_learn_step * 10`` (:178-183), eval every
``eval_epoch`` with best-by-MRR-l2r tracking and a 200-eval early-stop
counter (:148-149, 197-199, 447-455), and a final test from the best
weights with the top-3 CSV (:203-206, 395-420).

Data, features and model live on ``cfg.device``; the growing ``train_ill``
stays a host numpy array and batches are fed capacity-padded with a
validity mask.  ``train_epoch`` reads the device only after its last
step.

The family's step: ``TrainStep`` for SNAG, EVA, MCLEA and MEAformer;
MSNEA runs ``msnea_step`` over its ``TripleBank`` (each KG's triples, the
cross-KG copies of the train links' included) with no noise;
MEAformer with ``--replay 1`` runs ``replay_step`` over the replay buffer
``replay_neg`` (the last mined hardest negative of each entity, -1 = none
yet), whose negatives are used once the count of unset entries stops
changing between epochs (``replay_ready``, MEAformer.py:55-61, 138-148);
``replay_negatives`` counts the valid ones fed.

``--mesh_shape data:N`` runs this process as one of N ranks
(``parallel/mesh.py``; the CLI spawns them, or they come from torchrun or
SLURM): every rank holds the graph and the model whole, and of every
feature table its share of the entities (``place_features``, after the
noise statistics are taken from the whole table), and draws the same
batches, the encoders split their per-entity work over the ranks, the
parameter gradients are averaged before each update, the ``--distance 2``
evaluation splits its query rows over N > 1 ranks (``eval/sharded.py``;
one rank evaluates as the plain path does) and the IL mining its left
candidates; every rank ends each evaluation and mining round
with the same values, so every rank takes the same decisions.  The batch
capacity is rounded up to a multiple of N (loss-exact: batches are
capacity-padded).  Only rank 0 writes files (the top-3 CSV, the
checkpoint, ``--save_model``, the metrics and the profiler trace); a
checkpoint is followed by a barrier, and every rank reads one on resume.

``--checkpoint_every N`` saves the full train state to
``<dump>/checkpoint.pt`` every N epochs and ``--resume_from`` continues
from one (``utils/checkpoint.py``); ``--save_model 1`` writes the final
weights as a reference ``.pkl`` (``torch.save(state_dict)``,
SNAG_MMEA/main.py:481-500), which ``load_model`` and the JAX package's
``load_model`` both read.
"""

from __future__ import annotations

import csv
import dataclasses
import os
import os.path as osp
import statistics
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from snag_tpu_torch.config import Config
from snag_tpu_torch.data.dataset import KGData, load_data
from snag_tpu_torch.eval.ranking import (RankResult, full_rank_eval,
                                         result_from_ranks)
from snag_tpu_torch.eval.sharded import sharded_full_rank_eval
from snag_tpu_torch.models import build_model
from snag_tpu_torch.models.encoder import place_features
from snag_tpu_torch.models.msnea import TripleBank
from snag_tpu_torch.ops.fusion import l2norm
from snag_tpu_torch.parallel import mesh as mesh_mod
from snag_tpu_torch.train import il as il_mod
from snag_tpu_torch.train.step import (TrainStep, make_noise_fn, msnea_step,
                                       replay_step)
from snag_tpu_torch.utils.checkpoint import (CHECKPOINT_NAME,
                                             load_checkpoint, save_checkpoint)
from snag_tpu_torch.utils.import_reference import (load_reference_checkpoint,
                                                   save_reference_checkpoint)
from snag_tpu_torch.utils.logging import get_dump_path
from snag_tpu_torch.utils.loss_log import LossLog
from snag_tpu_torch.utils.seed import set_seed


# --profile_dir traces from the start of the first of these epochs to the
# start of the second
PROFILE_EPOCHS = (2, 4)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Runner:
    def __init__(self, cfg: Config, logger, data: Optional[KGData] = None):
        self.cfg = cfg
        self.logger = logger
        self.device = torch.device(cfg.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"--device {cfg.device}: torch.cuda is not "
                               "available (pass --device cpu to run the "
                               "plain PyTorch twins)")
        self.mesh = None
        n_ranks = mesh_mod.parse_mesh_shape(cfg.mesh_shape)
        if n_ranks:
            self.mesh = mesh_mod.make_mesh(n_ranks, cfg.device, logger)
            self.device = self.mesh.device
            cfg = dataclasses.replace(cfg, device=str(self.device))
            if cfg.batch_size % n_ranks:
                cfg = dataclasses.replace(
                    cfg, batch_size=-(-cfg.batch_size // n_ranks) * n_ranks)
                logger.info(f"mesh batch capacity: {cfg.batch_size}")
            self.cfg = cfg
        self.main_process = self.mesh is None or self.mesh.rank == 0
        set_seed(cfg.random_seed)

        self.data = data if data is not None else load_data(cfg, logger)
        self.train_ill = np.asarray(self.data.train_ill, dtype=np.int32)
        self.test_left = torch.as_tensor(
            self.data.test_ill[:, 0].astype(np.int64), device=self.device)
        self.test_right = torch.as_tensor(
            self.data.test_ill[:, 1].astype(np.int64), device=self.device)
        self.feats, self.stats = place_features(cfg, self.data, self.device,
                                                self.mesh)
        self.graph = self.data.graph.to_torch(self.device)

        generator = torch.Generator().manual_seed(cfg.random_seed)
        self.model = build_model(cfg, self.data, generator).to(self.device)
        mesh_mod.attach(self.model, self.mesh)
        n_params = sum(p.numel() for p in self.model.parameters())
        self.logger.info(f"total params num: {n_params}  device: {self.device}")

        # stage-0 optimizer horizon (main.py:51-56)
        if cfg.il and cfg.il_start >= cfg.epoch:
            raise ValueError(f"--il_start {cfg.il_start} must be below "
                             f"--epoch {cfg.epoch}")
        self._lr = cfg.lr
        self._build_optimizer(cfg.il_start if cfg.il else cfg.epoch)
        # MSNEA trains on the clean tables (JAX runner.py:204)
        self.noise_fn = (make_noise_fn(cfg, self.stats)
                         if cfg.add_noise and cfg.model_name != "MSNEA"
                         else None)
        self.bank = (TripleBank.from_data(self.data, self.device)
                     if cfg.model_name == "MSNEA" else None)

        # run state
        self.epoch = 0
        self.stage = 0
        self.loss_log = LossLog()
        self.best_state: Optional[Dict[str, torch.Tensor]] = None
        self.best_mrr = 0.0
        self.early_stop_init = 200
        self.early_stop_count = self.early_stop_init
        self.il_state = (il_mod.ILState.init(self.data.left_non_train,
                                             self.data.right_non_train,
                                             self.device)
                         if cfg.il else None)
        self.promoted: List[int] = []       # pairs added per promotion
        self.step_ms: List[float] = []      # device ms per train step (CUDA)
        self.step_losses: List[float] = []  # every train step's loss
        self.history = []
        self._last_aux: Dict[str, float] = {}
        self.timings = {}
        self.last_result: Optional[RankResult] = None
        self.pred_path: Optional[str] = None
        self.replay_neg: Optional[torch.Tensor] = None
        self.replay_ready = False
        self._last_neg_count: Optional[int] = None
        self.replay_negatives = 0
        self._profiler = None           # the --profile_dir session
        self.trace_path: Optional[str] = None
        if cfg.model_name == "MEAformer" and cfg.replay:
            self.replay_neg = torch.full((self.data.ent_num,), -1,
                                         dtype=torch.int64,
                                         device=self.device)

        self.start_epoch = 0
        if cfg.resume_from:
            load_checkpoint(self, cfg.resume_from)
            self.start_epoch = self.epoch + 1
            self.logger.info(f"resumed from {cfg.resume_from} "
                             f"(epoch {self.epoch}, stage {self.stage})")

    # ------------------------------------------------------------------
    def _steps_per_epoch(self) -> int:
        return max(1, -(-len(self.train_ill) // self.cfg.batch_size))

    def _build_optimizer(self, total_epochs: int) -> None:
        """A fresh optimizer and schedule over ``total_epochs`` epochs
        (runner.py:176-206); the step count restarts at 0."""
        total_steps = self._steps_per_epoch() * total_epochs
        self._make_train_step(total_steps, int(total_steps * 0.15))

    def _make_train_step(self, total_steps: int, warmup: int) -> None:
        self.logger.info(f"total_steps: {total_steps}  warmup_steps: {warmup}"
                         f"  lr: {self._lr}  weight_decay: "
                         f"{self.cfg.weight_decay}")
        self.train_step = TrainStep(self.cfg, self.model, self._lr,
                                    total_steps, warmup, self.mesh)

    def _batches(self):
        """Shuffled, capacity-padded batches (DataLoader equivalent)."""
        b = self.cfg.batch_size
        perm = np.random.permutation(len(self.train_ill))
        data = self.train_ill[perm]
        for i in range(0, len(data), b):
            chunk = data[i:i + b]
            n = len(chunk)
            if n < b:
                chunk = np.vstack([chunk, np.zeros((b - n, 2), chunk.dtype)])
            valid = np.zeros((b,), dtype=bool)
            valid[:n] = True
            yield (torch.as_tensor(chunk.astype(np.int64), device=self.device),
                   torch.as_tensor(valid, device=self.device))

    def train_epoch(self) -> float:
        if len(self.train_ill) == 0:
            raise RuntimeError("train_ill is empty: no training pairs; check "
                               "--data_rate")
        feats = self.feats
        if self.noise_fn is not None:
            # per-epoch noisy tables (update_noise, main.py:253-254)
            with torch.no_grad():
                feats = self.noise_fn(self.feats, self.epoch)
        cuda = self.device.type == "cuda"
        losses, events, aux, fed = [], [], {}, []
        for links, valid in self._batches():
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                start.record()
            if self.bank is not None:
                loss, aux = msnea_step(self.train_step, self.bank, links,
                                       valid, feats, self.graph, self.epoch)
            elif self.replay_neg is None:
                loss, aux = self.train_step(links, valid, feats, self.graph,
                                            self.epoch)
            else:
                loss, aux, n_fed = replay_step(
                    self.train_step, self.replay_neg, self.replay_ready,
                    links, valid, feats, self.graph, self.epoch)
                fed.append(n_fed)
            losses.append(loss)
            if cuda:
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                events.append((start, end))

        # the device reads of the epoch, after its last step
        losses = torch.stack(losses)
        mean_loss = float(losses.mean())
        self.step_losses += losses.tolist()
        self.step_ms += [s.elapsed_time(e) for s, e in events]
        if self.replay_neg is not None:
            self.replay_negatives += int(torch.stack(fed).sum())
            if not self.replay_ready:
                n_unset = int((self.replay_neg < 0).sum())
                if n_unset == self._last_neg_count:
                    self.replay_ready = True
                    self.logger.info("begin replay!")
                self._last_neg_count = n_unset
        self._last_aux = {}
        for k, v in aux.items():
            if v.dim() == 0:
                self._last_aux[k] = float(v)
            elif k == "weight_norm":
                names = self.cfg.active_modalities()
                for mi, m in enumerate(names[:v.shape[0]]):
                    self._last_aux[f"w_{m}"] = float(v[mi])
        return mean_loss

    # ------------------------------------------------------------------
    @torch.no_grad()
    def _joint_emb(self):
        return self.model.joint_emb(self.feats, self.graph)

    def _log_weight(self, w: Optional[torch.Tensor]):
        # learned modality weights (main.py:361-373), for the families
        # whose reference logs them; per-entity weights averaged
        if w is None or self.cfg.model_name not in ("EVA", "MCLEA", "SNAG"):
            return
        if w.dim() == 2:
            w = w.mean(dim=0)
        w = w.cpu().numpy()
        names = self.cfg.active_modalities()
        desc = "-".join(f"[{m}_{w[i]:.3f}]" for i, m in
                        enumerate(names[:len(w)]))
        self.logger.info(f"modality weights: {desc}")

    @torch.no_grad()
    def evaluate(self, last_epoch: bool = False,
                 save_name: str = "") -> RankResult:
        cfg = self.cfg
        t0 = time.perf_counter()
        joint, weight = self._joint_emb()
        emb = l2norm(joint)
        _sync(self.device)
        t1 = time.perf_counter()
        self._log_weight(weight)
        if self.mesh is not None and self.mesh.world > 1 \
                and cfg.distance == 2:
            res = result_from_ranks(*sharded_full_rank_eval(
                self.mesh, emb[self.test_left], emb[self.test_right],
                csls_k=cfg.csls_k, use_csls=cfg.csls, with_top3=last_epoch))
        else:
            res = full_rank_eval(emb[self.test_left], emb[self.test_right],
                                 top_k=(1, 10, 50), csls_k=cfg.csls_k,
                                 use_csls=cfg.csls,
                                 distance_kind=cfg.distance,
                                 with_top3=last_epoch)
        t2 = time.perf_counter()
        self.timings = {"embed_s": t1 - t0, "eval_s": t2 - t1}
        self.logger.info(f"embed {t1 - t0:.3f} s | eval {t2 - t1:.3f} s "
                         f"({self.device})")
        return self._finish_eval(res, last_epoch, save_name)

    def _finish_eval(self, res: RankResult, last_epoch: bool,
                     save_name: str) -> RankResult:
        self.logger.info(
            f"Ep {self.epoch} | l2r: acc of top [1, 10, 50] = {res.acc_l2r}, "
            f"mr = {res.mr_l2r:.3f}, mrr = {res.mrr_l2r:.3f}")
        self.logger.info(
            f"Ep {self.epoch} | r2l: acc of top [1, 10, 50] = {res.acc_r2l}, "
            f"mr = {res.mr_r2l:.3f}, mrr = {res.mrr_r2l:.3f}")
        if last_epoch:
            self.pred_path = self._dump_predictions(res, save_name)
            t1, t2, _ = res.acc_l2r
            self.logger.info(f"Res:[{t1}\t{t2}\t{res.mrr_l2r:.3f}]")
        self.history.append({"epoch": self.epoch, "mrr_l2r": res.mrr_l2r,
                             "hits1_l2r": float(res.acc_l2r[0])})
        self.last_result = res

        self.early_stop_count -= 1
        if res.mrr_l2r > self.best_mrr and not last_epoch:
            self.logger.info(
                f"Best model update in Ep {self.epoch}: MRR from "
                f"[{self.best_mrr}] --> [{res.mrr_l2r}] ...")
            self.best_mrr = res.mrr_l2r
            self.early_stop_count = self.early_stop_init
            self.best_state = {k: v.detach().clone()
                               for k, v in self.model.state_dict().items()}
        return res

    def _dump_predictions(self, res: RankResult, save_name: str):
        """Top-3 retrieval CSV (main.py:395-420), by rank 0; returns its
        path."""
        cfg = self.cfg
        if res.top3_l2r is None or not self.main_process:
            return None
        save_name = save_name or cfg.model_name
        path = osp.join(cfg.data_path, cfg.model_name, f"{save_name}_pred")
        os.makedirs(path, exist_ok=True)
        tl = self.test_left.cpu().numpy()
        tr = self.test_right.cpu().numpy()
        rows = [["idx", "rank", "query_id", "gt_id", "ret1", "ret2", "ret3"]]
        for i in range(len(tl)):
            r3 = res.top3_l2r[i]
            rows.append([i, int(res.ranks_l2r[i]), tl[i], tr[i],
                         tr[r3[0]], tr[r3[1]], tr[r3[2]]])
        out = osp.join(path, f"{cfg.data_choice}_pred.txt")
        with open(out, "w") as f:
            csv.writer(f, dialect="excel").writerows(rows)
        return out

    # ------------------------------------------------------------------
    def _il_mine(self):
        """il_for_ea (main.py:214-223)."""
        sls = self.cfg.semi_learn_step
        joint, _ = self._joint_emb()
        emb = l2norm(joint)
        fresh = ((self.epoch + 1) % (sls * 5)) == sls
        il = self.il_state
        with torch.no_grad():
            new_cand = il_mod.mine_new_links(
                emb, il.left_cand, il.left_valid, il.right_cand,
                il.right_valid, il.cand_right, fresh, mesh=self.mesh)
        il.cand_right = new_cand
        if (self.epoch + 1) % (sls * 5) == 0:
            n = int(((new_cand >= 0) & il.left_valid).sum())
            self.logger.info(f"[epoch {self.epoch}] #links in candidate set: {n}")

    def _il_refresh(self):
        """il_for_data_ref (main.py:226-237)."""
        self.il_state, self.train_ill, n_new = il_mod.promote_candidates(
            self.il_state, self.train_ill, self.data.test_ill_set,
            self.logger)
        self.promoted.append(n_new)
        if n_new:
            set_seed(self.cfg.random_seed)

    def _load_best(self):
        self.model.load_state_dict(self.best_state)

    # ------------------------------------------------------------------
    def run(self) -> RankResult:
        cfg = self.cfg
        writer = None
        if not cfg.no_tensorboard and self.main_process:
            from snag_tpu_torch.utils.metrics_writer import MetricsWriter
            writer = MetricsWriter(get_dump_path(cfg))
        try:
            return self._run(writer)
        finally:
            self._profile(None)
            if writer is not None:
                writer.close()

    def _run(self, writer) -> RankResult:
        cfg = self.cfg
        t0 = time.time()
        for i in range(self.start_epoch, cfg.epoch):
            self.epoch = i
            self._profile(i)
            if cfg.il and ((i == cfg.il_start and self.stage == 0)
                           or (self.early_stop_count <= 0
                               and i <= cfg.il_start)):
                if self.early_stop_count <= 0:
                    self.logger.info(
                        f"Early stop in epoch {i}... Begin iteration....")
                self.stage = 1
                self.early_stop_count = self.early_stop_init
                self._lr = self._lr / 5
                self._build_optimizer((cfg.epoch - cfg.il_start) * 3)
                if self.best_state is not None:
                    self.logger.info("load from the best model before IL... ")
                    self._load_best()
                self.evaluate(last_epoch=True,
                              save_name=f"{cfg.exp_id}_test_ep{cfg.epoch}_no_iter")

            if self.stage == 1 and cfg.il \
                    and (i + 1) % cfg.semi_learn_step == 0:
                self._il_mine()
            if self.stage == 1 and cfg.il \
                    and (i + 1) % (cfg.semi_learn_step * 10) == 0:
                self._il_refresh()

            epoch_loss = self.train_epoch()
            self.loss_log.update(epoch_loss)
            if (i + 1) % cfg.log_every == 0 or i == 0:
                step = self.train_step.count
                lr_now = self.train_step.lr()
                self.logger.info(
                    f"Ep [{i}/{cfg.epoch}] Step [{step}] LR [{lr_now:.6f}] "
                    f"Loss {epoch_loss:.5f} ({time.time() - t0:.1f}s)")
                if writer is not None:
                    writer.scalars("loss", {"train_loss": epoch_loss}, step)
                    writer.scalars("lr", {"lr": lr_now}, step)
                    if self._last_aux:
                        writer.scalars("loss_terms", self._last_aux, step)

            if (i + 1) % cfg.eval_epoch == 0:
                self.evaluate()
            if cfg.checkpoint_every and (i + 1) % cfg.checkpoint_every == 0:
                path = osp.join(get_dump_path(cfg), CHECKPOINT_NAME)
                if self.main_process:
                    save_checkpoint(self, path)
                    self.logger.info(f"checkpoint saved to {path}")
                if self.mesh is not None:
                    self.mesh.barrier()
            if self.stage == 1 and self.early_stop_count <= 0:
                self.logger.info(f"Early stop in epoch {i}")
                break
        self._profile(None)

        if self.best_state is not None:
            self.logger.info("load from the best model before final testing ... ")
            self._load_best()
        self.logger.info(" --------------------- Test result --------------------- ")
        res = self.evaluate(last_epoch=True,
                            save_name=f"{cfg.exp_id}_test_ep{cfg.epoch}")
        self.logger.info(f"min loss {self.loss_log.get_min_loss()}")
        if self.step_ms:
            self.logger.info(f"train step: median {statistics.median(self.step_ms):.3f}"
                             f" ms over {len(self.step_ms)} steps ({self.device})")
        if cfg.save_model and self.main_process:
            self.save_model()
        return res

    def _profile(self, epoch: Optional[int]) -> None:
        """``--profile_dir``: a ``torch.profiler`` session (CPU, and CUDA on
        a card) from the start of epoch ``PROFILE_EPOCHS[0]`` to the start
        of ``PROFILE_EPOCHS[1]``, the epochs the JAX runner traces
        (snag_tpu/train/runner.py:432-438), or to the end of training
        (``epoch`` None) if that comes first; its Chrome trace is written
        under ``--profile_dir`` when it ends.  Under a mesh rank 0 traces
        alone."""
        if epoch == PROFILE_EPOCHS[0] and self.cfg.profile_dir \
                and self.main_process:
            from torch.profiler import ProfilerActivity, profile
            activities = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            self._profiler = profile(activities=activities)
            self._profiler.start()
        elif self._profiler is not None and epoch in (PROFILE_EPOCHS[1],
                                                      None):
            _sync(self.device)
            self._profiler.stop()
            os.makedirs(self.cfg.profile_dir, exist_ok=True)
            self.trace_path = osp.join(self.cfg.profile_dir,
                                       f"{self.cfg.exp_id}_trace.json")
            self._profiler.export_chrome_trace(self.trace_path)
            self._profiler = None
            self.logger.info(f"profiler trace written to {self.trace_path}")

    # ------------------------------------------------------------------
    def save_model(self) -> str:
        """The model's weights (the best model's after ``run``) as a
        reference ``.pkl`` under ``<data_path>/<model>/save/``
        (main.py:481-500)."""
        cfg = self.cfg
        path = osp.join(cfg.data_path, cfg.model_name, "save")
        os.makedirs(path, exist_ok=True)
        path = save_reference_checkpoint(
            self.model, osp.join(path, f"{cfg.exp_id}.pkl"))
        self.logger.info(f"saving [{path}] done!")
        return path

    def load_model(self, name: str) -> bool:
        """Load a reference-format ``.pkl`` checkpoint
        (torch.save(state_dict), SNAG_MMEA/main.py:481-500), the port's
        ``save_model`` output among them; a name without the ``.pkl``
        suffix (an ``exp_id``, which may hold dots) means ``<name>.pkl``,
        and a relative one lies under ``<data_path>/<model>/save/``.
        Every port parameter must be present; extra reference keys are
        ignored."""
        cfg = self.cfg
        if not name.endswith(".pkl"):
            name += ".pkl"
        path = name if osp.isabs(name) else osp.join(
            cfg.data_path, cfg.model_name, "save", name)
        if not osp.exists(path):
            self.logger.info(f"{path} not exist!!")
            return False
        rel_fc = next((m for name, m in self.model.named_modules()
                       if name.split(".")[-1] == "rel_fc"), None)
        sd = load_reference_checkpoint(
            path, rel_in_dim=None if rel_fc is None else rel_fc.in_features)
        own = self.model.state_dict()
        missing = [k for k in own if k not in sd]
        if missing:
            raise KeyError(f"{path} has no tensor for {missing}")
        self.model.load_state_dict({k: sd[k] for k in own}, strict=True)
        self.logger.info(f"imported reference checkpoint [{path}] done!")
        return True
