"""Inference runner: the parts of ``snag_tpu/train/runner.py::Runner`` that
``--only_test`` runs (reference SNAG_MMEA/main.py:31-529).

Data, features and model are built once on ``cfg.device``; ``evaluate``
embeds every entity, L2-normalizes, gathers the test rows and runs the
full-rank evaluation, logging the reference's ``Ep ... | l2r/r2l`` lines
and writing the top-3 retrieval CSV.  Training is not ported yet.
"""

from __future__ import annotations

import csv
import os
import os.path as osp
import time
from typing import Optional

import numpy as np
import torch

from snag_tpu_torch.config import Config
from snag_tpu_torch.data.dataset import KGData, load_data
from snag_tpu_torch.eval.ranking import RankResult, full_rank_eval
from snag_tpu_torch.models import build_model
from snag_tpu_torch.models.encoder import prepare_features
from snag_tpu_torch.ops.fusion import l2norm
from snag_tpu_torch.utils.import_reference import load_reference_checkpoint
from snag_tpu_torch.utils.seed import set_seed


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
        if cfg.dtype != "float32":
            raise NotImplementedError(f"--dtype {cfg.dtype}: only float32 "
                                      "is ported")
        if cfg.mesh_shape:
            raise NotImplementedError("--mesh_shape: multi-GPU is not ported")
        set_seed(cfg.random_seed)

        self.data = data if data is not None else load_data(cfg, logger)
        self.test_left = torch.as_tensor(
            self.data.test_ill[:, 0].astype(np.int64), device=self.device)
        self.test_right = torch.as_tensor(
            self.data.test_ill[:, 1].astype(np.int64), device=self.device)
        self.feats = prepare_features(cfg, self.data, self.device)
        self.graph = self.data.graph.to_torch(self.device)

        generator = torch.Generator().manual_seed(cfg.random_seed)
        self.model = build_model(cfg, self.data, generator).to(self.device)
        self.model.eval()
        n_params = sum(p.numel() for p in self.model.parameters())
        self.logger.info(f"total params num: {n_params}  device: {self.device}")

        self.epoch = 0
        self.timings = {}
        self.last_result: Optional[RankResult] = None
        self.pred_path: Optional[str] = None

    # ------------------------------------------------------------------
    @torch.no_grad()
    def _joint_emb(self):
        return self.model.joint_emb(self.feats, self.graph)

    def _log_weight(self, w: torch.Tensor):
        # learned modality weights (main.py:361-373), mean over entities
        w = w.mean(dim=0).cpu().numpy()
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
        res = full_rank_eval(emb[self.test_left], emb[self.test_right],
                             top_k=(1, 10, 50), csls_k=cfg.csls_k,
                             use_csls=cfg.csls, distance_kind=cfg.distance,
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
        self.last_result = res
        return res

    def _dump_predictions(self, res: RankResult, save_name: str):
        """Top-3 retrieval CSV (main.py:395-420); returns its path."""
        cfg = self.cfg
        if res.top3_l2r is None:
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
    def train_epoch(self) -> float:
        raise NotImplementedError("training: not ported yet")

    def run(self):
        raise NotImplementedError("training: not ported yet")

    # ------------------------------------------------------------------
    def load_model(self, name: str) -> bool:
        """Load a reference-format ``.pkl`` checkpoint
        (torch.save(state_dict), SNAG_MMEA/main.py:481-500).  Every port
        parameter must be present; extra reference keys are ignored."""
        cfg = self.cfg
        if not name.endswith(".pkl"):
            raise NotImplementedError(
                f"{name}: only reference .pkl checkpoints load in the port")
        path = name if osp.isabs(name) else osp.join(
            cfg.data_path, cfg.model_name, "save", name)
        if not osp.exists(path):
            self.logger.info(f"{path} not exist!!")
            return False
        enc = self.model.multimodal_encoder
        rel_fc = getattr(enc, "rel_fc", None)
        sd = load_reference_checkpoint(
            path, rel_in_dim=None if rel_fc is None else rel_fc.in_features)
        own = self.model.state_dict()
        missing = [k for k in own if k not in sd]
        if missing:
            raise KeyError(f"{path} has no tensor for {missing}")
        self.model.load_state_dict({k: sd[k] for k in own}, strict=True)
        self.logger.info(f"imported reference checkpoint [{path}] done!")
        return True
