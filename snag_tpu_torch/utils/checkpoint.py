"""Full mid-training checkpoint and resume of an MMEA or MKGC run.

Port of ``snag_tpu/utils/checkpoint.py``: MMEA's ``save_checkpoint`` /
``load_checkpoint`` and, at the end, MKGC's ``save_mkgc_checkpoint`` /
``load_mkgc_checkpoint``.  An MMEA run's file is
``<dump>/checkpoint.pt``, written by ``torch.save`` with every array stored
as a tensor, so ``torch.load(path, weights_only=True)`` reads it.  It holds
the model and the best model's state dicts, the AdamW state, the schedule
(its step count and the horizon it was built with), the running mean of
the gradients of an unfinished ``--accumulation_steps`` cycle (its
position is the step count mod k), ``epoch``, ``stage``, the LR,
``best_mrr``, ``early_stop_count``, the epoch losses, the grown
``train_ill``, the five ``ILState`` tensors, and the global ``numpy`` and
``random`` states, and MEAformer's replay buffer with its ready flag, the
last count of unset entries and the count of replay negatives fed.

Contract: a run resumed from a checkpoint repeats the uninterrupted run
exactly, parameter for parameter and metric for metric.  The batches come
from ``np.random.permutation`` and a promotion re-seeds that RNG, so its
state is saved; the noise and dropout streams are derived from
(seed, epoch) and (seed, step), MSNEA's triples from (seed, step) and
the step count, and need nothing saved.  The schedule's
horizon is saved rather than recomputed: the stage-1 horizon is fixed
when the stage begins, before promotions grow ``train_ill``, so a
recomputed one would change every LR after a resume past a promotion (the
JAX package recomputes it, and its kill-and-resume gate checks only the
final MRR).
"""

from __future__ import annotations

import os
import os.path as osp
import random
from typing import Any, Dict

import numpy as np
import torch

from snag_tpu_torch.train.il import ILState

CHECKPOINT_NAME = "checkpoint.pt"
IL_FIELDS = ("left_cand", "left_valid", "right_cand", "right_valid",
             "cand_right")


def _np_random_state() -> Dict[str, Any]:
    kind, keys, pos, has_gauss, gauss = np.random.get_state()
    return {"kind": kind, "keys": torch.from_numpy(keys.astype(np.int64)),
            "pos": int(pos), "has_gauss": int(has_gauss),
            "gauss": float(gauss)}


def _set_np_random_state(s: Dict[str, Any]) -> None:
    np.random.set_state((s["kind"], s["keys"].cpu().numpy().astype(np.uint32),
                         s["pos"], s["has_gauss"], s["gauss"]))


def _py_random_state() -> Dict[str, Any]:
    version, internal, gauss_next = random.getstate()
    return {"version": version,
            "internal": torch.tensor(internal, dtype=torch.int64),
            "gauss_next": gauss_next}


def _set_py_random_state(s: Dict[str, Any]) -> None:
    random.setstate((s["version"], tuple(s["internal"].cpu().tolist()),
                     s["gauss_next"]))


def save_checkpoint(runner, path: str) -> str:
    """Write ``runner``'s train state to ``path`` (atomically: a kill
    during the write leaves the previous file whole)."""
    os.makedirs(osp.dirname(path) or ".", exist_ok=True)
    step = runner.train_step
    il = runner.il_state
    payload = {
        "model": runner.model.state_dict(),
        "best_state": runner.best_state,
        "optimizer": step.opt.state_dict(),
        "schedule": {"count": step.count, "total_steps": step.total_steps,
                     "warmup_steps": step.warmup_steps,
                     "accum": step.accum},
        "epoch": runner.epoch,
        "stage": runner.stage,
        "lr": runner._lr,
        "best_mrr": runner.best_mrr,
        "early_stop_count": runner.early_stop_count,
        "losses": list(runner.loss_log.loss),
        "train_ill": torch.from_numpy(np.asarray(runner.train_ill)),
        "il": None if il is None else {f: getattr(il, f) for f in IL_FIELDS},
        "np_random": _np_random_state(),
        "py_random": _py_random_state(),
        "replay": None if runner.replay_neg is None else {
            "neg": runner.replay_neg, "ready": runner.replay_ready,
            "last_count": runner._last_neg_count,
            "fed": runner.replay_negatives},
    }
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def load_checkpoint(runner, path: str) -> None:
    """Restore ``runner`` from ``path``: the optimizer and schedule are
    rebuilt with the saved horizon and LR, then given the saved state."""
    payload = torch.load(path, map_location=runner.device, weights_only=True)
    runner.model.load_state_dict(payload["model"])
    runner.best_state = payload["best_state"]
    runner.epoch = int(payload["epoch"])
    runner.stage = int(payload["stage"])
    runner._lr = float(payload["lr"])
    runner.best_mrr = float(payload["best_mrr"])
    runner.early_stop_count = int(payload["early_stop_count"])
    runner.loss_log.loss = list(payload["losses"])
    runner.train_ill = payload["train_ill"].cpu().numpy()
    sched = payload["schedule"]
    runner._make_train_step(sched["total_steps"], sched["warmup_steps"])
    runner.train_step.opt.load_state_dict(payload["optimizer"])
    runner.train_step.count = int(sched["count"])
    runner.train_step.accum = sched.get("accum")
    if payload["il"] is not None:
        runner.il_state = ILState(**payload["il"])
    replay = payload.get("replay")
    if replay is not None:
        runner.replay_neg = replay["neg"]
        runner.replay_ready = bool(replay["ready"])
        runner._last_neg_count = replay["last_count"]
        runner.replay_negatives = int(replay["fed"])
    _set_np_random_state(payload["np_random"])
    _set_py_random_state(payload["py_random"])


# ---------------------------------------------------------------------------
# MKGC checkpoints (JAX ``save_mkgc_checkpoint`` / ``load_mkgc_checkpoint``,
# snag_tpu/utils/checkpoint.py:105-146): the early-stop bookkeeping
# survives a resume, so a preempted run stops at the eval it would have.
# Every generator of the run derives from (seed, epoch) or (seed, step
# count), so the step count is all the RNG state there is.
# ---------------------------------------------------------------------------

def save_mkgc_checkpoint(runner, path: str) -> str:
    """Write an ``MKGCRunner``'s train state to ``path`` atomically."""
    os.makedirs(osp.dirname(path) or ".", exist_ok=True)
    payload = {
        "model": runner.model.state_dict(),
        "optimizer": runner.step.opt.state_dict(),
        "step": runner.step.count,
        "epoch": runner.epoch,
        "best_mrr": runner.best_mrr,
        "bad_evals": runner.bad_evals,
        "best_params": runner.best_params,
        "losses": list(runner.losses),
    }
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def load_mkgc_checkpoint(runner, path: str) -> None:
    """Restore an ``MKGCRunner`` from ``path``: the tensors are read onto
    the CPU and copied into the runner's, on its device."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    runner.model.load_state_dict(payload["model"])
    runner.step.opt.load_state_dict(payload["optimizer"])
    runner.step.count = int(payload["step"])
    runner.epoch = int(payload["epoch"])
    runner.best_mrr = float(payload["best_mrr"])
    runner.bad_evals = int(payload["bad_evals"])
    runner.losses = list(payload["losses"])
    best = payload["best_params"]
    runner.best_params = (None if best is None else
                          {k: v.to(runner.device) for k, v in best.items()})
