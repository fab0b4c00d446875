"""Train-state checkpoints and saved models of the port, on the CPU.

A run killed after a checkpoint and resumed from it equals the
uninterrupted run bit for bit: parameters, AdamW state, ``train_ill``,
``ILState`` and every ``Ep N | l2r/r2l`` and ``Res:`` line.  The kill is
simulated by raising from ``train_epoch``; the run checkpoints every 3
epochs, IL starts at epoch 6 and promotes at epoch 9, so a kill after
epoch 2 resumes in stage 0 across the transition and one after epoch 11
resumes in stage 1 after the promotion; a third case starts IL at epoch 2,
so that the promotion adds pairs before the kill.  The ``--save_model`` ``.pkl``
loads through the JAX package's ``import_reference_checkpoint`` with every
tensor equal, and the JAX encoder's joint embeddings on it match the
port's within rtol = atol = 1e-5 (two frameworks' f32 sums); served with
``--only_test 1``, it reproduces the trained run's final ``Res:`` line.
All of it runs on files the port exported itself (DBP15K ja_en layout).
"""

import os.path as osp
import re

import jax
import numpy as np
import pytest
import torch

from snag_tpu.data.dataset import load_data as jax_load_data
from snag_tpu.models import build_model as jax_build_model
from snag_tpu.models.encoder import prepare_features as jax_prepare_features
from snag_tpu.models.snag import SNAG as JaxSNAG
from snag_tpu.utils.import_reference import import_reference_checkpoint
from snag_tpu_torch.cli.train_mmea import main as port_main
from snag_tpu_torch.config import (build_argparser, config_from_args,
                                   finalize_config)
from snag_tpu_torch.data.export_reference import export_reference_format
from snag_tpu_torch.train.runner import Runner
from snag_tpu_torch.utils.checkpoint import CHECKPOINT_NAME, IL_FIELDS
from snag_tpu_torch.utils.import_reference import state_dict_from_flax
from snag_tpu_torch.utils.logging import get_dump_path
from torch_port_common import (configs, jax_params, single_thread,
                               small_argv)

single_thread()

FILES = dict(data_choice="DBP15K", data_split="ja_en")
TRAIN = dict(epoch=14, il="", semi_learn_step=1, eval_epoch=2,
             batch_size=32, lr=5e-4, scheduler="cos", add_noise=1,
             noise_ratio=0.2, mask_ratio=0.7, checkpoint_every=3)
LINE_RE = re.compile(r"(Ep \d+ \| [lr]2[lr]: .*|Res:\[.*\])")


class Killed(Exception):
    pass


def _argv(root, exp_id, **extra):
    return small_argv(osp.join(root, "data"), **FILES, exp_id=exp_id,
                      dump_path=osp.join(root, "dump"), **extra)


def _dump(argv):
    return get_dump_path(finalize_config(config_from_args(
        build_argparser().parse_args(argv))))


def _lines(argv):
    with open(osp.join(_dump(argv), "train.log")) as f:
        return LINE_RE.findall(f.read())


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("resume"))
    export_reference_format(osp.join(root, "data"), n_ents=400, n_rels=12,
                            n_triples=1600, img_dim=24, seed=0, noise=1.2,
                            mirror_p=0.4, unalignable_frac=0.35,
                            img_coverage=1.0)
    return root


@pytest.fixture(scope="module")
def uninterrupted(root):
    """il_start -> the uninterrupted run, its log lines and saved model."""
    runs = {}

    def get(il_start):
        if il_start not in runs:
            # a dotted exp_id, as the reference's sweeps name runs: the
            # saved model is served by that name without its suffix
            argv = _argv(root, f"full_1.0_{il_start}", **TRAIN,
                         il_start=il_start, save_model=1)
            runner = port_main(argv)
            assert runner.stage == 1
            runs[il_start] = dict(runner=runner, lines=_lines(argv))
        return runs[il_start]
    return get


@pytest.fixture(scope="module")
def full(uninterrupted):
    return uninterrupted(6)


def _state_equal(a, b, what):
    assert a.keys() == b.keys(), what
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert torch.equal(a[k], b[k]), (what, k)
        elif isinstance(a[k], dict):
            _state_equal(a[k], b[k], f"{what}.{k}")
        else:
            assert a[k] == b[k], (what, k)


# (il_start, kill after epoch, stage at the kill).  With IL from epoch 6
# the promotion at epoch 9 adds nothing (candidates must persist from a
# fresh mining round, the first at epoch 10), but the epoch-11 checkpoint
# holds that round's candidates; with IL from epoch 2 the promotion at
# epoch 9 grows train_ill, so the stage-1 schedule's saved horizon matters
@pytest.mark.parametrize("il_start,kill_after,stage",
                         [(6, 2, 0), (6, 11, 1), (2, 11, 1)])
def test_killed_and_resumed_run_equals_uninterrupted(
        root, uninterrupted, monkeypatch, il_start, kill_after, stage):
    ref = uninterrupted(il_start)["runner"]
    if il_start == 2:
        assert ref.promoted[0] > 0
    else:
        assert not any(ref.promoted)
        assert (ref.il_state.cand_right >= 0).any()
    argv = _argv(root, f"kill{il_start}_{kill_after}", **TRAIN,
                 il_start=il_start, save_model=1)
    train_epoch = Runner.train_epoch

    def killing(self):
        if self.epoch == kill_after + 1:
            raise Killed
        return train_epoch(self)

    monkeypatch.setattr(Runner, "train_epoch", killing)
    with pytest.raises(Killed):
        port_main(argv)
    monkeypatch.setattr(Runner, "train_epoch", train_epoch)
    killed_lines = _lines(argv)

    ckpt = osp.join(_dump(argv), CHECKPOINT_NAME)
    payload = torch.load(ckpt, weights_only=True)
    assert (payload["epoch"], payload["stage"]) == (kill_after, stage)
    resumed = port_main(argv + ["--resume_from", ckpt])
    with open(osp.join(_dump(argv), "train.log")) as f:
        assert f"resumed from {ckpt} (epoch {kill_after}, stage {stage})" \
            in f.read()

    got = _lines(argv)
    assert got[:len(killed_lines)] == killed_lines
    assert got == uninterrupted(il_start)["lines"]
    _state_equal(resumed.model.state_dict(), ref.model.state_dict(), "model")
    _state_equal(resumed.train_step.opt.state_dict(),
                 ref.train_step.opt.state_dict(), "adamw")
    assert resumed.train_step.count == ref.train_step.count
    np.testing.assert_array_equal(resumed.train_ill, ref.train_ill)
    for f in IL_FIELDS:
        assert torch.equal(getattr(resumed.il_state, f),
                           getattr(ref.il_state, f)), f
    assert resumed.loss_log.loss == ref.loss_log.loss
    assert resumed.best_mrr == ref.best_mrr


def _saved_pkl(runner):
    return osp.join(runner.cfg.data_path, "SNAG", "save",
                    f"{runner.cfg.exp_id}.pkl")


def test_saved_model_loads_in_jax(full, tmp_path):
    runner = full["runner"]
    jcfg, _ = configs(str(tmp_path), data_path=runner.cfg.data_path, **FILES)
    jdata = jax_load_data(jcfg)
    jmodel = jax_build_model(jcfg, jdata)
    jfeats = jax_prepare_features(jcfg, jdata)
    template = jax_params(jmodel, jfeats, jdata.graph,
                               jax.random.PRNGKey(0))
    params = import_reference_checkpoint(template, _saved_pkl(runner))
    back = state_dict_from_flax(jax.device_get(params))
    own = runner.model.state_dict()
    assert back.keys() == own.keys()
    for k, v in own.items():
        np.testing.assert_array_equal(back[k].numpy(), v.numpy(), err_msg=k)

    want_joint, want_w = jmodel.apply({"params": params}, jfeats,
                                      jdata.graph, method=JaxSNAG.joint_emb)
    got_joint, got_w = runner._joint_emb()
    np.testing.assert_allclose(got_joint.numpy(), np.asarray(want_joint),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w),
                               rtol=1e-5, atol=1e-5)


def test_only_test_serves_saved_model(root, full):
    runner = full["runner"]
    argv = _argv(root, "serve", only_test=1,
                 model_name_save=runner.cfg.exp_id)
    served = port_main(argv)
    assert _lines(argv)[-1] == full["lines"][-1]
    assert full["lines"][-1].startswith("Res:")
    np.testing.assert_array_equal(served.last_result.ranks_l2r,
                                  runner.last_result.ranks_l2r)
