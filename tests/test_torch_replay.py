"""MEAformer's replay of mined hard negatives (``--replay 1``) in the port
against the JAX package, on the CPU.

* ``replay_negative_mask`` equals JAX's exactly on random inputs with
  repeated entities, unset (-1) slots and padded rows;
* the miner's columns equal JAX's exactly on logits both frameworks
  compute exactly (integer rows, no normalisation), ties included:
  ``torch.argmax`` and ``jnp.argmax`` both take the first maximum;
* three unpadded steps of JAX's ``make_meaformer_replay_step`` (dropout
  off through a proxy model) and of the port's ``replay_step`` leave the
  same buffer, entry for entry, with losses within rel 1e-4;
* after a padded batch the two buffers differ only at entity 0, the pads'
  entity, where entity 0 is a valid row of that batch: JAX scatters every
  row, pads included, writing the pads' old entry back, and so loses
  entity 0's update; the port writes valid rows only (ROADMAP C,
  "Reference gaps");
* a CPU run killed after replay began and resumed from its checkpoint
  equals the uninterrupted run bit for bit.
"""

import copy
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snag_tpu.losses.contrastive import icl_loss as jax_icl_loss
from snag_tpu.train.optim import build_optimizer as jax_build_optimizer
from snag_tpu.train.step import TrainState
from snag_tpu.train.step import make_meaformer_replay_step
from snag_tpu.train.step import replay_negative_mask as jax_replay_mask
from snag_tpu_torch.cli.train_mmea import main as port_main
from snag_tpu_torch.config import (build_argparser, config_from_args,
                                   finalize_config)
from snag_tpu_torch.losses.contrastive import icl_loss
from snag_tpu_torch.train.runner import Runner
from snag_tpu_torch.train.step import (TrainStep, replay_negative_mask,
                                       replay_step)
from snag_tpu_torch.utils.checkpoint import CHECKPOINT_NAME
from snag_tpu_torch.utils.logging import get_dump_path
from torch_port_common import model_pair, single_thread, small_argv

single_thread()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_replay_negative_mask_matches_jax(seed):
    rng = np.random.default_rng(seed)
    b, n = 40, 200
    neg = rng.integers(-1, n, size=b)               # -1 = unset, repeats
    links = rng.integers(0, n, size=(b, 2))
    valid = np.arange(b) < 31
    links[~valid] = 0                               # the runner's pads
    batch = np.concatenate([links[:, 0], links[:, 1]])
    want = np.asarray(jax_replay_mask(jnp.asarray(neg), jnp.asarray(batch),
                                      jnp.asarray(valid)))
    got = replay_negative_mask(torch.from_numpy(neg), torch.from_numpy(batch),
                               torch.from_numpy(valid)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.any() and not got.all()


def test_mined_columns_match_jax_exactly():
    """Integer rows and no normalisation give both frameworks the same
    logits to the bit; repeated rows make ties, and a replay block (some
    negatives masked) joins the miner's columns."""
    rng = np.random.default_rng(7)
    emb = rng.integers(-3, 4, size=(50, 8)).astype(np.float32)
    emb[10:14] = emb[20]                            # ties among the rows
    links = rng.choice(50, size=(16, 2), replace=False).astype(np.int64)
    emb[links[3, 1]] = emb[links[3, 0]]             # a tied positive
    valid = np.arange(16) < 14
    neg_l = rng.integers(0, 50, size=16)
    neg_r = rng.integers(0, 50, size=16)
    nv = rng.uniform(size=16) > 0.4
    out_j = jax_icl_loss(jnp.asarray(emb), jnp.asarray(links), tau=0.1,
                         valid=jnp.asarray(valid), neg_l=jnp.asarray(neg_l),
                         neg_r=jnp.asarray(neg_r), neg_valid=jnp.asarray(nv),
                         norm=False, with_replay_mining=True)
    out_t = icl_loss(torch.from_numpy(emb), torch.from_numpy(links), tau=0.1,
                     valid=torch.from_numpy(valid),
                     neg_l=torch.from_numpy(neg_l),
                     neg_r=torch.from_numpy(neg_r),
                     neg_valid=torch.from_numpy(nv), norm=False,
                     with_replay_mining=True)
    np.testing.assert_allclose(out_t[0].item(), float(out_j[0]), rtol=1e-5)
    for got, want in zip(out_t[1:], out_j[1:]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


class _Deterministic:
    """JAX's model with dropout off: ``make_meaformer_replay_step`` calls
    ``apply`` with ``deterministic=False`` and a dropout key the port
    cannot draw."""

    def __init__(self, model):
        self.model = model

    def apply(self, variables, *args, deterministic=False, **kw):
        return self.model.apply(variables, *args, deterministic=True, **kw)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return model_pair(str(tmp_path_factory.mktemp("replay")),
                      model_name="MEAformer", replay=1, lr=5e-4,
                      scheduler="cos", tau2=4.0)


def _run_both(pair, batches, ready):
    """The same steps through JAX's replay step and the port's; returns
    (JAX buffer, port buffer, JAX losses, port losses, port's valid
    negatives fed)."""
    total, warmup = 20, 3
    n = pair["tdata"].ent_num
    params = jax.tree_util.tree_map(jnp.asarray, pair["params"])
    tx, _ = jax_build_optimizer(pair["jcfg"], params, total, warmup)
    state = TrainState(params=params, opt_state=tx.init(params),
                       step=jnp.zeros((), jnp.int32),
                       base_key=jax.random.PRNGKey(0))
    jstep = make_meaformer_replay_step(pair["jcfg"],
                                       _Deterministic(pair["jmodel"]), tx,
                                       None)
    jbuf = -jnp.ones((n,), jnp.int32)
    jlosses = []
    for (links, valid), r in zip(batches, ready):
        state, loss, _, jbuf = jstep(state, jnp.asarray(links),
                                     jnp.asarray(valid), pair["jfeats"],
                                     pair["jdata"].graph, jnp.asarray(0),
                                     jbuf, jnp.asarray(r))
        jlosses.append(float(loss))

    model = copy.deepcopy(pair["tmodel"])
    step = TrainStep(pair["tcfg"], model, pair["tcfg"].lr, total, warmup)
    tbuf = torch.full((n,), -1, dtype=torch.int64)
    tlosses, fed = [], 0
    for (links, valid), r in zip(batches, ready):
        loss, _, n_fed = replay_step(step, tbuf, r, torch.from_numpy(links),
                                     torch.from_numpy(valid), pair["tfeats"],
                                     pair["tgraph"], 0, deterministic=True)
        tlosses.append(loss.item())
        fed += int(n_fed)
    return np.asarray(jbuf), tbuf.numpy(), jlosses, tlosses, fed


def test_replay_buffer_after_three_steps_matches_jax(pair):
    """Three unpadded batches that share entities; replay on from the
    second step, so that the first step's mined negatives are fed."""
    ill = np.asarray(pair["tdata"].train_ill, dtype=np.int64)
    assert len(ill) >= 15
    batches = [(ill[k:k + 10], np.ones(10, bool)) for k in (0, 5, 3)]
    jbuf, tbuf, jl, tl, fed = _run_both(pair, batches, (False, True, True))
    np.testing.assert_array_equal(tbuf, jbuf)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert fed > 0 and (tbuf >= 0).sum() > 0


def test_padded_batch_buffer_differs_only_at_entity_zero(pair):
    """A padded batch holding entity 0 on its left side: every buffer
    entry agrees but entity 0's, which JAX's pads set back to its old
    value (-1) while the port keeps the mined one."""
    ill = np.asarray(pair["tdata"].train_ill, dtype=np.int64)
    rows = ill[(ill != 0).all(axis=1)][:10]
    links = np.zeros((14, 2), np.int64)
    links[:10] = rows
    links[4, 0] = 0                                  # entity 0, valid
    valid = np.arange(14) < 10
    jbuf, tbuf, _, _, _ = _run_both(pair, [(links, valid)], (False,))
    differ = np.flatnonzero(jbuf != tbuf)
    np.testing.assert_array_equal(differ, [0])
    assert jbuf[0] == -1 and tbuf[0] >= 0


# ------------------------------------------------- kill and resume, the CLI

TRAIN = dict(model_name="MEAformer", replay=1, tau2=4.0, epoch=9, il="",
             il_start=4, semi_learn_step=1, eval_epoch=2, batch_size=8,
             lr=5e-4, scheduler="cos", add_noise=1, noise_ratio=0.2,
             mask_ratio=0.7, checkpoint_every=3)


class Killed(Exception):
    pass


def test_killed_and_resumed_replay_run_equals_uninterrupted(tmp_path,
                                                            monkeypatch):
    """Replay begins after epoch 1; the epoch-5 checkpoint holds a ready
    buffer and the kill comes after epoch 6."""
    ref = port_main(small_argv(tmp_path / "full", exp_id="full", **TRAIN))
    assert ref.replay_ready and ref.replay_negatives > 0

    argv = small_argv(tmp_path / "kill", exp_id="kill", **TRAIN)
    train_epoch = Runner.train_epoch

    def killing(self):
        if self.epoch == 7:
            raise Killed
        return train_epoch(self)

    monkeypatch.setattr(Runner, "train_epoch", killing)
    with pytest.raises(Killed):
        port_main(argv)
    monkeypatch.setattr(Runner, "train_epoch", train_epoch)
    cfg = finalize_config(config_from_args(build_argparser().parse_args(argv)))
    ckpt = osp.join(get_dump_path(cfg), CHECKPOINT_NAME)
    payload = torch.load(ckpt, weights_only=True)
    assert payload["epoch"] == 5 and payload["replay"]["ready"]
    resumed = port_main(argv + ["--resume_from", ckpt])

    assert torch.equal(resumed.replay_neg, ref.replay_neg)
    assert resumed.replay_negatives == ref.replay_negatives
    assert resumed.loss_log.loss == ref.loss_log.loss
    own, want = resumed.model.state_dict(), ref.model.state_dict()
    assert own.keys() == want.keys()
    for k in own:
        assert torch.equal(own[k], want[k]), k
    np.testing.assert_array_equal(resumed.last_result.ranks_l2r,
                                  ref.last_result.ranks_l2r)
