"""Port training pieces vs the JAX package: optimizer groups and LR
schedules, three optimizer steps, IL mining and promotion, noise, and a
CPU training run through the CLI.

Tolerances: parameters after three AdamW steps atol = 1e-5 (f32 gradients
that differ in the last digits, through Adam's normalisation), losses
rtol = 1e-4; LR values rtol = 1e-6, atol = 1e-10 (float64 here, float32
there, whose cosine is coarse near zero); mining and promotion exactly;
noise statistics within a few standard errors.

The optimizer steps run with all six modalities active.  With four, the
two unused slots of ``weight_raw`` have a gradient that is zero in exact
arithmetic (GMI L2-normalises the joint rows, so the loss does not see
the scale of the fz weights), and Adam turns the rounding noise left in
such a gradient into an LR-sized step of either sign, in both packages.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from snag_tpu.models import build_model as jax_build_model
from snag_tpu.ops import noise as jax_noise
from snag_tpu.train import il as jax_il
from snag_tpu.train.optim import _snag_label_tree
from snag_tpu.train.optim import build_optimizer as jax_build_optimizer
from snag_tpu.train.optim import make_lr_schedule as jax_lr_schedule
from snag_tpu.utils.logging import create_logger as jax_logger
from snag_tpu_torch.cli.train_mmea import main as port_main
from snag_tpu_torch.config import Config
from snag_tpu_torch.ops import noise
from snag_tpu_torch.train import il
from snag_tpu_torch.train.optim import make_lr_schedule, param_label
from snag_tpu_torch.train.runner import Runner
from snag_tpu_torch.train.step import TrainStep
from snag_tpu_torch.utils.import_reference import (_leaves, _ref_key_for,
                                                   state_dict_from_flax)
from snag_tpu_torch.utils.logging import create_logger
from torch_port_common import (SMALL, padded_batch, single_thread,
                               small_argv, model_pair)

single_thread()


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return model_pair(str(tmp_path_factory.mktemp("train")), fused_snag_loss=0,
                     lr=5e-4, scheduler="cos", use_surface=1)


def test_param_group_labels_match_jax(pair):
    params = dict(pair["params"])
    params["multi_loss_layer_2"] = {"params": np.ones(7, np.float32)}
    labels = _snag_label_tree(params)
    want = {_ref_key_for(path)[0]: lab for path, lab in _leaves(labels)}
    got = {name: param_label(name)
           for name, _ in pair["tmodel"].named_parameters()}
    got["multi_loss_layer_2.params"] = param_label("multi_loss_layer_2.params")
    assert got == want
    assert sorted(set(got.values())) == ["decay", "large", "no_decay"]


@pytest.mark.parametrize("accumulation_steps", [1, 3])
@pytest.mark.parametrize("scheduler", ["cos", "linear", "fixed"])
def test_lr_schedule_matches_jax(scheduler, accumulation_steps):
    """With ``--accumulation_steps k`` both schedules count optimizer
    updates over total / k and warmup / k (40 / 3 and 6 / 3 here)."""
    cfg = Config(scheduler=scheduler, accumulation_steps=accumulation_steps)
    ours = make_lr_schedule(cfg, 5e-4, 40, 6)
    theirs = jax_lr_schedule(cfg, 5e-4, 40, 6)
    got = [ours(s) for s in range(50)]
    want = [float(theirs(s)) for s in range(50)]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-10)
    if scheduler != "fixed":
        assert got[0] == 0.0          # the pre-increment step under warmup
    if scheduler == "linear":
        # the horizon ends at update int(40 / k)
        assert (got[40 // accumulation_steps] == 0.0
                and got[40 // accumulation_steps - 1] > 0.0)


def test_three_optimizer_steps_match_jax(pair):
    """From the same params and batches, noise and dropout off: JAX's
    value_and_grad + build_optimizer tx against the port's TrainStep."""
    total, warmup = 20, 3
    batches = [padded_batch(pair["tdata"].train_ill[k:], 24, n)
               for k, n in ((0, 24), (5, 24), (11, 17))]
    jcfg = pair["jcfg"]
    model = jax_build_model(jcfg, pair["jdata"])
    params = jax.tree_util.tree_map(jnp.asarray, pair["params"])
    tx, _ = jax_build_optimizer(jcfg, params, total, warmup)
    opt_state = tx.init(params)

    @jax.jit
    def jstep(p, s, links, valid):
        def f(q):
            return model.apply({"params": q}, links, valid, pair["jfeats"],
                               pair["jdata"].graph, deterministic=True)
        (loss, _), g = jax.value_and_grad(f, has_aux=True)(p)
        upd, s = tx.update(g, s, p)
        return optax.apply_updates(p, upd), s, loss

    want_losses = []
    for links, valid in batches:
        params, opt_state, loss = jstep(params, opt_state, jnp.asarray(links),
                                        jnp.asarray(valid))
        want_losses.append(float(loss))

    tcfg = dataclasses.replace(pair["tcfg"], add_noise=0)
    step = TrainStep(tcfg, pair["tmodel"], tcfg.lr, total, warmup)
    got_losses = [step(torch.from_numpy(l), torch.from_numpy(v),
                       pair["tfeats"], pair["tgraph"], epoch=0,
                       deterministic=True)[0].item() for l, v in batches]
    assert step.count == 3
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-4)
    want_sd = state_dict_from_flax(jax.device_get(params))
    for k, p in pair["tmodel"].state_dict().items():
        np.testing.assert_allclose(p.numpy(), want_sd[k].numpy(), atol=1e-5,
                                   rtol=0, err_msg=k)


def _mining_case(seed=0):
    rng = np.random.default_rng(seed)
    n, d = 90, 12
    emb = rng.normal(size=(n, d)).astype(np.float32)
    emb[60:70] = emb[20:30] + 0.05 * rng.normal(size=(10, d)).astype(np.float32)
    emb[71] = emb[70]                       # an exact tie among the right
    emb[13] = emb[22]                       # one among the left, two blocks
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    left = np.arange(0, 40)
    right = np.arange(45, 90)
    lv = rng.uniform(size=40) > 0.1
    rv = rng.uniform(size=45) > 0.1
    return emb, left, lv, right, rv


def _jax_mine(emb, left, lv, right, rv, cand, fresh):
    return np.asarray(jax_il.mine_new_links(
        jnp.asarray(emb), jnp.asarray(left, jnp.int32), jnp.asarray(lv),
        jnp.asarray(right, jnp.int32), jnp.asarray(rv),
        jnp.asarray(cand, jnp.int32), fresh))


@pytest.mark.parametrize("fresh", [True, False])
def test_mine_new_links_matches_jax_exactly(monkeypatch, fresh):
    case = _mining_case()
    # the previous round's candidates: a fresh round's, a third dropped
    cand = np.array(_jax_mine(*case, -np.ones(40, np.int64), True))
    cand[::3] = -1
    emb, left, lv, right, rv = case
    want = _jax_mine(*case, cand, fresh)
    t = [torch.as_tensor(a) for a in (emb, left, lv, right, rv, cand)]
    one_block = il.mine_new_links(*t, fresh)
    # blocks of 7 left rows: the column minima carried across six blocks
    monkeypatch.setattr(il, "MINE_CHUNK", 7)
    np.testing.assert_array_equal(one_block.numpy(), want)
    np.testing.assert_array_equal(il.mine_new_links(*t, fresh).numpy(), want)
    assert (want >= 0).any()


def test_promote_candidates_matches_jax_exactly():
    emb, left, lv, right, rv = _mining_case(seed=1)
    cand = np.where(np.arange(40) % 3 == 0, right[np.arange(40) % 45], -1)
    train = np.array([[1000, 2000], [1001, 2001]], dtype=np.int32)
    test_set = {(int(l), int(r)) for l, r in zip(left[::2], right[::2])}
    jstate = jax_il.ILState(jnp.asarray(left, jnp.int32), jnp.asarray(lv),
                            jnp.asarray(right, jnp.int32), jnp.asarray(rv),
                            jnp.asarray(cand, jnp.int32))
    js, jtrain, jn = jax_il.promote_candidates(jstate, train, test_set,
                                               jax_logger(name="il_jax"))
    tstate = il.ILState(*[torch.as_tensor(a) for a in
                          (left, lv, right, rv, cand)])
    ts, ttrain, tn = il.promote_candidates(tstate, train, test_set,
                                           create_logger(name="il_port"))
    assert tn == jn > 0
    np.testing.assert_array_equal(ttrain, jtrain)
    for f in ("left_valid", "right_valid", "cand_right"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)), err_msg=f)


def test_table_stats_exactly_and_noise_statistically():
    # integer columns that sum to zero over all 65 rows and over the 17
    # selected ones: the means are exact and the variances divide by 64 and
    # 16, so the statistics are exact in float32 whatever the sum order
    rng = np.random.default_rng(0)
    blocks = [rng.integers(-8, 9, size=(k, 6)) for k in (16, 47)]
    x = np.concatenate([np.concatenate([b, -b.sum(0, keepdims=True)])
                        for b in blocks]).astype(np.float32)
    rows = np.arange(17)
    for vr in (None, rows):
        want = jax_noise.table_stats(jnp.asarray(x), None if vr is None
                                     else jnp.asarray(vr))
        got = noise.table_stats(torch.from_numpy(x), None if vr is None
                                else torch.from_numpy(vr))
        np.testing.assert_array_equal(got.mean.numpy(), np.asarray(want.mean))
        np.testing.assert_array_equal(got.std.numpy(), np.asarray(want.std))

    # mask rate and blend: n rows, rate r -> the selected share is within
    # 4 standard errors of r, and the blended rows' noise part has the
    # table's column mean and std
    n, d, r, m = 20000, 4, 0.2, 0.7
    big = torch.from_numpy(rng.normal(2.0, 3.0, size=(n, d)).astype(np.float32))
    st = noise.table_stats(big)
    gen = noise.generator(noise.derive_seed(7, 0, 0), "cpu")
    out = noise.noise_mask_table(gen, big, st, r, m)
    hit = (out != big).any(dim=1)
    assert abs(hit.float().mean().item() - r) < 4 * np.sqrt(r * (1 - r) / n)
    eps = (out[hit] - (1 - m) * big[hit]) / m
    se = st.std / np.sqrt(int(hit.sum()))
    assert torch.all((eps.mean(0) - st.mean).abs() < 4 * se)
    assert torch.all((eps.std(0) / st.std - 1).abs() < 0.05)
    # entity noise: half rates
    ent = noise.entity_noise(noise.generator(1, "cpu"), big, r, m)
    hit = (ent != big).any(dim=1).float().mean().item()
    assert abs(hit - r / 2) < 4 * np.sqrt(r / 2 * (1 - r / 2) / n)
    # dropout keeps 1 - rate and rescales
    keep = noise.dropout(torch.ones(n, d), 0.1, noise.generator(2, "cpu"))
    assert abs((keep > 0).float().mean().item() - 0.9) < 0.01
    assert torch.all((keep == 0) | ((keep - 1 / 0.9).abs() < 1e-6))


def test_cpu_train_mmea_run_with_il_promotion(tmp_path):
    """``train_mmea`` without ``--only_test`` on the CPU (twins): two
    stages, mining, promotion at epoch 9, best reload, final test."""
    runner = port_main(small_argv(
        tmp_path, epoch=12, il="", il_start=2, semi_learn_step=1,
        eval_epoch=4, batch_size=32, lr=5e-4, scheduler="cos", add_noise=1,
        noise_ratio=0.2, mask_ratio=0.7, fused_snag_loss=0))
    losses = runner.loss_log.loss[1:]
    assert len(losses) == 12 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    assert runner.stage == 1 and runner.promoted and runner.promoted[0] > 0
    assert len(runner.train_ill) > len(runner.data.train_ill)
    res = runner.last_result
    for v in (*res.acc_l2r, *res.acc_r2l, res.mrr_l2r, res.mrr_r2l):
        assert 0.0 <= v <= 1.0
    with open(runner.pred_path) as f:
        assert len(f.readlines()) == len(runner.test_left) + 1


@pytest.mark.parametrize("flag,value", [("save_model", 1),
                                        ("checkpoint_every", 2),
                                        ("resume_from", "x.msgpack")])
def test_checkpoint_flags_raise(tmp_path, flag, value):
    """The checkpoint flags are ported (tests/test_torch_resume.py): the
    runner takes ``--save_model`` and ``--checkpoint_every``, and
    ``--resume_from`` raises only for want of its file."""
    from snag_tpu_torch.config import finalize_config
    cfg = finalize_config(Config(device="cpu", **SMALL, **{flag: value}),
                          data_root=str(tmp_path))
    if flag == "resume_from":
        with pytest.raises(FileNotFoundError):
            Runner(cfg, create_logger(name="flags"))
    else:
        assert getattr(Runner(cfg, create_logger(name="flags")).cfg,
                       flag) == value
