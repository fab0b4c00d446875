"""MSNEA in the port against the JAX package, on the CPU.

The model is built in both packages at the small geometry of
``torch_port_common.SMALL`` with ``--model_name MSNEA`` (d = 32), the JAX
params initialised through the training loss (as ``create_train_state``
does: ``fc3`` appears only there) and carried across by
``state_dict_from_flax``.  ``jax.random``'s negative triples cannot be
reproduced, so the losses are held against JAX on the same injected
triple batches; the positives, which are sequential slices, and the
cross-KG supervised triples are compared exactly, order included.

Tolerances: the loss and both aux terms rel 1e-5; each parameter's
gradient max |err| <= 1e-4 x max |JAX| of that tensor; three AdamW steps:
losses rel 1e-4, parameters atol 1e-5; ``joint_emb`` rtol = atol = 1e-5;
a killed and resumed run equals the uninterrupted one bit for bit.
"""

import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from snag_tpu.data.dataset import _generate_sup_triples as jax_sup_triples
from snag_tpu.data.dataset import load_data as jax_load_data
from snag_tpu.models import build_model as jax_build_model
from snag_tpu.models.encoder import prepare_features as jax_features
from snag_tpu.models.msnea import MSNEA as JaxMSNEA
from snag_tpu.models.msnea import TripleBank as JaxTripleBank
from snag_tpu.models.msnea import contrastive_loss as jax_contrastive
from snag_tpu.models.msnea import sample_triple_batch as jax_sample
from snag_tpu.train.optim import build_optimizer as jax_build_optimizer
from snag_tpu_torch.cli.train_mmea import main as port_main
from snag_tpu_torch.config import (build_argparser, config_from_args,
                                   finalize_config)
from snag_tpu_torch.data.dataset import _generate_sup_triples, load_data
from snag_tpu_torch.models import build_model
from snag_tpu_torch.models.encoder import place_features
from snag_tpu_torch.models.msnea import (MSNEA, TripleBank, contrastive_loss,
                                         sample_triple_batch)
from snag_tpu_torch.ops.noise import generator
from snag_tpu_torch.train.runner import Runner
from snag_tpu_torch.train.step import TrainStep
from snag_tpu_torch.utils.checkpoint import CHECKPOINT_NAME
from snag_tpu_torch.utils.import_reference import state_dict_from_flax
from snag_tpu_torch.utils.logging import get_dump_path
from torch_port_common import configs, padded_batch, single_thread, small_argv

single_thread()
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4         # x max |JAX| of each tensor
B = 24
NEG = 2                 # --neg_triple_num


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    cache = {}

    def get(use_surface=0):
        if use_surface not in cache:
            cache[use_surface] = _pair(
                str(tmp_path_factory.mktemp(f"msnea{use_surface}")),
                use_surface)
        return cache[use_surface]
    return get


def _pair(root, use_surface):
    jcfg, tcfg = configs(root, model_name="MSNEA", use_surface=use_surface,
                         neg_triple_num=NEG, lr=5e-4, scheduler="cos",
                         margin=1.0)
    jdata, tdata = jax_load_data(jcfg), load_data(tcfg)
    jmodel = jax_build_model(jcfg, jdata)
    jfeats = jax_features(jcfg, jdata)
    z = jnp.zeros((2,), jnp.int32)
    params = jax.device_get(jax.jit(lambda k: jmodel.init(
        {"params": k}, jnp.zeros((2, 2), jnp.int32), jnp.ones((2,), bool),
        jfeats, jdata.graph, pos_triples=(z, z, z), neg_triples=(z, z, z),
        deterministic=True))(jax.random.PRNGKey(jcfg.random_seed))["params"])
    tmodel = build_model(tcfg, tdata, torch.Generator().manual_seed(0))
    assert isinstance(tmodel, MSNEA)
    tmodel.load_state_dict(state_dict_from_flax(params), strict=True)
    return dict(jcfg=jcfg, jdata=jdata, jmodel=jmodel, jfeats=jfeats,
                params=params, tcfg=tcfg, tdata=tdata, tmodel=tmodel,
                tfeats=place_features(tcfg, tdata, "cpu")[0],
                tgraph=tdata.graph.to_torch("cpu"),
                jbank=JaxTripleBank.from_data(jdata),
                tbank=TripleBank.from_data(tdata, "cpu"))


def test_supervised_triples_equal_jax_in_order(pairs):
    """The cross-KG copies of both KGs' triples, the same lists in the
    same order, from the data path and from random triples."""
    pair = pairs()
    jd, td = pair["jdata"], pair["tdata"]
    n_raw = len(jd.triples)
    assert len(td.kg1_triples) + len(td.kg2_triples) > n_raw
    assert td.kg1_triples == jd.kg1_triples
    assert td.kg2_triples == jd.kg2_triples
    rng = np.random.default_rng(5)
    kg1 = [tuple(int(v) for v in t) for t in rng.integers(0, 40, (300, 3))]
    kg2 = [tuple(int(v) for v in t) for t in rng.integers(40, 80, (300, 3))]
    ill = np.stack([rng.permutation(40)[:25], 40 + rng.permutation(40)[:25]],
                   axis=1).astype(np.int32)
    assert _generate_sup_triples(ill, kg1, kg2) == jax_sup_triples(ill, kg1,
                                                                   kg2)


@pytest.mark.parametrize("step", [0, 1, 7, 33, 34, 35, 101])
def test_positive_triples_equal_jax_through_the_wrap(pairs, step):
    pair = pairs()
    bank = pair["tbank"]
    bs1 = int(bank.n1 / (bank.n1 + bank.n2) * B)
    # steps 33-35 and 101 start past the end of KG1's list and wrap
    assert (101 * bs1) // bank.n1 >= 1
    (jp, _) = jax_sample(jax.random.PRNGKey(step), pair["jbank"], B,
                         jnp.asarray(step, jnp.int32), NEG)
    (tp, _) = sample_triple_batch(generator(step, "cpu"), bank, B, step, NEG)
    for a, b in zip(tp, jp):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_negatives_corrupt_one_side_from_the_right_kg(pairs):
    pair = pairs()
    bank = pair["tbank"]
    bs1 = int(bank.n1 / (bank.n1 + bank.n2) * B)
    heads = 0
    for step in range(40):
        (ph, pr, pt), (nh, nr, nt) = sample_triple_batch(
            generator(1000 + step, "cpu"), bank, B, step, NEG)
        ph, pr, pt = (x.repeat_interleave(NEG) for x in (ph, pr, pt))
        assert nh.shape == (B * NEG,)
        assert torch.equal(nr, pr)
        kept_h, kept_t = nh == ph, nt == pt
        # one side replaced (both kept only where the drawn entity is the
        # positive's own)
        assert (kept_h | kept_t).all()
        heads += int((~kept_h).sum())
        # the new entity is of the KG whose slice the positive came from
        # (a supervised triple may hold the other KG's entity elsewhere)
        for sl, ents in ((slice(0, bs1 * NEG), bank.ents1),
                         (slice(bs1 * NEG, None), bank.ents2)):
            drawn = torch.where(kept_h[sl], nt[sl], nh[sl])
            assert torch.isin(drawn[~(kept_h & kept_t)[sl]], ents).all()
    # a head is corrupted w.p. 0.5 (a tail otherwise); 40 x 48 draws
    assert 0.42 < heads / (40 * B * NEG) < 0.55


def _triples(pair, step):
    """An injected triple batch as numpy (the port's sampler's)."""
    pos, neg = sample_triple_batch(generator(77 + step, "cpu"), pair["tbank"],
                                   B, step, NEG)
    return tuple(x.numpy() for x in pos), tuple(x.numpy() for x in neg)


def _batches(pair):
    return [padded_batch(pair["tdata"].train_ill[k:], B, n)
            for k, n in ((0, B), (5, B), (11, 17))]


def _jax_loss(pair):
    model = pair["jmodel"]

    def f(q, links, valid, pos, neg):
        return model.apply({"params": q}, links, valid, pair["jfeats"],
                           pair["jdata"].graph, pos_triples=pos,
                           neg_triples=neg, deterministic=False)
    return f


def _t(arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _j(arrays):
    return tuple(jnp.asarray(a) for a in arrays)


@pytest.mark.parametrize("use_surface", [0, 1])
@pytest.mark.parametrize("which", [0, 2])
def test_loss_aux_and_grads_match_jax(pairs, use_surface, which):
    """The loss, ``kge`` and ``align`` and every gradient on a full (0)
    and the padded (2) batch; with ``--use_surface 1`` name and char join
    the fusion."""
    pair = pairs(use_surface)
    links, valid = _batches(pair)[which]
    pos, neg = _triples(pair, which)
    params = jax.tree_util.tree_map(jnp.asarray, pair["params"])
    (want, want_aux), want_g = jax.jit(jax.value_and_grad(
        _jax_loss(pair), has_aux=True))(params, jnp.asarray(links),
                                        jnp.asarray(valid), _j(pos), _j(neg))
    model = pair["tmodel"]
    model.zero_grad(set_to_none=True)
    loss, aux = model(torch.from_numpy(links), torch.from_numpy(valid),
                      pair["tfeats"], pair["tgraph"], pos_triples=_t(pos),
                      neg_triples=_t(neg))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=LOSS_RTOL)
    assert set(aux) == set(want_aux) == {"kge", "align"}
    for k, v in aux.items():
        np.testing.assert_allclose(v.item(), float(want_aux[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    want_sd = state_dict_from_flax(jax.device_get(want_g))
    named = dict(model.named_parameters())
    assert set(want_sd) == set(named)
    assert ("name_fc.weight" in named) == bool(use_surface)
    for k, p in named.items():
        scale = want_sd[k].abs().max().item()
        err = (p.grad - want_sd[k]).abs().max().item()
        assert err <= GRAD_TOL * scale, (k, err, scale)


def test_contrastive_loss_matches_jax():
    rng = np.random.default_rng(3)
    dis = rng.normal(size=(9, 9)).astype(np.float32)
    label = np.eye(9, dtype=np.float32)
    valid = np.arange(9) < 6
    for v in (None, valid):
        got = contrastive_loss(torch.from_numpy(dis), torch.from_numpy(label),
                               None if v is None else torch.from_numpy(v))
        want = jax_contrastive(jnp.asarray(dis), jnp.asarray(label),
                               None if v is None else jnp.asarray(v))
        np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL)


def test_three_optimizer_steps_match_jax(pairs):
    """JAX's value_and_grad + build_optimizer (one AdamW group) against the
    port's TrainStep, on the same batches and injected triples."""
    pair = pairs()
    total, warmup = 20, 3
    jcfg = pair["jcfg"]
    params = jax.tree_util.tree_map(jnp.asarray, pair["params"])
    tx, _ = jax_build_optimizer(jcfg, params, total, warmup)
    opt_state = tx.init(params)
    loss_fn = _jax_loss(pair)

    @jax.jit
    def jstep(p, s, links, valid, pos, neg):
        (loss, _), g = jax.value_and_grad(loss_fn, has_aux=True)(
            p, links, valid, pos, neg)
        upd, s = tx.update(g, s, p)
        return optax.apply_updates(p, upd), s, loss

    tmodel = build_model(pair["tcfg"], pair["tdata"], torch.Generator())
    tmodel.load_state_dict(state_dict_from_flax(pair["params"]))
    step = TrainStep(pair["tcfg"], tmodel, pair["tcfg"].lr, total, warmup)
    want, got = [], []
    for i, (links, valid) in enumerate(_batches(pair)):
        pos, neg = _triples(pair, i)
        params, opt_state, loss = jstep(params, opt_state, jnp.asarray(links),
                                        jnp.asarray(valid), _j(pos), _j(neg))
        want.append(float(loss))
        got.append(step(torch.from_numpy(links), torch.from_numpy(valid),
                        pair["tfeats"], pair["tgraph"], 0,
                        pos_triples=_t(pos), neg_triples=_t(neg))[0].item())
    assert step.count == 3
    np.testing.assert_allclose(got, want, rtol=1e-4)
    want_sd = state_dict_from_flax(jax.device_get(params))
    for k, p in tmodel.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want_sd[k].numpy(), atol=1e-5,
                                   err_msg=k)


def test_joint_emb_matches_jax(pairs):
    pair = pairs(1)
    want, want_w = pair["jmodel"].apply(
        {"params": jax.tree_util.tree_map(jnp.asarray, pair["params"])},
        pair["jfeats"], pair["jdata"].graph, method=JaxMSNEA.joint_emb)
    with torch.no_grad():
        got, w = pair["tmodel"].joint_emb(pair["tfeats"], pair["tgraph"])
    assert w is None and want_w is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


class Killed(Exception):
    pass


TRAIN = dict(model_name="MSNEA", epoch=8, eval_epoch=2, batch_size=16,
             lr=2e-3, scheduler="cos", neg_triple_num=NEG,
             checkpoint_every=3, save_model=1)


def test_killed_and_resumed_msnea_run_equals_uninterrupted(tmp_path,
                                                           monkeypatch):
    """Killed after epoch 5's checkpoint and resumed: every parameter, the
    AdamW state, the step count and the final ranks equal the
    uninterrupted run's; the saved ``.pkl`` serves the same ranks."""
    full = port_main(small_argv(tmp_path / "full", **TRAIN))
    assert full.train_step.count == 8 * full._steps_per_epoch() > 8
    argv = small_argv(tmp_path / "kill", **TRAIN)
    train_epoch = Runner.train_epoch

    def killing(self):
        if self.epoch == 6:
            raise Killed
        return train_epoch(self)

    monkeypatch.setattr(Runner, "train_epoch", killing)
    with pytest.raises(Killed):
        port_main(argv)
    monkeypatch.setattr(Runner, "train_epoch", train_epoch)
    cfg = full.cfg
    ckpt = osp.join(get_dump_path(finalize_config(config_from_args(
        build_argparser().parse_args(argv)))), CHECKPOINT_NAME)
    assert torch.load(ckpt, weights_only=True)["epoch"] == 5
    resumed = port_main(argv + ["--resume_from", ckpt])
    a, b = resumed.model.state_dict(), full.model.state_dict()
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    sa = resumed.train_step.opt.state_dict()["state"]
    sb = full.train_step.opt.state_dict()["state"]
    for i in sb:
        for k in sb[i]:
            assert torch.equal(sa[i][k], sb[i][k]), (i, k)
    assert resumed.train_step.count == full.train_step.count
    assert resumed.loss_log.loss == full.loss_log.loss
    np.testing.assert_array_equal(resumed.last_result.ranks_l2r,
                                  full.last_result.ranks_l2r)
    res = full.last_result
    assert all(0.0 <= v <= 1.0 for v in (*res.acc_l2r, res.mrr_l2r))
    served = port_main(small_argv(tmp_path / "full", only_test=1,
                                  model_name="MSNEA",
                                  model_name_save=cfg.exp_id))
    np.testing.assert_array_equal(served.last_result.ranks_l2r, res.ranks_l2r)
