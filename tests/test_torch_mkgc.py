"""MKGC in the port against the JAX package, on the CPU.

At the small geometry of ``tests/test_mkgc.py::_cfg`` (80 synthetic
entities, ``emb_dim`` 32, one fusion layer of two heads):

* data, bit for bit: SYNTH in both branches (TransE-shaped, and random
  triples above 2e8 entity-entity-relation slots), on-disk files the test
  writes (``hrt`` tab files with names, id maps present and absent, the
  OpenKE ``*2id`` ``htr`` layout, pickles with partial coverage and both
  key kinds), a missing pickle raising unless
  ``--allow_missing_features 1``, the filter dicts, ``avg_pool_features``;
* the model, JAX params carried across by ``state_dict_from_flax``,
  dropout off, every ``joint_way`` x ``num_proj``: joints rtol = atol =
  1e-5; the loss rel 1e-4 and each gradient max |err| <= 1e-4 x max |JAX|
  of that tensor on injected corruptions, in both ``ALL_ENT_FUSION``
  branches.  Two biases have an exact gradient of zero (a shift that
  every softmax they feed ignores: the attention key bias and the
  ``atten_weight`` gate's bias); both sides must give them no more than
  1e-6 x the largest |JAX| gradient of the model;
* three Adam steps on injected samples against optax's two-group Adam at
  ``scripts/run_base.sh``'s LR = LRG = 1e-4: losses rel 1e-4, params atol
  1e-5; the optimizer groups equal JAX's labels name for name;
* filtered ranks against JAX's on the same params: equal on >= 99.9 % of
  the triples in each direction, MRR and Hits within 1e-3;
* the random paths in distribution (``jax.random``'s streams cannot be
  reproduced): each triple once an epoch with the tail dropped, the share
  of noised rows and of corrupted heads within 4 sigma of their rates,
  noised rows on the blend formula;
* the runner: a resume equal bit for bit to an uninterrupted run,
  ``--save_model`` then ``--only_test`` with the same metrics,
  ``--only_test`` without params raising, the JAX test's learning bound
  (test MRR > 0.15), the CLI on ``--device cpu``, ``--mesh_shape data:2``
  in a process of no group and a missing card raising, and the port
  importing with ``jax`` blocked.
"""

import dataclasses
import os
import os.path as osp
import pickle
import re
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from snag_tpu.mkgc import model as jax_model_mod
from snag_tpu.mkgc.config import JOINT_WAYS
from snag_tpu.mkgc.config import MKGCConfig as JaxConfig
from snag_tpu.mkgc.data import load_mkgc_data as jax_load
from snag_tpu.mkgc.model import MKGCModel as JaxModel
from snag_tpu.mkgc.model import avg_pool_features as jax_pool
from snag_tpu.mkgc.train import _fusion_label_tree
from snag_tpu.mkgc.train import _padded_filters as jax_padded_filters
from snag_tpu.mkgc.train import build_mkgc_optimizer as jax_optimizer
from snag_tpu.mkgc.train import filtered_ranks as jax_filtered_ranks
from snag_tpu.mkgc.train import prepare_mkgc_features as jax_features
from snag_tpu.ops import noise as jax_noise
from snag_tpu_torch.cli.train_mkgc import main as port_main
from snag_tpu_torch.mkgc import model as port_model_mod
from snag_tpu_torch.mkgc.config import MKGCConfig, build_mkgc_argparser
from snag_tpu_torch.mkgc.data import load_mkgc_data
from snag_tpu_torch.mkgc.model import MKGCModel, avg_pool_features
from snag_tpu_torch.mkgc.train import (MKGCRunner, MKGCStep, _padded_filters,
                                       epoch_batches, filtered_ranks,
                                       noisy_features, param_group,
                                       place_mkgc_features, summarize_lp)
from snag_tpu_torch.ops.noise import generator
from snag_tpu_torch.utils.checkpoint import save_mkgc_checkpoint
from snag_tpu_torch.utils.import_reference import (_leaves, _ref_key_for,
                                                   state_dict_from_flax)
from snag_tpu_torch.utils.logging import create_logger
from torch_port_common import single_thread

single_thread()
B, K = 16, 8                # injected batch: triples, corruptions each
GRAD_TOL = 1e-4             # x max |JAX| of each tensor
ZERO_GRAD_TOL = 1e-6        # x max |JAX| over the model
ZERO_GRAD = ("attention.self.key.bias", "gate.bias")
SMALL = dict(data_choice="SYNTH", emb_dim=32, num_batch=8, neg_num=K,
             margin=1.0, lr=5e-3, lrg=5e-3, epoch=4, eval_epoch=100,
             add_noise=1, noise_ratio=0.2, mask_ratio=0.5, use_pool=1,
             pool_dim=32, num_hidden_layers=1, num_attention_heads=2,
             synth_ents=80, synth_rels=8, synth_triples=600,
             random_seed=7, log_every=1000)
CONFIGS = [(jw, n) for jw in JOINT_WAYS for n in (1, 2)]


def _cfgs(**kw):
    """(JAX config, port config on the CPU) of the same fields."""
    fields = {**SMALL, **kw}
    return JaxConfig(**fields), MKGCConfig(device="cpu", **fields)


def _logger(name):
    return create_logger(name=f"test_torch_mkgc.{name}")


def _assert_data_equal(jd, td):
    assert (jd.ent_num, jd.rel_num) == (td.ent_num, td.rel_num)
    for name in ("train", "valid", "test", "visual", "textual"):
        a, b = getattr(jd, name), getattr(td, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert jd.ent_wo_visual == td.ent_wo_visual
    assert jd.hr_to_t == td.hr_to_t and jd.rt_to_h == td.rt_to_h
    assert list(jd.hr_to_t) == list(td.hr_to_t)


@pytest.fixture(scope="module")
def data():
    return load_mkgc_data(_cfgs()[1])


# ------------------------------------------------------------------ data

@pytest.mark.parametrize("branch", ["transe", "random"])
def test_synthetic_data_equals_jax_bitwise(branch):
    # the random branch above e * e * r = 2e8 (train.py's benchmark scale)
    kw = ({} if branch == "transe" else
          dict(synth_ents=2000, synth_rels=51, synth_triples=3000,
               synth_vis_dim=24, synth_txt_dim=20))
    jc, tc = _cfgs(**kw)
    assert (tc.synth_ents ** 2 * tc.synth_rels > 2e8) == (branch == "random")
    _assert_data_equal(jax_load(jc), load_mkgc_data(tc))


def _names(rows):
    return "".join(f"e{h}\tr{r}\te{t}\n" for h, r, t in rows)


def _write_dataset(root, layout):
    """A small MMKG dump in one of the loader's layouts; returns the
    config overrides that read it."""
    rng = np.random.default_rng(11)
    n_e, n_r = 40, 5
    tri = np.stack([rng.integers(0, n_e, 120), rng.integers(0, n_r, 120),
                    rng.integers(0, n_e, 120)], axis=1)
    d = osp.join(root, layout)
    os.makedirs(d)
    splits = {"train": tri[:90], "valid": tri[90:105], "test": tri[105:]}

    def write(name, text):
        with open(osp.join(d, name), "w", encoding="utf-8") as f:
            f.write(text)

    def pkl(name, obj):
        with open(osp.join(d, name), "wb") as f:
            pickle.dump(obj, f)

    kw = dict(data_choice=layout, data_path=root)
    if layout == "hrt_names":
        # no id maps; visual keyed by name (a stray name skipped, a
        # quarter of the entities missing), textual by int id
        for s, rows in splits.items():
            write(f"{s}.txt", _names(rows))
        vis = {f"e{i}": rng.normal(size=12) for i in range(n_e) if i % 4}
        vis["not_an_entity"] = rng.normal(size=12)
        pkl("visual.pkl", vis)
        pkl("textual.pkl", {i: rng.normal(size=(1, 9)) for i in range(0, 30)})
    elif layout == "id_maps_tsv":
        # name -> id maps in a shuffled order, .tsv triples, the pickles
        # under <DATASET>_*.pkl; one map with id first
        perm = rng.permutation(n_e)
        write("entity2id.txt", "".join(f"e{i}\t{perm[i]}\n"
                                       for i in range(n_e)))
        write("relation2id.txt", "".join(f"{j}\tr{j}\n" for j in range(n_r)))
        for s, rows in splits.items():
            write(f"{s}.tsv", _names(rows))
        pkl(f"{layout}_visual.pkl",
            {f"e{i}": rng.normal(size=7) for i in range(n_e) if i % 3})
        pkl(f"{layout}_textual.pkl",
            {f"e{i}": rng.normal(size=5) for i in range(n_e)})
    elif layout == "openke":
        # OpenKE: train2id.txt with a count line, "h t r" by whitespace
        for s, rows in splits.items():
            write(f"{s}2id.txt", f"{len(rows)}\n" + "".join(
                f"{h} {t} {r}\n" for h, r, t in rows))
        pkl("visual.pkl", {i: rng.normal(size=6) for i in range(n_e) if i % 5})
        pkl("textual.pkl", {i: rng.normal(size=4) for i in range(n_e)})
    elif layout == "htr_tab":
        # --triple_order htr on plain tab files
        for s, rows in splits.items():
            write(f"{s}.txt", "".join(f"e{h}\te{t}\tr{r}\n"
                                      for h, r, t in rows))
        pkl("visual.pkl", {f"e{i}": rng.normal(size=6) for i in range(n_e)
                           if i % 6})
        pkl("textual.pkl", {f"e{i}": rng.normal(size=6) for i in range(n_e)
                            if i % 2})
        kw["triple_order"] = "htr"
    else:       # no pickle at all: triples only
        for s, rows in splits.items():
            write(f"{s}.txt", _names(rows))
        kw["allow_missing_features"] = 1
    return kw


@pytest.mark.parametrize("layout", ["hrt_names", "id_maps_tsv", "openke",
                                    "htr_tab", "triples_only"])
def test_files_equal_jax_bitwise(tmp_path, layout):
    kw = _write_dataset(str(tmp_path), layout)
    jc, tc = _cfgs(**kw)
    jd, td = jax_load(jc), load_mkgc_data(tc)
    _assert_data_equal(jd, td)
    assert len(td.train) == 90 and td.visual.shape[0] == td.ent_num
    if layout != "triples_only":
        assert 0 < len(td.ent_wo_visual) < td.ent_num


def test_missing_pickle_raises_unless_allowed(tmp_path):
    kw = _write_dataset(str(tmp_path), "triples_only")
    kw["allow_missing_features"] = 0
    with pytest.raises(FileNotFoundError, match="allow_missing_features"):
        load_mkgc_data(_cfgs(**kw)[1])


def test_avg_pool_equals_jax_bitwise():
    rng = np.random.default_rng(3)
    for d, out in ((20, 32), (64, 32), (70, 32), (4096, 256), (768, 256)):
        x = rng.normal(size=(9, d)).astype(np.float32)
        got = avg_pool_features(x, out)
        np.testing.assert_array_equal(got, jax_pool(x, out))
        assert got.dtype == np.float32 and got.shape[1] == min(d, out)


# ----------------------------------------------------------------- model

def _injected(data, seed=0, b=B):
    rng = np.random.default_rng(seed)
    return (data.train[:b].astype(np.int64),
            rng.integers(0, data.ent_num, (b, K)),
            rng.random((b, K)) < 0.5)


_JAX_SIDE = {}


def _jax_side(data, joint_way, num_proj):
    """JAX params (numpy), both roles' joints and the loss and gradients
    of both ALL_ENT_FUSION branches on the injected batch, from one jit."""
    key = (joint_way, num_proj)
    if key in _JAX_SIDE:
        return _JAX_SIDE[key]
    jc, _ = _cfgs(joint_way=joint_way, num_proj=num_proj)
    feats = jax_features(jc, data)
    model = JaxModel(cfg=jc, ent_num=data.ent_num, rel_num=data.rel_num,
                     vis_dim=int(feats.visual.shape[1]),
                     txt_dim=int(feats.textual.shape[1]))
    pos, rand_ent, corrupt_head = map(jnp.asarray, _injected(data))
    pos = pos.astype(jnp.int32)

    def run(k):
        params = model.init({"params": k}, pos, rand_ent, corrupt_head,
                            feats, deterministic=True)["params"]
        joints = [model.apply({"params": params}, feats, role=r,
                              method=JaxModel.all_joint) for r in (0, 1)]
        out = {}
        for branch in ("on", "off"):
            # read at trace time: each apply traces its own branch
            jax_model_mod.ALL_ENT_FUSION = branch
            out[branch] = jax.value_and_grad(
                lambda p: model.apply({"params": p}, pos, rand_ent,
                                      corrupt_head, feats,
                                      deterministic=True)[0])(params)
        return params, joints, out

    try:
        side = jax.device_get(jax.jit(run)(jax.random.PRNGKey(5)))
    finally:
        jax_model_mod.ALL_ENT_FUSION = "auto"
    _JAX_SIDE[key] = side
    return side


def _port_model(data, params, **kw):
    _, tc = _cfgs(**kw)
    feats, _ = place_mkgc_features(tc, data, "cpu")
    model = MKGCModel(tc, data.ent_num, data.rel_num,
                      int(feats.visual.shape[1]), int(feats.textual.shape[1]),
                      torch.Generator().manual_seed(0))
    model.load_state_dict(state_dict_from_flax(params), strict=True)
    return tc, model, feats


@pytest.mark.parametrize("joint_way,num_proj", CONFIGS)
def test_model_matches_jax(data, monkeypatch, joint_way, num_proj):
    params, joints, out = _jax_side(data, joint_way, num_proj)
    _, model, feats = _port_model(data, params, joint_way=joint_way,
                                  num_proj=num_proj)
    with torch.no_grad():
        for role in (0, 1):
            torch.testing.assert_close(
                model.all_joint(feats, role),
                torch.tensor(np.asarray(joints[role])),
                rtol=1e-5, atol=1e-5)
    pos, rand_ent, corrupt_head = map(torch.as_tensor, _injected(data))
    mixed_calls = []
    joint_mixed = MKGCModel.joint_mixed
    monkeypatch.setattr(MKGCModel, "joint_mixed", lambda *a, **k: (
        mixed_calls.append(1), joint_mixed(*a, **k))[1])
    for branch in ("on", "off"):
        monkeypatch.setattr(port_model_mod, "ALL_ENT_FUSION", branch)
        jloss, jgrads = out[branch]
        want = state_dict_from_flax(jgrads)
        model.zero_grad(set_to_none=True)
        mixed_calls.clear()
        loss, _ = model(pos, rand_ent, corrupt_head, feats)
        loss.backward()
        assert len(mixed_calls) == (branch == "off")
        assert abs(loss.item() - float(jloss)) <= 1e-4 * abs(float(jloss))
        scale = max(g.abs().max().item() for g in want.values())
        for name, p in model.named_parameters():
            got = torch.zeros_like(p) if p.grad is None else p.grad
            err = (got - want[name]).abs().max().item()
            if name.endswith(ZERO_GRAD):
                limit = ZERO_GRAD_TOL * scale
                assert got.abs().max().item() <= limit, (branch, name)
                assert want[name].abs().max().item() <= limit, (branch, name)
            else:
                limit = GRAD_TOL * want[name].abs().max().item()
                assert err <= limit, (branch, name, err, limit)


def test_optimizer_groups_match_jax_labels(data):
    for joint_way, num_proj in (("Mformer_hd_graph", 2), ("atten_weight", 1),
                                ("learnable_weight", 1)):
        params = _jax_side(data, joint_way, num_proj)[0]
        labels = dict(_leaves(_fusion_label_tree(params)))
        ours = {_ref_key_for(path)[0]: label
                for path, label in labels.items()}
        _, model, _ = _port_model(data, params, joint_way=joint_way,
                                  num_proj=num_proj)
        assert ours == {name: param_group(name)
                        for name, _ in model.named_parameters()}
        assert set(ours.values()) == {"main", "fusion"}


@pytest.mark.parametrize("joint_way,num_proj,branch",
                         [("Mformer_hd_graph", 2, "on"),
                          ("learnable_weight", 1, "off")])
def test_three_adam_steps_match_optax(data, monkeypatch, joint_way, num_proj,
                                      branch):
    kw = dict(joint_way=joint_way, num_proj=num_proj, lr=1e-4, lrg=1e-4)
    jc, _ = _cfgs(**kw)
    params = _jax_side(data, joint_way, num_proj)[0]
    tc, model, feats = _port_model(data, params, **kw)
    jfeats = jax_features(jc, data)
    jmodel = JaxModel(cfg=jc, ent_num=data.ent_num, rel_num=data.rel_num,
                      vis_dim=int(jfeats.visual.shape[1]),
                      txt_dim=int(jfeats.textual.shape[1]))
    tx = jax_optimizer(jc, params)
    monkeypatch.setattr(jax_model_mod, "ALL_ENT_FUSION", branch)
    monkeypatch.setattr(port_model_mod, "ALL_ENT_FUSION", branch)

    @jax.jit
    def jstep(p, opt, pos, rand_ent, corrupt_head):
        loss, g = jax.value_and_grad(lambda q: jmodel.apply(
            {"params": q}, pos, rand_ent, corrupt_head, jfeats,
            deterministic=True)[0])(p)
        upd, opt = tx.update(g, opt, p)
        return optax.apply_updates(p, upd), opt, loss

    step = MKGCStep(tc, model)
    p, opt = params, tx.init(params)
    for s in range(3):
        pos, rand_ent, corrupt_head = _injected(data, seed=s)
        p, opt, jloss = jstep(p, opt, pos.astype(np.int32), rand_ent,
                              corrupt_head)
        loss, _ = step(torch.as_tensor(pos), feats,
                       samples=(torch.as_tensor(rand_ent),
                                torch.as_tensor(corrupt_head)),
                       deterministic=True)
        assert abs(loss.item() - float(jloss)) <= 1e-4 * abs(float(jloss))
    want = state_dict_from_flax(jax.device_get(p))
    for name, q in model.state_dict().items():
        torch.testing.assert_close(q, want[name], rtol=0, atol=1e-5,
                                   msg=name)
    assert step.count == 3


def test_filtered_ranks_match_jax(data):
    jc, tc = _cfgs(joint_way="Mformer_hd_graph", num_proj=2)
    params = _jax_side(data, "Mformer_hd_graph", 2)[0]
    _, model, feats = _port_model(data, params, joint_way="Mformer_hd_graph",
                                  num_proj=2)
    jfeats = jax_features(jc, data)
    jmodel = JaxModel(cfg=jc, ent_num=data.ent_num, rel_num=data.rel_num,
                      vis_dim=int(jfeats.visual.shape[1]),
                      txt_dim=int(jfeats.textual.shape[1]))
    triples = np.concatenate([data.train, data.valid, data.test])
    for direction in ("tail", "head"):
        for a, b in zip(_padded_filters(data, triples, direction),
                        jax_padded_filters(data, triples, direction)):
            np.testing.assert_array_equal(a, b)
    want = jax_filtered_ranks(jc, jmodel, params, jfeats, data, triples)
    cache = {}
    got = filtered_ranks(model, feats, data, triples, filter_cache=cache)
    assert got.shape == want.shape == (2 * len(triples),)
    n = len(triples)
    for sl in (slice(0, n), slice(n, 2 * n)):
        assert np.mean(got[sl] == want[sl]) >= 0.999
    ours, theirs = summarize_lp(got), summarize_lp(want)
    for k in ("mrr", "hits1", "hits3", "hits10"):
        assert abs(ours[k] - theirs[k]) <= 1e-3, k
    # the cached packs give the same ranks
    np.testing.assert_array_equal(
        filtered_ranks(model, feats, data, triples, filter_cache=cache), got)


# ---------------------------------------------------------- random paths

def _within(count, n, rate, sigmas=4.0):
    return abs(count - n * rate) <= sigmas * np.sqrt(n * rate * (1 - rate))


def test_epoch_visits_each_triple_once_and_drops_the_tail():
    _, tc = _cfgs()
    n, batch = 103, 10
    triples = torch.stack([torch.arange(n), torch.arange(n) % 7,
                           torch.arange(n)], dim=1)
    orders = []
    for epoch in (0, 1):
        b = epoch_batches(tc, triples, epoch, batch)
        assert b.shape == (n // batch, batch, 3)
        ids = b[:, :, 0].reshape(-1)
        assert len(set(ids.tolist())) == (n // batch) * batch
        torch.testing.assert_close(b.reshape(-1, 3), triples[ids])
        orders.append(ids)
        torch.testing.assert_close(epoch_batches(tc, triples, epoch, batch), b)
    assert not torch.equal(orders[0], orders[1])


def test_corruption_draws_match_their_rates(data):
    _, tc = _cfgs(neg_num=32)
    step = MKGCStep(tc, MKGCModel(tc, data.ent_num, data.rel_num, 32, 32,
                                  torch.Generator().manual_seed(0)))
    rand_ent, corrupt_head = step.sample(1000, "cpu")
    n = corrupt_head.numel()
    assert rand_ent.shape == corrupt_head.shape == (1000, 32)
    assert _within(int(corrupt_head.sum()), n, 0.5)
    counts = torch.bincount(rand_ent.reshape(-1), minlength=data.ent_num)
    assert counts.shape == (data.ent_num,)
    assert all(_within(int(c), n, 1 / data.ent_num) for c in counts)
    step.count = 1
    assert not torch.equal(step.sample(1000, "cpu")[0], rand_ent)


def test_noise_rows_follow_the_blend_formula(data):
    _, tc = _cfgs(noise_ratio=0.2, mask_ratio=0.7)
    rng = np.random.default_rng(4)
    e = 4000
    big = dataclasses.replace(
        data, ent_num=e, ent_wo_visual=list(range(0, e, 10)),
        visual=rng.normal(2.0, 3.0, (e, 8)).astype(np.float32),
        textual=rng.normal(-1.0, 0.5, (e, 6)).astype(np.float32))
    feats, stats = place_mkgc_features(tc, big, "cpu")
    # the visual statistics cover the entities with an image only
    w_vis = np.setdiff1d(np.arange(e), big.ent_wo_visual)
    jstats = jax_noise.table_stats(jnp.asarray(feats.visual.numpy()),
                                   jnp.asarray(w_vis))
    for got, want in zip(stats[0], jstats):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    noisy = noisy_features(tc, generator(123, "cpu"), feats, stats)
    for x, y, st in zip(feats, noisy, stats):
        changed = (x != y).any(dim=1)
        assert _within(int(changed.sum()), e, tc.noise_ratio)
        torch.testing.assert_close(y[~changed], x[~changed], rtol=0, atol=0)
        m = tc.mask_ratio
        eps = (((y[changed] - (1 - m) * x[changed]) / m - st.mean)
               / st.std).double()
        n = eps.numel()
        assert abs(eps.mean().item()) <= 4 / np.sqrt(n)
        assert abs(eps.std().item() - 1.0) <= 4 / np.sqrt(2 * n)


# ----------------------------------------------------------------- runner

def _runner(data, **kw):
    return MKGCRunner(_cfgs(**kw)[1], _logger("runner"), data=data)


def test_resumed_run_equals_uninterrupted_bitwise(data, tmp_path):
    kw = dict(epoch=6, eval_epoch=2, checkpoint_every=3, data_path=str(tmp_path),
              early_stop_patience=10)
    first = _runner(data, epoch=3, checkpoint_dir=str(tmp_path / "a"),
                    **{k: v for k, v in kw.items() if k != "epoch"})
    first.run()
    ckpt = str(tmp_path / "epoch2.pt")
    shutil.copy(first.checkpoint_path(), ckpt)
    whole = _runner(data, checkpoint_dir=str(tmp_path / "b"), **kw)
    m_whole = whole.run()
    resumed = _runner(data, checkpoint_dir=str(tmp_path / "c"),
                      resume_from=ckpt, **kw)
    assert resumed.start_epoch == 3 and resumed.step.count == first.step.count
    assert resumed.best_mrr == first.best_mrr > 0
    m_resumed = resumed.run()
    assert m_resumed == m_whole and resumed.losses == whole.losses
    for (k, a), (_, b) in zip(whole.model.state_dict().items(),
                              resumed.model.state_dict().items()):
        assert torch.equal(a, b), k
    assert whole.best_params.keys() == resumed.best_params.keys()
    for k in whole.best_params:
        assert torch.equal(whole.best_params[k], resumed.best_params[k]), k


def test_manual_checkpoint_keeps_early_stop_state(data, tmp_path):
    runner = _runner(data)
    runner.train_epoch(0)
    runner.best_mrr, runner.bad_evals, runner.epoch = 0.25, 2, 0
    path = save_mkgc_checkpoint(runner, str(tmp_path / "ck.pt"))
    assert not osp.exists(path + ".tmp")
    resumed = _runner(data, resume_from=path)
    assert (resumed.start_epoch, resumed.best_mrr, resumed.bad_evals,
            resumed.best_params) == (1, 0.25, 2, None)
    a, b = runner.train_epoch(1), resumed.train_epoch(1)
    assert a == b


def test_save_model_then_only_test_gives_the_same_metrics(data, tmp_path):
    m_train = _runner(data, epoch=2, eval_epoch=1, save_model=1, exp_id="rt1",
                      data_path=str(tmp_path)).run()
    assert osp.exists(tmp_path / "SYNTH" / "save" / "rt1.pt")
    only = _runner(data, only_test=1, exp_id="rt1", data_path=str(tmp_path))
    assert only.run() == m_train


def test_only_test_without_params_raises(data, tmp_path):
    runner = _runner(data, only_test=1, exp_id="never_saved",
                     data_path=str(tmp_path))
    with pytest.raises(RuntimeError, match="only_test"):
        runner.run()


def test_port_learns_the_synthetic_task(data):
    # the JAX package's bound (tests/test_mkgc.py::test_mkgc_learns)
    runner = _runner(data, joint_way="Mformer_hd_mean", epoch=60, add_noise=0)
    losses = [runner.train_epoch(e) for e in range(60)]
    m = runner.evaluate("test")
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert m["mrr"] > 0.15, m


@pytest.mark.parametrize("noise_update", ["epoch", "step"])
def test_cli_runs_on_the_cpu(tmp_path, noise_update):
    runner = port_main([
        "--data_choice", "SYNTH", "--joint_way", "Mformer_weight",
        "--num_proj", "2", "--use_intermediate", "1", "--emb_dim", "16",
        "--intermediate_size", "32", "--num_batch", "4", "--neg_num", "4",
        "--margin", "1.0", "--epoch", "4", "--eval_epoch", "2",
        "--pool_dim", "16", "--synth_ents", "60", "--synth_triples", "300",
        "--noise_update", noise_update, "--valid_max", "10",
        "--checkpoint_every", "2", "--device", "cpu",
        "--data_path", str(tmp_path)])
    m = runner.last_metrics
    assert all(0.0 <= m[k] <= 1.0 for k in ("mrr", "hits1", "hits3",
                                            "hits10"))
    assert runner.step.count == 4 * 4
    assert osp.exists(tmp_path / "SYNTH" / "ckpt" / "K001.pt")


def test_cli_takes_every_flag_of_run_base_sh():
    root = osp.dirname(osp.dirname(osp.abspath(__file__)))
    with open(osp.join(root, "scripts", "run_base.sh")) as f:
        flags = set(re.findall(r"(--\w+)", f.read()))
    parser = build_mkgc_argparser()
    ours = {o for a in parser._actions for o in a.option_strings}
    assert flags and flags <= ours, flags - ours
    assert parser.get_default("device") == "cuda"
    assert "--device" in parser.format_help()


def test_mesh_shape_raises(data):
    # a process in no group is one rank: data:2 is above the group's size
    # (the mesh itself: tests/test_torch_mesh_mkgc.py)
    with pytest.raises(ValueError, match="needs 2 processes in a group"):
        _runner(data, mesh_shape="data:2")


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda is not available"):
        port_main(["--data_choice", "SYNTH", "--synth_ents", "40",
                   "--synth_triples", "100"])


def test_port_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'optax', 'snag_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import snag_tpu_torch.mkgc.train, snag_tpu_torch.cli.train_mkgc\n"
        "print('ok')\n")
    root = osp.dirname(osp.dirname(osp.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
