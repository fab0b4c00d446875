"""EVA, MCLEA and MEAformer in the port against the JAX package, on the CPU.

Each family is built in both packages at the small geometry of
``torch_port_common.SMALL`` with ``--model_name`` switched, the JAX
params carried across by ``state_dict_from_flax`` (the Kendall
log-variances set away from zero), noise and dropout off.  On the CPU the
port's kernel wrappers run their plain twins.

Tolerances:
* the step-0 loss and every aux term rel 1e-5 (f32 sums in another
  order), each parameter's gradient max |err| <= 1e-4 x max |JAX| over
  its optimizer group (these families have one).  The group's scale, not
  the parameter's: the attention's key bias has a gradient that is zero
  in exact arithmetic (each row's softmax is invariant to it), so its own
  scale is rounding noise;
* three AdamW steps: losses rel 1e-4, parameters atol 1e-5 (as SNAG's
  ``test_three_optimizer_steps_match_jax``);
* ``joint_emb`` at serving rtol = atol = 1e-5;
* bf16 (``--dtype bfloat16``, MCLEA and MEAformer, the JAX package's
  Pallas paths in interpret mode with f32 reductions, as
  ``test_torch_bf16.py`` runs them): the step-0 loss rel 1e-3, gradients
  max |err| <= 1e-2 x max |JAX| over the families' one optimizer group;
* the losses alone (NCA, IAL, the dense ICL with replay negatives or
  ``inversion``): value and gradients rtol = 1e-5, atol = 1e-6.  NCA's
  row sums of exp(15 s) reach ~1e10 without a static max; f32 holds them.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from snag_tpu.losses.contrastive import ial_loss as jax_ial_loss
from snag_tpu.losses.contrastive import icl_loss as jax_icl_loss
from snag_tpu.losses.contrastive import nca_loss as jax_nca_loss
from snag_tpu.models import build_model as jax_build_model
from snag_tpu.train.optim import build_optimizer as jax_build_optimizer
from snag_tpu_torch.cli.train_mmea import main as port_main
from snag_tpu_torch.config import Config, finalize_config
from snag_tpu_torch.losses.contrastive import ial_loss, icl_loss, nca_loss
from snag_tpu_torch.models import build_model
from snag_tpu_torch.ops import cuda as kernels
from snag_tpu_torch.train.runner import Runner
from snag_tpu_torch.train.step import TrainStep
from snag_tpu_torch.utils.import_reference import state_dict_from_flax
from snag_tpu_torch.utils.logging import create_logger
from torch_port_common import (SMALL, f32_reductions, model_pair,
                               padded_batch, pallas_interpret, single_thread,
                               small_argv)

single_thread()
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4         # x max |JAX| over the optimizer group
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
CASES = {
    "EVA": dict(model_name="EVA"),
    # seven NCA losses: name and char join (six weight_raw slots)
    "EVA_surface": dict(model_name="EVA", use_surface=1, inner_view_num=6),
    "MCLEA": dict(model_name="MCLEA", tau2=4.0),
    "MCLEA_heads": dict(model_name="MCLEA", tau2=4.0, use_project_head=True),
    "MEAformer": dict(model_name="MEAformer", tau2=4.0),
}
FAMILIES = ("EVA", "MCLEA", "MEAformer")


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    cache = {}

    def get(case, **extra):
        key = (case, tuple(sorted(extra.items())))
        if key not in cache:
            cache[key] = model_pair(str(tmp_path_factory.mktemp(case)),
                                    lr=5e-4, scheduler="cos",
                                    **CASES[case], **extra)
        return cache[key]
    return get


def _batches(pair):
    return [padded_batch(pair["tdata"].train_ill[k:], 24, n)
            for k, n in ((0, 24), (5, 24), (11, 17))]


def _jax_loss_fn(pair):
    model = pair["jmodel"]

    def f(q, links, valid):
        return model.apply({"params": q}, links, valid, pair["jfeats"],
                           pair["jdata"].graph, deterministic=True)
    return f


def _port_step0(pair, links, valid):
    probe = copy.deepcopy(pair["tmodel"])
    loss, aux = probe(torch.from_numpy(links), torch.from_numpy(valid),
                      pair["tfeats"], pair["tgraph"])
    loss.backward()
    return loss.item(), aux, dict(probe.named_parameters())


@pytest.mark.parametrize("case", list(CASES))
def test_family_loss_aux_and_grads_match_jax(pairs, case):
    """Step 0's loss, every aux term and every parameter gradient."""
    pair = pairs(case)
    links, valid = _batches(pair)[2]           # the padded batch
    params = jax.tree_util.tree_map(jnp.asarray, pair["params"])
    (want, want_aux), want_g = jax.jit(jax.value_and_grad(
        _jax_loss_fn(pair), has_aux=True))(params, jnp.asarray(links),
                                           jnp.asarray(valid))
    got, aux, named = _port_step0(pair, links, valid)
    np.testing.assert_allclose(got, float(want), rtol=LOSS_RTOL)
    assert set(aux) == set(want_aux)
    for k, v in aux.items():
        np.testing.assert_allclose(v.detach().numpy(),
                                   np.asarray(want_aux[k]), rtol=LOSS_RTOL,
                                   err_msg=k)
    want_sd = state_dict_from_flax(jax.device_get(want_g))
    assert set(want_sd) == set(named)
    scale = max(w.abs().max().item() for w in want_sd.values())
    for k, p in named.items():
        err = (p.grad - want_sd[k]).abs().max().item()
        assert err <= GRAD_TOL * scale, (k, err, scale)
    if case == "EVA_surface":
        assert {"name", "char"} <= set(aux)
    if case == "MCLEA_heads":
        assert "multimodal_encoder.gph_pro.l2.weight" in named


@pytest.mark.parametrize("family", FAMILIES)
def test_family_three_optimizer_steps_match_jax(pairs, family):
    """From the same params and batches: JAX's value_and_grad +
    build_optimizer tx (one AdamW group, decay on every parameter) against
    the port's TrainStep."""
    pair = pairs(family)
    total, warmup = 20, 3
    jcfg = pair["jcfg"]
    params = jax.tree_util.tree_map(jnp.asarray, pair["params"])
    tx, _ = jax_build_optimizer(jcfg, params, total, warmup)
    opt_state = tx.init(params)
    f = _jax_loss_fn(pair)

    @jax.jit
    def jstep(p, s, links, valid):
        (loss, _), g = jax.value_and_grad(f, has_aux=True)(p, links, valid)
        upd, s = tx.update(g, s, p)
        return optax.apply_updates(p, upd), s, loss

    want_losses = []
    for links, valid in _batches(pair):
        params, opt_state, loss = jstep(params, opt_state, jnp.asarray(links),
                                        jnp.asarray(valid))
        want_losses.append(float(loss))

    model = copy.deepcopy(pair["tmodel"])
    step = TrainStep(pair["tcfg"], model, pair["tcfg"].lr, total, warmup)
    assert len(step.opt.param_groups) == 1
    assert step.opt.param_groups[0]["weight_decay"] == jcfg.weight_decay
    got_losses = [step(torch.from_numpy(l), torch.from_numpy(v),
                       pair["tfeats"], pair["tgraph"], epoch=0,
                       deterministic=True)[0].item()
                  for l, v in _batches(pair)]
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-4)
    want_sd = state_dict_from_flax(jax.device_get(params))
    for k, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want_sd[k].numpy(), atol=1e-5,
                                   rtol=0, err_msg=k)


@pytest.mark.parametrize("family", FAMILIES)
def test_family_joint_emb_matches_jax(pairs, family):
    pair = pairs(family)
    jm = pair["jmodel"]
    want, want_w = jax.jit(lambda q: jm.apply(
        {"params": q}, pair["jfeats"], pair["jdata"].graph,
        method=type(jm).joint_emb))(pair["params"])
    with torch.no_grad():
        got, got_w = pair["tmodel"].joint_emb(pair["tfeats"], pair["tgraph"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert (got_w is None) == (want_w is None)
    if got_w is not None:
        np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("family", ("MCLEA", "MEAformer"))
def test_family_bf16_step0_matches_jax(pairs, family):
    """``--dtype bfloat16``: step 0's loss and gradients against the JAX
    package's bf16 path with its Pallas kernels in interpret mode."""
    pair = pairs(family, dtype="bfloat16")
    links, valid = _batches(pair)[2]
    params = jax.tree_util.tree_map(jnp.asarray, pair["params"])
    with pallas_interpret(), f32_reductions():
        (want, _), want_g = jax.jit(jax.value_and_grad(
            _jax_loss_fn(pair), has_aux=True))(params, jnp.asarray(links),
                                               jnp.asarray(valid))
    got, _, named = _port_step0(pair, links, valid)
    assert abs(got - float(want)) <= 1e-3 * abs(float(want)), (got, want)
    want_sd = state_dict_from_flax(jax.device_get(want_g))
    scale = max(w.abs().max().item() for w in want_sd.values())
    for k, p in named.items():
        assert p.dtype == torch.float32 and torch.isfinite(p.grad).all(), k
        err = (p.grad - want_sd[k]).abs().max().item()
        assert err <= 1e-2 * scale, (k, err, scale)


def test_eva_runs_f32_under_bf16(pairs, tmp_path):
    """EVA passes no dtype to its layers: under ``--dtype bfloat16`` it
    computes what it does in f32, in the JAX package and in the port, and
    the runner takes it with its GCN."""
    pair = pairs("EVA")
    links, valid = _batches(pair)[2]
    jcfg16 = dataclasses.replace(pair["jcfg"], dtype="bfloat16")
    f32, f16 = (jax.jit(lambda q, m=m: m.apply(
        {"params": q}, jnp.asarray(links), jnp.asarray(valid),
        pair["jfeats"], pair["jdata"].graph, deterministic=True)[0])(
            pair["params"])
        for m in (pair["jmodel"], jax_build_model(jcfg16, pair["jdata"])))
    assert float(f32) == float(f16)

    tcfg16 = dataclasses.replace(pair["tcfg"], dtype="bfloat16")
    m16 = build_model(tcfg16, pair["tdata"], torch.Generator().manual_seed(1))
    m16.load_state_dict(pair["tmodel"].state_dict(), strict=True)
    got = {}
    for name, model in (("f32", copy.deepcopy(pair["tmodel"])),
                        ("bf16", m16)):
        loss, _ = model(torch.from_numpy(links), torch.from_numpy(valid),
                        pair["tfeats"], pair["tgraph"])
        loss.backward()
        got[name] = (loss.detach(), {k: p.grad for k, p in
                                     model.named_parameters()})
    assert torch.equal(got["f32"][0], got["bf16"][0])
    for k, g in got["f32"][1].items():
        assert torch.equal(g, got["bf16"][1][k]), k
    np.testing.assert_allclose(got["bf16"][0].item(), float(f16),
                               rtol=LOSS_RTOL)
    cfg = finalize_config(Config(device="cpu", **{
        **SMALL, "model_name": "EVA", "structure_encoder": "gcn",
        "dtype": "bfloat16"}), data_root=str(tmp_path))
    Runner(cfg, create_logger(name="eva_bf16"))


# ---------------------------------------------------------- the losses alone

def _unit_table(n, d, seed):
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(n, d)).astype(np.float32)
    links = rng.choice(n, size=(20, 2), replace=False).astype(np.int64)
    # near-copy positives, so that the losses see aligned pairs
    emb[links[:, 1]] = emb[links[:, 0]] + 0.6 * emb[links[:, 1]]
    return emb, links, np.arange(20) < 16


@pytest.mark.parametrize("padded", [True, False])
def test_nca_loss_matches_jax(padded):
    emb, links, valid = _unit_table(60, 24, seed=1)
    v = valid if padded else None

    def jloss(e):
        return jax_nca_loss(e, jnp.asarray(links), alpha=15, beta=10,
                            valid=None if v is None else jnp.asarray(v))
    want, want_g = jax.jit(jax.value_and_grad(jloss))(jnp.asarray(emb))
    e = torch.from_numpy(emb).requires_grad_()
    got = nca_loss(e, torch.from_numpy(links), alpha=15, beta=10,
                   valid=None if v is None else torch.from_numpy(v))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), **LOSS_TOL)
    np.testing.assert_allclose(e.grad.numpy(), np.asarray(want_g), **LOSS_TOL)


@pytest.mark.parametrize("reduction,inversion", [("mean", False),
                                                 ("sum", False),
                                                 ("mean", True)])
def test_ial_loss_matches_jax(reduction, inversion):
    """The KL alignment with padded rows: the modality's gradient; none
    reaches the joint rows."""
    src, links, valid = _unit_table(60, 16, seed=2)
    tar = src @ np.random.default_rng(3).normal(size=(16, 24)).astype(
        np.float32)
    kw = dict(tau=4.0, ab_weight=0.4, zoom=0.1, reduction=reduction,
              inversion=inversion)

    def jloss(s, t):
        return jax_ial_loss(s, t, jnp.asarray(links),
                            valid=jnp.asarray(valid), **kw)
    want, (gs, gt) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(
        jnp.asarray(src), jnp.asarray(tar))
    s = torch.from_numpy(src).requires_grad_()
    t = torch.from_numpy(tar).requires_grad_()
    got = ial_loss(s, t, torch.from_numpy(links),
                   valid=torch.from_numpy(valid), **kw)
    got.backward()
    assert np.isfinite(got.item()) and got.item() > 0
    np.testing.assert_allclose(got.item(), float(want), **LOSS_TOL)
    np.testing.assert_allclose(s.grad.numpy(), np.asarray(gs), **LOSS_TOL)
    assert t.grad is None and not np.asarray(gt).any()


@pytest.mark.parametrize("route", ["replay", "inversion"])
def test_dense_icl_loss_matches_jax(route):
    """The dense ICL: replay negatives (some masked, per side) with the
    miner, or ``inversion``; value and gradients, and the mined columns."""
    emb, links, valid = _unit_table(60, 16, seed=4)
    rng = np.random.default_rng(5)
    neg_l = rng.integers(0, 60, size=20)
    neg_r = rng.integers(0, 60, size=20)
    nv_l = rng.uniform(size=20) > 0.3
    nv_r = rng.uniform(size=20) > 0.5
    jkw, tkw = {}, {}
    if route == "replay":
        for name, a in (("neg_l", neg_l), ("neg_r", neg_r),
                        ("neg_valid", nv_l), ("neg_valid_r", nv_r)):
            jkw[name], tkw[name] = jnp.asarray(a), torch.from_numpy(a)
        jkw["with_replay_mining"] = tkw["with_replay_mining"] = True
    else:
        jkw["inversion"] = tkw["inversion"] = True

    def jloss(e):
        out = jax_icl_loss(e, jnp.asarray(links), tau=0.1, ab_weight=0.4,
                           valid=jnp.asarray(valid), **jkw)
        return (out[0], out[1:]) if route == "replay" else (out, ())
    (want, want_mined), want_g = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(jnp.asarray(emb))
    e = torch.from_numpy(emb).requires_grad_()
    out = icl_loss(e, torch.from_numpy(links), tau=0.1, ab_weight=0.4,
                   valid=torch.from_numpy(valid), **tkw)
    got, mined = (out[0], out[1:]) if route == "replay" else (out, ())
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), **LOSS_TOL)
    np.testing.assert_allclose(e.grad.numpy(), np.asarray(want_g), **LOSS_TOL)
    for a, b in zip(mined, want_mined):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert len(mined) == (2 if route == "replay" else 0)


# ------------------------------------------------------------ the CLI, CPU

# the kernel wrappers each family's training run goes through (their CPU
# twins here), as chip_smoke.py holds their launches on the card
RUN_KERNELS = {
    "EVA": {"weighted_segment_sum", "rank_topk_mean", "rank_counts"},
    "MCLEA": {"gat_attention_fwd", "gat_bwd", "ntxent_lse", "ntxent_grad",
              "rank_topk_mean", "rank_counts"},
}
RUN_KERNELS["MEAformer"] = RUN_KERNELS["MCLEA"]


@pytest.mark.parametrize("family,replay", [("EVA", 0), ("MCLEA", 0),
                                           ("MEAformer", 0), ("MEAformer", 1)])
def test_cli_trains_and_serves_family_on_cpu(tmp_path, family, replay):
    """``train_mmea --model_name <family>`` on the CPU: training with IL
    promotion and a saved model through exactly the family's kernel
    wrappers, then ``--only_test 1`` from the saved ``.pkl``."""
    extra = dict(model_name=family, replay=replay, tau2=4.0)
    if family == "EVA":
        extra["structure_encoder"] = "gcn"
    kernels.reset_stats()
    runner = port_main(small_argv(
        tmp_path, epoch=12, il="", il_start=2, semi_learn_step=1,
        eval_epoch=4, batch_size=32, lr=5e-4, scheduler="cos", add_noise=1,
        noise_ratio=0.2, mask_ratio=0.7, save_model=1, exp_id="fam", **extra))
    ran = {name for name, s in kernels.all_stats().items() if s.twin_calls}
    assert ran == RUN_KERNELS[family]
    losses = runner.loss_log.loss[1:]
    assert len(losses) == 12 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    assert runner.promoted and runner.promoted[0] > 0
    res = runner.last_result
    for v in (*res.acc_l2r, *res.acc_r2l, res.mrr_l2r, res.mrr_r2l):
        assert 0.0 <= v <= 1.0
    if replay:
        assert runner.replay_ready and runner.replay_negatives > 0
    served = port_main(small_argv(tmp_path, only_test=1,
                                  model_name_save=runner.cfg.exp_id,
                                  **extra))
    np.testing.assert_array_equal(served.last_result.ranks_l2r,
                                  res.ranks_l2r)


def test_msnea_refuses_naming_its_roadmap_item(tmp_path):
    """MSNEA refused with its ROADMAP item until it was ported: now its
    data path and the runner build it, with its triple bank and no noise
    function (``test_torch_msnea.py`` holds it against JAX)."""
    from snag_tpu_torch.models.msnea import MSNEA
    cfg = finalize_config(Config(device="cpu", **{**SMALL,
                                                  "model_name": "MSNEA",
                                                  "add_noise": 1}),
                          data_root=str(tmp_path))
    runner = Runner(cfg, create_logger(name="msnea"))
    assert isinstance(runner.model, MSNEA)
    assert runner.noise_fn is None and runner.bank is not None
    assert runner.bank.n1 == len(runner.data.kg1_triples)
    model = build_model(cfg, runner.data, torch.Generator())
    assert isinstance(model, MSNEA)
