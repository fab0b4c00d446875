"""Port contrastive losses and the SNAG training loss vs the JAX package.

On the CPU the port's NT-Xent runs its streaming formulation through the
dense twins; the JAX package on the CPU runs its dense block formulation
(``_per_row`` and the dense backward), so the two are independent.  The
SNAG loss is compared with the weights carried across, noise off and
dropout off (``deterministic``), ``--fused_snag_loss 0`` on both sides,
and also against the JAX package's fused bundle (``_bundle_dense``).
Tolerances: the ICL losses rtol = 1e-5, atol = 1e-6; the SNAG loss and
every parameter's gradient rtol = 1e-4, atol = 1e-5 (a whole encoder of
f32 sums in another order).
"""

import dataclasses

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snag_tpu.losses.contrastive import icl_loss as jax_icl_loss
from snag_tpu.losses.contrastive import icl_loss_multi as jax_icl_multi
from snag_tpu.losses.contrastive import icl_loss_stacked as jax_icl_stacked
from snag_tpu.losses.multitask import AutomaticWeightedLoss as JaxAWL
from snag_tpu.losses.multitask import KendallLossLayer as JaxKendall
from snag_tpu.models import build_model as jax_build_model
from snag_tpu_torch.losses.contrastive import (icl_loss, icl_loss_multi,
                                               icl_loss_stacked)
from snag_tpu_torch.losses.multitask import (AutomaticWeightedLoss,
                                             KendallLossLayer)
from snag_tpu_torch.ops.cuda import ntxent as tnx
from snag_tpu_torch.utils.import_reference import state_dict_from_flax
from torch_port_common import padded_batch, single_thread, model_pair

single_thread()
ICL_TOL = dict(rtol=1e-5, atol=1e-6)
SNAG_TOL = dict(rtol=1e-4, atol=1e-5)


def _tables(m, n, d, seed):
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(m, n, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=2, keepdims=True)
    links = rng.choice(n, size=(24, 2), replace=False).astype(np.int64)
    w = rng.uniform(0.2, 1.0, size=(m, 24)).astype(np.float32)
    valid = np.arange(24) < 19
    return emb, links, w, valid


@pytest.mark.parametrize("with_w,with_valid", [(True, True), (False, False)])
def test_icl_loss_multi_value_and_grads_match_jax(with_w, with_valid):
    emb, links, w, valid = _tables(3, 60, 16, seed=int(with_w))
    w = w if with_w else None
    valid = valid if with_valid else None

    def jloss(e, ww):
        return (jax_icl_multi(e, jnp.asarray(links), tau=0.1, ab_weight=0.4,
                              w_min=ww, valid=None if valid is None
                              else jnp.asarray(valid)) * jnp.arange(1, 4)).sum()
    jw = None if w is None else jnp.asarray(w)
    want, (g_e, g_w) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(
        jnp.asarray(emb), jw)

    e = torch.from_numpy(emb).requires_grad_()
    tw = None if w is None else torch.from_numpy(w).requires_grad_()
    got = (icl_loss_multi(e, torch.from_numpy(links), tau=0.1, ab_weight=0.4,
                          w_min=tw, valid=None if valid is None
                          else torch.from_numpy(valid))
           * torch.arange(1, 4)).sum()
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), **ICL_TOL)
    np.testing.assert_allclose(e.grad.numpy(), np.asarray(g_e), **ICL_TOL)
    if w is not None:
        np.testing.assert_allclose(tw.grad.numpy(), np.asarray(g_w),
                                   **ICL_TOL)


def test_icl_loss_stacked_and_simple_route_match_jax():
    """GMI's two tables (not normalised: the loss normalises) and the
    simple ``icl_loss`` route with per-entity weights."""
    rng = np.random.default_rng(3)
    a = rng.normal(size=(70, 20)).astype(np.float32)
    b = rng.normal(size=(70, 20)).astype(np.float32)
    wn = rng.uniform(0.1, 1.0, size=(70,)).astype(np.float32)
    links = rng.choice(70, size=(16, 2), replace=False).astype(np.int64)
    valid = np.arange(16) < 13

    def jloss(x, y):
        jl, jv = jnp.asarray(links), jnp.asarray(valid)
        return (jax_icl_stacked((x, y), jl, tau=0.1, ab_weight=0.5, valid=jv)
                + jax_icl_loss(x, jl, tau=0.1, ab_weight=0.5,
                               weight_norm=jnp.asarray(wn), valid=jv))
    want, (ga, gb) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(
        jnp.asarray(a), jnp.asarray(b))

    ta = torch.from_numpy(a).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    tl, tv = torch.from_numpy(links), torch.from_numpy(valid)
    got = (icl_loss_stacked((ta, tb), tl, tau=0.1, ab_weight=0.5, valid=tv)
           + icl_loss(ta, tl, tau=0.1, ab_weight=0.5,
                      weight_norm=torch.from_numpy(wn), valid=tv))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), **ICL_TOL)
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(ga), **ICL_TOL)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(gb), **ICL_TOL)
    # inversion leaves the simple route for the dense one
    want_inv = jax_icl_loss(jnp.asarray(a), jnp.asarray(links), tau=0.1,
                            ab_weight=0.5, valid=jnp.asarray(valid),
                            inversion=True)
    got_inv = icl_loss(torch.from_numpy(a), tl, tau=0.1, ab_weight=0.5,
                       valid=tv, inversion=True)
    np.testing.assert_allclose(got_inv.item(), float(want_inv), **ICL_TOL)


def test_multitask_layers_value_and_grads_match_jax():
    losses = [1.5, 0.0, 2.25, 0.7, 0.0, 3.0]
    p = np.array([0.9, 1.2, 1.1, 0.8, 1.0, 1.3, 0.7], dtype=np.float32)
    lv = np.linspace(-0.5, 0.5, 6).astype(np.float32)
    for jcls, tcls, name, val, n in ((JaxKendall, KendallLossLayer,
                                      "log_vars", lv, 6),
                                     (JaxAWL, AutomaticWeightedLoss,
                                      "params", p, 7)):
        class Wrap(flax.linen.Module):
            # a parent scope: flax refuses a top-level param named "params"
            @flax.linen.compact
            def __call__(self, ls):
                return jcls(n, name="layer")(ls)
        jl = [jnp.float32(x) for x in losses]
        want, g = jax.value_and_grad(lambda q: Wrap().apply(
            {"params": {"layer": {name: q}}}, jl))(jnp.asarray(val))
        tmod = tcls(n)
        with torch.no_grad():
            getattr(tmod, name).copy_(torch.from_numpy(val))
        got = tmod([torch.tensor(x) for x in losses])
        got.backward()
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
        np.testing.assert_allclose(getattr(tmod, name).grad.numpy(),
                                   np.asarray(g), rtol=1e-6, atol=1e-7)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return model_pair(str(tmp_path_factory.mktemp("loss")), fused_snag_loss=0)


def _jax_loss(pair, links, valid, fused=0):
    jcfg = dataclasses.replace(pair["jcfg"], fused_snag_loss=fused)
    model = jax_build_model(jcfg, pair["jdata"])

    def f(p):
        return model.apply({"params": p}, jnp.asarray(links),
                           jnp.asarray(valid), pair["jfeats"],
                           pair["jdata"].graph, deterministic=True)
    (loss, aux), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
        pair["params"])
    return float(loss), jax.device_get(aux), jax.device_get(grads)


def test_snag_loss_aux_and_param_grads_match_jax(pair):
    links, valid = padded_batch(pair["tdata"].train_ill, 24, 20)
    want, want_aux, want_g = _jax_loss(pair, links, valid)
    model = pair["tmodel"]
    model.zero_grad()
    before = tnx.STATS_GRAD.twin_calls
    loss, aux = model(torch.from_numpy(links), torch.from_numpy(valid),
                      pair["tfeats"], pair["tgraph"])
    loss.backward()
    # GMI, ECIA, IIR: one streaming backward each
    assert tnx.STATS_GRAD.twin_calls == before + 3
    np.testing.assert_allclose(loss.item(), want, **SNAG_TOL)
    for k in ("joint_Intra_modal", "Intra_modal", "IIR_loss", "weight_norm"):
        np.testing.assert_allclose(aux[k].detach().numpy(),
                                   np.asarray(want_aux[k]), err_msg=k,
                                   **SNAG_TOL)
    want_sd = state_dict_from_flax(want_g)
    named = dict(model.named_parameters())
    assert set(want_sd) == set(named)
    for k, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(), want_sd[k].numpy(),
                                   err_msg=k, **SNAG_TOL)


@pytest.mark.parametrize("with_w", [True, False])
def test_inner_view_loss_unequal_widths_matches_jax(pair, with_w):
    """gph/rel/att 32 wide and img 16 wide: one ``icl_loss`` per modality
    on both sides (JAX snag.py:127-141).  Loss rtol 1e-5; the gradients of
    the four tables and of weight_norm rtol 1e-4 (atol 1e-7 for entries
    that cancel to ~0)."""
    from snag_tpu.models.snag import SNAG as JaxSNAG
    n = pair["tdata"].ent_num
    rng = np.random.default_rng(11)
    embs = [rng.normal(size=(n, d)).astype(np.float32)
            for d in (32, 32, 32, 16)]
    wn = rng.uniform(0.1, 1.0, size=(n, 4)).astype(np.float32) \
        if with_w else None
    links, valid = padded_batch(pair["tdata"].train_ill, 24, 20)

    def jloss(gph, rel, att, img, w):
        return pair["jmodel"].apply(
            {"params": pair["params"]}, gph, rel, att, img, None, None,
            jnp.asarray(links), jnp.asarray(valid), weight_norm=w,
            method=JaxSNAG.inner_view_loss)
    argnums = (0, 1, 2, 3, 4) if with_w else (0, 1, 2, 3)
    want, want_g = jax.value_and_grad(jloss, argnums=argnums)(
        *[jnp.asarray(e) for e in embs],
        None if wn is None else jnp.asarray(wn))

    ts = [torch.from_numpy(e).requires_grad_() for e in embs]
    tw = None if wn is None else torch.from_numpy(wn).requires_grad_()
    got = pair["tmodel"].inner_view_loss(
        *ts, None, None, torch.from_numpy(links), torch.from_numpy(valid),
        weight_norm=tw)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    for t, g in zip(ts + ([tw] if with_w else []), want_g):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=1e-4,
                                   atol=1e-7)


def test_unfused_port_loss_equals_jax_fused_bundle(pair):
    """The port's GMI + ECIA as separate NT-Xent calls give the JAX
    package's fused mixture bundle (``_bundle_dense`` on the CPU)."""
    links, valid = padded_batch(pair["tdata"].train_ill, 24, 20)
    want, _, _ = _jax_loss(pair, links, valid, fused=1)
    with torch.no_grad():
        loss, _ = pair["tmodel"](torch.from_numpy(links),
                                 torch.from_numpy(valid), pair["tfeats"],
                                 pair["tgraph"])
    np.testing.assert_allclose(loss.item(), want, rtol=1e-4)
