"""Gradient accumulation and GAT attention dropout in the port against the
JAX package, on the CPU.

Accumulation (``--accumulation_steps k``): the port's ``TrainStep``
against ``optax.MultiSteps`` as ``snag_tpu.train.optim.build_optimizer``
builds it, on SNAG at the small geometry of ``torch_port_common.SMALL``
with all six modalities (see ``test_torch_train.py``) and the unfused
loss, noise and dropout off: k = 2 and 3 over 8 micro-steps whose fourth
and last batches are ragged (an epoch's last batch); every update's LR
exactly as JAX's schedule gives it (rtol 1e-6), the parameters after
each micro-step atol 1e-5, unchanged bit for bit by a micro-step that
ends no cycle.  A run killed mid-cycle and resumed from its checkpoint
equals the uninterrupted run bit for bit.

Attention dropout (``--attn_dropout``): a GAT layer with two heads, and
the two-layer stack, in training against the JAX package's general path
(``snag_tpu/ops/gnn.py:153-174``) with the same dropout masks injected on
both sides (``flax.linen.Dropout`` patched inside the test, the port's
``keep_mask``): output and the gradients of x, ``w`` and ``a_src_dst``,
f32 at rtol = atol = 1e-5 (as ``test_torch_gat_bwd.py``), the bf16 layer
at 4e-3 x max |JAX|.  In bf16 the reference is held to its own dtypes:
its bf16 reductions add in f32 and round once (``f32_reductions``), and
its bf16 products, h = x w_h among them, are rounded to bf16
(``bf16_products``), which XLA's CPU backend skips where a product is
converted straight to f32.  Two identical steps give
identical bits, and evaluation or a zero rate keeps the fused kernels.
"""

import dataclasses
import os.path as osp
import unittest.mock as mock

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from snag_tpu.data.graph import build_graph as jax_build_graph
from snag_tpu.models import build_model as jax_build_model
from snag_tpu.ops.gnn import GAT as JaxGAT
from snag_tpu.ops.gnn import MultiHeadGraphAttention as JaxLayer
from snag_tpu.train.optim import build_optimizer as jax_build_optimizer
from snag_tpu_torch.cli.train_mmea import main as port_main
from snag_tpu_torch.config import (build_argparser, config_from_args,
                                   finalize_config)
from snag_tpu_torch.data.graph import build_graph
from snag_tpu_torch.ops import cuda as kernels
from snag_tpu_torch.ops import gnn
from snag_tpu_torch.ops.gnn import GAT
from snag_tpu_torch.ops.noise import generator
from snag_tpu_torch.train.runner import Runner
from snag_tpu_torch.train.step import TrainStep
from snag_tpu_torch.utils.checkpoint import CHECKPOINT_NAME
from snag_tpu_torch.utils.import_reference import state_dict_from_flax
from snag_tpu_torch.utils.logging import get_dump_path
from torch_port_common import (assert_close_bf16, bf16_np, bf16_products,
                               f32_reductions, model_pair, padded_batch,
                               single_thread, small_argv)

single_thread()
TOL = dict(rtol=1e-5, atol=1e-5)
B = 24
# (offset, valid rows) of the micro-steps' batches: the fourth and the
# last are ragged
BATCHES = ((0, B), (5, B), (2, B), (3, 9), (6, B), (1, B), (4, B), (4, 17))


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return model_pair(str(tmp_path_factory.mktemp("accum")), fused_snag_loss=0,
                      lr=5e-4, scheduler="cos", use_surface=1)


@pytest.mark.parametrize("k", [2, 3])
def test_accumulation_matches_optax_multisteps(pair, k):
    total, warmup = 40, 7
    jcfg = dataclasses.replace(pair["jcfg"], accumulation_steps=k)
    tcfg = dataclasses.replace(pair["tcfg"], accumulation_steps=k,
                               add_noise=0)
    model = jax_build_model(jcfg, pair["jdata"])
    params = jax.tree_util.tree_map(jnp.asarray, pair["params"])
    tx, sched = jax_build_optimizer(jcfg, params, total, warmup)
    opt_state = tx.init(params)

    @jax.jit
    def jstep(p, s, links, valid):
        def f(q):
            return model.apply({"params": q}, links, valid, pair["jfeats"],
                               pair["jdata"].graph, deterministic=True)
        (loss, _), g = jax.value_and_grad(f, has_aux=True)(p)
        upd, s = tx.update(g, s, p)
        return optax.apply_updates(p, upd), s, loss

    tmodel = pair["tmodel"]
    tmodel.load_state_dict(state_dict_from_flax(pair["params"]))
    step = TrainStep(tcfg, tmodel, tcfg.lr, total, warmup)
    for i, (off, n) in enumerate(BATCHES):
        links, valid = padded_batch(pair["tdata"].train_ill[off:], B, n)
        before = {k_: v.clone() for k_, v in tmodel.state_dict().items()}
        lr = step.lr()
        params, opt_state, want = jstep(params, opt_state,
                                        jnp.asarray(links), jnp.asarray(valid))
        got, _ = step(torch.from_numpy(links), torch.from_numpy(valid),
                      pair["tfeats"], pair["tgraph"], epoch=0,
                      deterministic=True)
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-4)
        # the LR of the update this cycle ends in, at JAX's gradient step
        assert int(opt_state.gradient_step) == step.updates
        np.testing.assert_allclose(lr, float(sched(i // k)), rtol=1e-6,
                                   atol=1e-10)
        after = tmodel.state_dict()
        if (i + 1) % k:
            assert int(opt_state.mini_step) == (i + 1) % k
            assert step.accum is not None
            for name, v in after.items():
                assert torch.equal(v, before[name]), (i, name)
        else:
            assert step.accum is None
        want_sd = state_dict_from_flax(jax.device_get(params))
        for name, v in after.items():
            np.testing.assert_allclose(v.numpy(), want_sd[name].numpy(),
                                       atol=1e-5, err_msg=f"{i} {name}")
    assert step.count == len(BATCHES) and step.updates == len(BATCHES) // k


class Killed(Exception):
    pass


# three steps an epoch at batch 10 (30 train pairs), so the epoch-2
# checkpoint falls after micro-step 9, mid-cycle
RESUME = dict(epoch=7, il="", il_start=2, semi_learn_step=1, eval_epoch=2,
              batch_size=10, lr=5e-4, scheduler="cos", add_noise=1,
              noise_ratio=0.2, mask_ratio=0.7, checkpoint_every=3,
              accumulation_steps=2, attn_dropout=0.1)


def _dump(argv):
    return get_dump_path(finalize_config(config_from_args(
        build_argparser().parse_args(argv))))


def test_resume_mid_accumulation_equals_uninterrupted(tmp_path, monkeypatch):
    full = port_main(small_argv(tmp_path / "full", **RESUME))
    assert full._steps_per_epoch() % 2 == 1
    argv = small_argv(tmp_path / "kill", **RESUME)
    train_epoch = Runner.train_epoch

    def killing(self):
        if self.epoch == 3:
            raise Killed
        return train_epoch(self)

    monkeypatch.setattr(Runner, "train_epoch", killing)
    with pytest.raises(Killed):
        port_main(argv)
    monkeypatch.setattr(Runner, "train_epoch", train_epoch)
    ckpt = osp.join(_dump(argv), CHECKPOINT_NAME)
    saved = torch.load(ckpt, weights_only=True)["schedule"]
    assert saved["count"] % 2 == 1 and saved["accum"] is not None
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
    assert (resumed.train_step.count, resumed.train_step.updates) == \
        (full.train_step.count, full.train_step.updates)
    assert resumed.loss_log.loss == full.loss_log.loss
    np.testing.assert_array_equal(resumed.last_result.ranks_l2r,
                                  full.last_result.ranks_l2r)


# ---------------------------------------------------------------- dropout
N, C, HEADS, RATE = 200, 32, [2, 2], 0.3


def _gat_inputs(seed=4):
    rng = np.random.default_rng(seed)
    tri = [(int(rng.integers(N)), 0, int(rng.integers(N)))
           for _ in range(600)]
    x = rng.normal(size=(N, C)).astype(np.float32)
    params = {f"gat_{i}": {
        "w": (1.0 + 0.3 * rng.normal(size=(HEADS[i], 1, C))).astype(np.float32),
        "a_src_dst": (0.2 * rng.normal(size=(HEADS[i], 2 * C, 1))
                      ).astype(np.float32)} for i in range(2)}
    g_out = rng.normal(size=(N, C)).astype(np.float32)
    jg = jax_build_graph(N, tri)
    # each layer's keep mask over the JAX graph's (H, E) edge slots
    masks = [rng.random((h, jg.row.shape[0])) >= RATE for h in HEADS]
    return tri, x, params, g_out, jg, masks


def _jax_grads(tri, x, params, g_out, jg, masks, dtype, stack):
    """JAX's output and gradients with ``flax.linen.Dropout`` injecting
    each layer's mask: the GAT stack, or its first layer alone."""
    masks = [jnp.asarray(m) for m in masks]

    class InjectedDropout(flax.linen.Module):
        """``nn.Dropout`` with the layer's mask (flax's select of
        x / keep_prob); the identity at rate 0 (the GAT's input dropout)."""
        rate: float

        @flax.linen.compact
        def __call__(self, x, deterministic=None):
            if self.rate == 0.0:
                return x
            path = self.scope.path
            layer = int(path[0].split("_")[1]) if len(path) > 1 else 0
            return jnp.where(masks[layer], x / (1.0 - self.rate), 0.0)

    if stack:
        mod = JaxGAT(n_units=[C, C, C], n_heads=HEADS, attn_dropout=RATE,
                     adj_dtype=jnp.float32, dtype=dtype)
    else:
        mod = JaxLayer(n_head=HEADS[0], f_in=C, f_out=C, attn_dropout=RATE,
                       dtype=dtype)
        params = params["gat_0"]

    def loss(p, xx):
        out = mod.apply({"params": p}, xx, jg, deterministic=False)
        return (out * g_out).sum(), out

    with mock.patch.object(flax.linen, "Dropout", InjectedDropout), \
            f32_reductions(), bf16_products():
        (_, out), (gp, gx) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    gp = jax.device_get(gp)
    return np.asarray(out), np.asarray(gx), gp if stack else {"gat_0": gp}


def _port_grads(tri, x, params, g_out, jg, masks, dtype, stack, monkeypatch):
    real = jg.mask
    keeps = [torch.from_numpy(np.ascontiguousarray(m[:, real].T))
             for m in masks]
    calls = []

    def injected(shape, rate, gen, device):
        keep = keeps[len(calls)]
        calls.append(shape)
        assert tuple(shape) == tuple(keep.shape) and rate == RATE
        return keep
    monkeypatch.setattr(gnn, "keep_mask", injected)
    gen = torch.Generator().manual_seed(0)
    if stack:
        mod = GAT([C, C, C], HEADS, gen, attn_dropout=RATE, dtype=dtype)
        mod.load_state_dict({f"layer_stack.{i}.{k}": torch.from_numpy(v)
                             for i in range(2)
                             for k, v in params[f"gat_{i}"].items()},
                            strict=True)
        prefix = "layer_stack.{}."
    else:
        mod = gnn.MultiHeadGraphAttention(HEADS[0], C, C, gen,
                                          attn_dropout=RATE, dtype=dtype)
        mod.load_state_dict({k: torch.from_numpy(v)
                             for k, v in params["gat_0"].items()},
                            strict=True)
        prefix = ""
    xt = torch.from_numpy(x).requires_grad_()
    out = mod(xt, build_graph(N, tri).to_torch("cpu"),
              dropout_gen=generator(0, "cpu"))
    (out * torch.from_numpy(g_out)).sum().backward()
    n_layers = 2 if stack else 1
    assert len(calls) == n_layers
    named = dict(mod.named_parameters())
    grads = {(i, k): named[prefix.format(i) + k].grad
             for i in range(n_layers) for k in ("w", "a_src_dst")}
    return out.detach(), xt.grad, grads


@pytest.mark.parametrize("dtype,stack", [("float32", False),
                                         ("bfloat16", False),
                                         ("float32", True)])
def test_dropout_gat_matches_jax_on_injected_masks(monkeypatch, dtype, stack):
    """A layer with two heads in f32 and bf16 (its input rounded to bf16
    alike on both sides), and the two-layer stack in f32."""
    tri, x, params, g_out, jg, masks = _gat_inputs()
    if not stack:
        g_out = np.random.default_rng(6).normal(
            size=(N, HEADS[0], C)).astype(np.float32)
    if dtype == "bfloat16":
        x = bf16_np(x)
    inputs = (tri, x, params, g_out, jg, masks)
    want_out, want_gx, want_gp = _jax_grads(*inputs, getattr(jnp, dtype),
                                            stack)
    out, gx, gp = _port_grads(*inputs, getattr(torch, dtype), stack,
                              monkeypatch)
    pairs = [("out", out, want_out), ("d_x", gx, want_gx)] + [
        (f"{i}.{k}", g, want_gp[f"gat_{i}"][k]) for (i, k), g in gp.items()]
    for name, got, want in pairs:
        if dtype == "float32":
            np.testing.assert_allclose(got.numpy(), want, err_msg=name, **TOL)
        else:
            assert_close_bf16(got, want, name)


def _train_step_params():
    """A two-layer GAT's training forward and backward, the masks drawn
    from a step's generator: output, d_x and the parameters' gradients."""
    tri, x, params, g_out, _, _ = _gat_inputs(seed=7)
    gat = GAT([C, C, C], HEADS, torch.Generator().manual_seed(0),
              attn_dropout=RATE)
    gat.load_state_dict({f"layer_stack.{i}.{k}": torch.from_numpy(v)
                         for i in range(2)
                         for k, v in params[f"gat_{i}"].items()})
    xt = torch.from_numpy(x).requires_grad_()
    out = gat(xt, build_graph(N, tri).to_torch("cpu"),
              dropout_gen=generator(11, "cpu"))
    (out * torch.from_numpy(g_out)).sum().backward()
    return [out.detach(), xt.grad] + [p.grad for p in gat.parameters()]


def test_dropout_gat_repeats_bitwise_and_draws_its_mask():
    first, second = _train_step_params(), _train_step_params()
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    # the mask is drawn: the output differs from the undropped layer's
    tri, x, params, _, _, _ = _gat_inputs(seed=7)
    gat = GAT([C, C, C], HEADS, torch.Generator().manual_seed(0),
              attn_dropout=0.0)
    gat.load_state_dict({f"layer_stack.{i}.{k}": torch.from_numpy(v)
                         for i in range(2)
                         for k, v in params[f"gat_{i}"].items()})
    with torch.no_grad():
        plain = gat(torch.from_numpy(x), build_graph(N, tri).to_torch("cpu"))
    assert not torch.allclose(first[0], plain, atol=1e-3)


@pytest.mark.parametrize("rate,train", [(RATE, True), (RATE, False),
                                        (0.0, True)])
def test_dropout_path_only_in_training_with_a_rate(rate, train):
    """Training with a rate sums on the weighted segment sum; evaluation
    and a zero rate keep the fused GAT forward."""
    tri, x, params, _, _, _ = _gat_inputs(seed=9)
    gat = GAT([C, C, C], HEADS, torch.Generator().manual_seed(0),
              attn_dropout=rate)
    kernels.reset_stats()
    with torch.no_grad():
        gat(torch.from_numpy(x), build_graph(N, tri).to_torch("cpu"),
            dropout_gen=generator(3, "cpu") if train else None)
    stats = kernels.all_stats()
    dropped = rate > 0 and train
    # a layer: a row-sum call and one call per head
    assert stats["weighted_segment_sum"].twin_calls == \
        (2 * (1 + 2) if dropped else 0)
    assert stats["gat_attention_fwd"].twin_calls == (0 if dropped else 2)
