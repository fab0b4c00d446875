"""The port under ``--dtype bfloat16`` against the JAX package's bf16 path.

The reference is the path the TPU ran: the JAX package with its Pallas
kernels (GAT forward and backward, NT-Xent lse and gradient, the mixture
lse and gradient) in interpret mode on the CPU, as tests/test_torch_gat.py
and tests/test_torch_ntxent.py run them.  The port's twins implement the
Pallas kernels' bf16 rounding points (``ops/cuda/*.py`` docstrings); the
CUDA kernels are held against the twins on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).  Inputs come from numpy
with a seed; bf16 is compared with bf16 only.

Tolerances:
* each kernel output: max |err| <= 4e-3 x max |JAX| per tensor, about one
  bf16 ulp (2^-8) of the output's scale, which covers a rounding that
  flips at one of the cast points (s_src, s_dst, e, d_score, W, K)
  where the two frameworks' f32 sums differ in their last bits;
* the SNAG loss at step 0: relative error <= 1e-3;
* every parameter gradient: max |err| <= 1e-2 x max |JAX| over its
  optimizer group (decay, no_decay, large: ``train.optim.param_label``);
* the losses of three AdamW steps: relative error <= 1e-2.

XLA's CPU backend adds a bf16 reduction (a bias gradient, the transpose of
a broadcast) in bf16, more than a bf16 ulp off the f32 sum of the same
terms (``test_jax_cpu_bf16_reduction``).  That is no rounding point of
the bf16 path
(the port, like an f32 accumulator, adds in f32 and rounds once), and it
puts a few percent of noise into the reference's bias gradients, so the
slice's reference runs its bf16 reductions as f32 accumulation with one
rounding to bf16 (``f32_reductions``).

Noise and dropout are off (``jax.random`` cannot be reproduced), weights
are carried across with ``export_reference_state_dict``'s tree, and all six
modalities run (with four, two ``weight_raw`` slots have a gradient that is
zero in exact arithmetic).  The bf16 ``mma.sync`` schedule of the loss
kernels is emulated at the end, against an f64 evaluation.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import snag_tpu.ops.pallas.ntxent_kernel as nk
from snag_tpu.data.graph import build_graph as jax_build_graph
from snag_tpu.losses.contrastive import \
    snag_bundle_losses as jax_snag_bundle_losses
from snag_tpu.models import build_model as jax_build_model
from snag_tpu.ops.gat_attn_primitive import gat_attention as jax_gat_attention
from snag_tpu.train.optim import build_optimizer as jax_build_optimizer
from snag_tpu_torch.cli.train_mmea import main as port_main
from snag_tpu_torch.data.graph import build_graph
from snag_tpu_torch.losses.contrastive import snag_bundle_losses
from snag_tpu_torch.ops.cuda import gat_attention as tga
from snag_tpu_torch.ops.cuda import gat_bwd as tgb
from snag_tpu_torch.ops.cuda import ntxent as tnx
from snag_tpu_torch.ops.cuda import rank_eval as trk
from snag_tpu_torch.ops.cuda import snag_loss as tsl
from snag_tpu_torch.ops.cuda import tile_segment as tts
from snag_tpu_torch.ops.gat_agg import gat_aggregate
from snag_tpu_torch.ops.gat_attn_primitive import gat_attention
from snag_tpu_torch.train.optim import param_label
from snag_tpu_torch.train.step import TrainStep
from snag_tpu_torch.utils.import_reference import state_dict_from_flax
from torch_port_common import (assert_close_bf16, bf16_np, f32_reductions,
                               model_pair, padded_batch, pallas_interpret,
                               single_thread, small_argv)

single_thread()
KERNEL_TOL = 4e-3       # x max |JAX| per output tensor
LOSS_RTOL = 1e-3        # the SNAG loss at step 0
GRAD_TOL = 1e-2         # x max |JAX| per optimizer group of parameters
STEPS_RTOL = 1e-2       # the losses of three AdamW steps
TAU = 0.1
BF16 = torch.bfloat16


def test_jax_cpu_bf16_reduction():
    """The bias gradient of a bf16 ``x + b`` over 4,000 rows: XLA's CPU
    backend sums it in bf16, more than a bf16 ulp (2^-7 relative) off the
    f64 sum of the same bf16 terms in some column; under
    ``f32_reductions`` every column is that sum rounded once to bf16."""
    g = bf16_np(np.random.default_rng(0).normal(size=(4000, 8)).astype(
        np.float32))
    want = g.astype(np.float64).sum(axis=0)

    def bias_grad():
        _, vjp = jax.vjp(lambda b: jnp.zeros((4000, 8), jnp.bfloat16) + b,
                         jnp.zeros((8,), jnp.bfloat16))
        return np.asarray(jax.jit(lambda c: vjp(c)[0])(
            jnp.asarray(g, jnp.bfloat16)), np.float64)
    plain = bias_grad()
    with f32_reductions():
        fixed = bias_grad()
    assert (np.abs(plain - want) > 2.0 ** -7 * np.abs(want)).any()
    np.testing.assert_array_equal(fixed, bf16_np(want.astype(np.float32)))


# --------------------------------------------------------------- GAT kernels

def _gat_inputs(n=300, n_tri=900, c=48, h=2, seed=5):
    rng = np.random.default_rng(seed)
    tri = [(int(rng.integers(n)), 0, int(rng.integers(n)))
           for _ in range(n_tri)]
    # a hub row past the tiled grid's chunk cap: the tiled run spills
    tri += [(int(rng.integers(n)), 0, 7) for _ in range(300)]
    x = bf16_np(rng.normal(size=(n, c)).astype(np.float32))
    s_src = rng.normal(size=(n, h)).astype(np.float32)
    s_dst = rng.normal(size=(n, h)).astype(np.float32)
    g_agg = rng.normal(size=(n, h, c)).astype(np.float32)
    g_rs = rng.normal(size=(n, h)).astype(np.float32)
    return n, tri, x, s_src, s_dst, g_agg, g_rs


@pytest.mark.parametrize("flat", [False, True])
def test_gat_forward_twin_matches_pallas_bf16(flat):
    n, tri, x, s_src, s_dst, _, _ = _gat_inputs()
    with pallas_interpret(flat):
        want = jax_gat_attention(jnp.asarray(x, jnp.bfloat16),
                                 jnp.asarray(s_src), jnp.asarray(s_dst),
                                 jax_build_graph(n, tri))
    before = tga.STATS_BF16.twin_calls
    got = gat_attention(torch.from_numpy(x).to(BF16),
                        torch.from_numpy(s_src), torch.from_numpy(s_dst),
                        build_graph(n, tri).to_torch("cpu"))
    assert tga.STATS_BF16.twin_calls == before + 1
    for a, b, name in zip(got, want, ("agg", "rowsum")):
        assert a.dtype == torch.float32 and b.dtype == jnp.float32
        assert_close_bf16(a, b, name)


@pytest.mark.parametrize("flat,h", [(True, 2), (False, 2), (True, 1)])
def test_gat_backward_twin_matches_pallas_bf16(flat, h):
    n, tri, x, s_src, s_dst, g_agg, g_rs = _gat_inputs(h=h, seed=6 + h)
    jg = jax_build_graph(n, tri)
    with pallas_interpret(flat):
        _, vjp = jax.vjp(lambda a, b, c: jax_gat_attention(a, b, c, jg),
                         jnp.asarray(x, jnp.bfloat16), jnp.asarray(s_src),
                         jnp.asarray(s_dst))
        want = vjp((jnp.asarray(g_agg), jnp.asarray(g_rs)))
    xs = [torch.from_numpy(x).to(BF16).requires_grad_(),
          torch.from_numpy(s_src).requires_grad_(),
          torch.from_numpy(s_dst).requires_grad_()]
    before = tgb.STATS_BF16.twin_calls
    agg, rs = gat_attention(*xs, build_graph(n, tri).to_torch("cpu"))
    torch.autograd.backward((agg, rs), (torch.from_numpy(g_agg),
                                        torch.from_numpy(g_rs)))
    assert tgb.STATS_BF16.twin_calls == before + 1
    for t, w, name in zip(xs, want, ("d_x", "d_s_src", "d_s_dst")):
        assert t.grad.dtype == t.dtype and str(w.dtype) == str(t.dtype)[6:]
        assert_close_bf16(t.grad, w, name)


# ------------------------------------------------------- NT-Xent kernels

def _unit(rng, *shape):
    z = rng.normal(size=shape).astype(np.float32)
    return z / np.linalg.norm(z, axis=-1, keepdims=True)


@pytest.mark.parametrize("m,b,d,n_valid", [(2, 40, 32, 33), (1, 64, 17, None)])
def test_ntxent_twins_match_pallas_bf16(m, b, d, n_valid):
    rng = np.random.default_rng(b)
    zis = _unit(rng, m, b, d)
    zjs = zis + 0.3 * _unit(rng, m, b, d)
    zjs /= np.linalg.norm(zjs, axis=-1, keepdims=True)
    zis[0, 2] = 0.0                                   # an all-zero row
    zis, zjs = bf16_np(zis), bf16_np(zjs)
    valid = None if n_valid is None else np.arange(b) < n_valid
    coef_a = rng.uniform(0.1, 1.0, size=(m, b)).astype(np.float32)
    coef_b = rng.uniform(0.1, 1.0, size=(m, b)).astype(np.float32)
    jv = None if valid is None else jnp.asarray(valid)
    with pallas_interpret():
        jz = [jnp.asarray(a, jnp.bfloat16) for a in (zis, zjs)]
        want_lse = nk.streaming_lse(*jz, TAU, jv)
        want_dz = nk.streaming_ntxent_grad(*jz, *want_lse, jnp.asarray(coef_a),
                                           jnp.asarray(coef_b), TAU, jv)
    tz = [torch.from_numpy(a).to(BF16) for a in (zis, zjs)]
    tv = None if valid is None else torch.from_numpy(valid)
    before = (tnx.STATS_LSE_BF16.twin_calls, tnx.STATS_GRAD_BF16.twin_calls)
    got_lse = tnx.streaming_lse(*tz, TAU, tv)
    got_dz = tnx.streaming_ntxent_grad(
        *tz, *[torch.from_numpy(np.asarray(a)) for a in want_lse],
        torch.from_numpy(coef_a), torch.from_numpy(coef_b), TAU, tv)
    assert (tnx.STATS_LSE_BF16.twin_calls, tnx.STATS_GRAD_BF16.twin_calls) \
        == (before[0] + 1, before[1] + 1)
    for a, w, name in zip((*got_lse, *got_dz), (*want_lse, *want_dz),
                          ("lse_a", "lse_b", "d_zis", "d_zjs")):
        assert_close_bf16(a, w, name)


# ------------------------------------------------------- mixture kernels

def _bundle_inputs(m, b, d, seed):
    """Unit rows with near-copy positives and one all-zero modality row
    (bf16), unit attention rows, beta on the simplex, positive w_min, the
    last rows padding."""
    rng = np.random.default_rng(seed)
    zis = _unit(rng, m, b, d)
    zjs = _unit(rng, m, b, d) + zis
    zjs /= np.linalg.norm(zjs, axis=-1, keepdims=True)
    zis[1, 2] = 0.0
    a_i = np.abs(_unit(rng, b, m))
    a_j = np.abs(_unit(rng, b, m))
    u = np.abs(rng.normal(size=(m,))).astype(np.float32) + 0.1
    beta = (u / u.sum()).astype(np.float32)
    w_min = np.abs(rng.normal(size=(m, b))).astype(np.float32)
    valid = np.arange(b) < b - 5
    cot = np.linspace(0.5, 1.5, m + 2).astype(np.float32)
    return (bf16_np(zis), bf16_np(zjs), a_i, a_j, beta, w_min), valid, cot


@pytest.mark.parametrize("m", [4, 6])
def test_mixture_twins_match_pallas_bf16(m):
    """Both mixture kernels through the bundle's custom VJP: the channel
    losses read the lse, every gradient the mixture gradient."""
    diff, valid, cot = _bundle_inputs(m, 12, 8, seed=m)
    ab = 0.6

    def jloss(*args):
        per = jax_snag_bundle_losses(*args[:5], w_min=args[5],
                                     valid=jnp.asarray(valid), tau=TAU,
                                     ab_weight=ab)
        return (per * jnp.asarray(cot)).sum(), per
    jargs = [jnp.asarray(a, jnp.bfloat16 if i < 2 else jnp.float32)
             for i, a in enumerate(diff)]
    with pallas_interpret():
        (_, want), want_g = jax.value_and_grad(
            jloss, argnums=tuple(range(6)), has_aux=True)(*jargs)
    ts = [torch.from_numpy(a) for a in diff]
    ts = [(t.to(BF16) if i < 2 else t).requires_grad_()
          for i, t in enumerate(ts)]
    before = (tsl.STATS_LSE_BF16.twin_calls, tsl.STATS_GRAD_BF16.twin_calls)
    per = snag_bundle_losses(*ts[:5], w_min=ts[5],
                             valid=torch.from_numpy(valid), tau=TAU,
                             ab_weight=ab)
    (per * torch.from_numpy(cot)).sum().backward()
    assert (tsl.STATS_LSE_BF16.twin_calls, tsl.STATS_GRAD_BF16.twin_calls) \
        == (before[0] + 1, before[1] + 1)
    assert_close_bf16(per.detach(), want, "losses")
    for t, w, name in zip(ts, want_g, ("d_zis", "d_zjs", "d_a_i", "d_a_j",
                                       "d_beta", "d_w_min")):
        assert t.grad.dtype == t.dtype
        assert_close_bf16(t.grad, w, name)


# ------------------------------------------------------------- the slice

@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return model_pair(str(tmp_path_factory.mktemp("bf16")), fused_snag_loss=1,
                     use_surface=1, lr=5e-4, scheduler="cos",
                     dtype="bfloat16")


def test_snag_bf16_loss_grads_and_three_steps_match_jax(pair):
    """SNAG's training loss and every parameter gradient at step 0, then
    the losses of three AdamW steps: the port's twins against the JAX
    package's bf16 SNAG with its Pallas paths in interpret mode."""
    total, warmup = 20, 3
    batches = [padded_batch(pair["tdata"].train_ill[k:], 24, n)
               for k, n in ((0, 24), (5, 24), (11, 17))]
    jcfg = pair["jcfg"]
    model = jax_build_model(jcfg, pair["jdata"])
    params = jax.tree_util.tree_map(jnp.asarray, pair["params"])
    tx, _ = jax_build_optimizer(jcfg, params, total, warmup)
    opt_state = tx.init(params)

    def f(q, links, valid):
        return model.apply({"params": q}, links, valid, pair["jfeats"],
                           pair["jdata"].graph, deterministic=True)
    want_losses, want_g0 = [], None
    with pallas_interpret(), f32_reductions():
        grad_fn = jax.jit(jax.value_and_grad(f, has_aux=True))
        for links, valid in batches:
            (loss, _), g = grad_fn(params, jnp.asarray(links),
                                   jnp.asarray(valid))
            if want_g0 is None:
                want_g0 = jax.device_get(g)
            upd, opt_state = tx.update(g, opt_state, params)
            params = optax.apply_updates(params, upd)
            want_losses.append(float(loss))

    # step 0's gradients, on a copy of the model
    tmodel = pair["tmodel"]
    links, valid = batches[0]
    probe = copy.deepcopy(tmodel)
    loss, _ = probe(torch.from_numpy(links), torch.from_numpy(valid),
                    pair["tfeats"], pair["tgraph"])
    loss.backward()
    assert abs(loss.item() - want_losses[0]) <= LOSS_RTOL * abs(
        want_losses[0]), (loss.item(), want_losses[0])
    want_sd = state_dict_from_flax(want_g0)
    named = dict(probe.named_parameters())
    assert set(want_sd) == set(named)
    scale = {}
    for k, w in want_sd.items():
        label = param_label(k)
        scale[label] = max(scale.get(label, 0.0), w.abs().max().item())
    for k, p in named.items():
        assert p.dtype == torch.float32, k          # parameters stay f32
        err = (p.grad - want_sd[k]).abs().max().item()
        assert torch.isfinite(p.grad).all(), k
        assert err <= GRAD_TOL * scale[param_label(k)], (
            k, err, param_label(k), scale[param_label(k)])

    tcfg = dataclasses.replace(pair["tcfg"], add_noise=0)
    step = TrainStep(tcfg, tmodel, tcfg.lr, total, warmup)
    got_losses = [step(torch.from_numpy(l), torch.from_numpy(v),
                       pair["tfeats"], pair["tgraph"], epoch=0,
                       deterministic=True)[0].item() for l, v in batches]
    np.testing.assert_allclose(got_losses, want_losses, rtol=STEPS_RTOL)
    assert all(p.dtype == torch.float32 for p in tmodel.parameters())


def test_bf16_encoder_dtypes_follow_jax(pair):
    """The rounding points' dtypes: bf16 projections, hidden states and
    loss rows; f32 GAT rows, weights and joint embeddings."""
    enc = pair["tmodel"].multimodal_encoder
    with torch.no_grad():
        out = enc(pair["tfeats"], pair["tgraph"])
    assert out.gph.dtype == torch.float32
    for e in (out.img, out.rel, out.att, out.name, out.char, out.hidden):
        assert e.dtype == BF16
    for e in (out.joint, out.joint_fz, out.weight_norm, out.weight_fz):
        assert e.dtype == torch.float32
    assert enc.entity_emb.weight.dtype == torch.float32


def test_cli_trains_and_serves_bf16_on_cpu(tmp_path):
    """``train_mmea --dtype bfloat16`` on the CPU (twins): training with IL
    promotion and a saved model, then ``--only_test 1`` from it."""
    argv = small_argv(tmp_path, dtype="bfloat16", epoch=12, il="",
                      il_start=2, semi_learn_step=1, eval_epoch=4,
                      batch_size=32, lr=5e-4, scheduler="cos", add_noise=1,
                      noise_ratio=0.2, mask_ratio=0.7, use_surface=1,
                      save_model=1, exp_id="bf16")
    before = {s.name: s.twin_calls for s in
              (tga.STATS_BF16, tgb.STATS_BF16, tnx.STATS_GRAD_BF16,
               tsl.STATS_GRAD_BF16, tga.STATS, tgb.STATS, tnx.STATS_GRAD,
               tsl.STATS_GRAD)}
    runner = port_main(argv)
    after = {s.name: s.twin_calls for s in
             (tga.STATS_BF16, tgb.STATS_BF16, tnx.STATS_GRAD_BF16,
              tsl.STATS_GRAD_BF16, tga.STATS, tgb.STATS, tnx.STATS_GRAD,
              tsl.STATS_GRAD)}
    for name in before:                 # bf16 entries only, every one
        assert (after[name] > before[name]) == name.endswith("_bf16"), name
    losses = runner.loss_log.loss[1:]
    assert len(losses) == 12 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    assert runner.promoted and runner.promoted[0] > 0
    res = runner.last_result
    for v in (*res.acc_l2r, *res.acc_r2l, res.mrr_l2r, res.mrr_r2l):
        assert 0.0 <= v <= 1.0
    served = port_main(small_argv(tmp_path, dtype="bfloat16", use_surface=1,
                                  only_test=1, model_name_save="bf16"))
    assert served.last_result.mrr_l2r == pytest.approx(res.mrr_l2r, abs=0.05)


# -------------------------------------------------------------- refusals

def test_bf16_gcn_and_f32_only_entries_refuse():
    """The bf16 GCN's aggregation refuses a mix of f32 and bf16 operands
    and more than one bf16 head; the f32-only entries refuse bf16."""
    g = build_graph(4, [(0, 0, 1), (2, 0, 3)]).to_torch("cpu")
    x = torch.zeros(4, 8, dtype=BF16)
    with pytest.raises(TypeError, match="both float32 or both bfloat16"):
        tts.weighted_segment_sum(x, g.w[:, None], g)
    with pytest.raises(TypeError, match="both float32 or both bfloat16"):
        tts.weighted_segment_sum(x.float(), g.w_bf16[:, None], g)
    with pytest.raises(NotImplementedError,
                       match="ROADMAP A: bf16 multi-head aggregation"):
        gat_aggregate(x, g.w_bf16[:, None].repeat(1, 2), g)
    with pytest.raises(TypeError, match="bf16"):
        trk.streaming_rank_eval(x, x, 3, True, False)
    with pytest.raises(TypeError):
        tnx.streaming_lse(torch.zeros(1, 4, 8, dtype=torch.float16),
                          torch.zeros(1, 4, 8, dtype=torch.float16), TAU,
                          None)
    with pytest.raises(ValueError, match="CUDA"):
        tga.gat_attention_cuda(x, torch.zeros(4, 1), torch.zeros(4, 1), g)


# ------------------------------------------- the bf16 mma.sync, emulated

def _round_to_zero_f32(x64):
    """f64 values to f32 rounded toward zero: the tensor cores truncate
    when they accumulate a product's terms."""
    r = x64.astype(np.float32)
    over = np.abs(r.astype(np.float64)) > np.abs(x64)
    return np.where(over, np.nextafter(r, np.float32(0)), r)


def mm_k16(a, b):
    """(M, R, d) x (M, d, C) of bf16 values the way the kernels take them:
    per k16 slice one m16n8k16 product from zero (exact products, its sum
    truncated to f32), each slice's result added in f32 in k order."""
    d = a.shape[2]
    out = np.zeros((a.shape[0], a.shape[1], b.shape[2]), np.float32)
    for k0 in range(0, d, 16):
        part = np.matmul(a[:, :, k0:k0 + 16].astype(np.float64),
                         b[:, k0:k0 + 16, :].astype(np.float64))
        out = (out + _round_to_zero_f32(part)).astype(np.float32)
    return out


def mm_wz(w, z):
    """(M, R, n2) x (M, n2, d) the way the bf16 gradient kernels take W z
    (csrc/gram_grad_bf16.cuh: W in registers as the A fragments of a
    warp's 16-row strip): per column tile of ``WZ_COLS`` = 64, its four k16
    slices accumulate in one m16n8k16 accumulator from zero (truncating),
    and each tile's sum is added in f32, in column order."""
    cols, ks = tnx.WZ_COLS, tnx.KSLICE
    out = np.zeros((w.shape[0], w.shape[1], z.shape[2]), np.float32)
    for c0 in range(0, w.shape[2], cols):
        part = np.zeros(out.shape, np.float32)
        for k0 in range(c0, min(c0 + cols, w.shape[2]), ks):
            part = _round_to_zero_f32(
                part.astype(np.float64)
                + np.matmul(w[:, :, k0:k0 + ks].astype(np.float64),
                            z[:, k0:k0 + ks, :].astype(np.float64)))
        out = (out + part).astype(np.float32)
    return out


def mm_f64(a, b):
    return np.matmul(a.astype(np.float64), b.astype(np.float64))


def _round_bf16(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
        BF16).to(torch.float32).numpy()


@pytest.mark.parametrize("m,b,d", [(4, 48, 300), (6, 40, 64), (2, 100, 1800)])
def test_bf16_mma_schedule_is_far_inside_the_card_limit(m, b, d):
    """K = z z^T (both lse kernels and both gradients: k16 slices from zero,
    truncated, added in f32) and W z (the gradients: a 64-column tile's
    four k16 slices in one accumulator, the tiles added in f32) on bf16
    operands, against f64 products of the same operands: within 1e-5 x
    max, 400x inside the card's 4e-3 limit, so that the limit measures the
    kernels' bf16 rounding points, not their accumulation.  The gradient
    kernels' whole order of adds, column splits included, is
    tests/test_torch_grad_bf16_schedule.py's."""
    rng = np.random.default_rng(m * b)
    z = _unit(rng, m, 2 * b, d)
    z[:, b:] = z[:, :b] + 0.5 * z[:, b:]
    z = _round_bf16(z / np.linalg.norm(z, axis=-1, keepdims=True))
    z[min(1, m - 1), 5] = 0.0
    zt = np.ascontiguousarray(z.transpose(0, 2, 1))
    k64, k16 = mm_f64(z, zt), mm_k16(z, zt)
    assert np.abs(k16 - k64).max() <= 1e-5 * np.abs(k64).max()
    # the gradient's W, rounded to bf16 as the kernel rounds it
    v = np.concatenate([np.arange(b) < b - 3] * 2).astype(np.float32)
    coef = (rng.uniform(0.1, 1.0, size=(m, 2 * b)) * v / b).astype(np.float32)
    tz = torch.from_numpy(z).to(BF16)
    lse = tnx.streaming_lse_twin(tz, torch.from_numpy(v), TAU)
    s = k64 / TAU
    n2 = 2 * b
    rows = np.arange(n2)
    pos = np.where(rows < b, rows + b, rows - b)
    lse = lse.numpy().astype(np.float64)
    p_row = np.exp(np.minimum(s - lse[:, :, None], 0.0))
    p_col = np.exp(np.minimum(s - lse[:, None, :], 0.0))
    w = ((rows[:, None] != rows[None, :])[None]
         * (coef[:, :, None] * p_row * v[None, None, :]
            + p_col * coef[:, None, :] * v[None, :, None])
         - (rows[None, :] == pos[:, None])[None]
         * (coef[:, :, None] + coef[:, None, :])) / TAU
    wb = _round_bf16(w)
    p64, p16 = mm_f64(wb, z), mm_wz(wb, z)
    assert np.abs(p16 - p64).max() <= 1e-5 * np.abs(p64).max()
