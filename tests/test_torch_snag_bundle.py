"""Port SNAG fused loss bundle (mixture twins) vs the JAX package.

``mixture_lse_twin`` and ``mixture_grad_twin`` (``snag_tpu_torch/ops/cuda/
snag_loss.py``) are what CPU tensors run in ``snag_bundle_losses``; the
CUDA kernels are held against them on the card (``chip_smoke.py``,
``test_torch_cuda.py``).  The function-level reference is the JAX
package's ``snag_bundle_losses`` with its Pallas mixture kernels in
interpret mode (as tests/test_snag_bundle.py:82 runs them); the model-level
one is the JAX SNAG with ``fused_snag_loss=1`` on the CPU (its dense
bundle), weights carried across, noise and dropout off.

Tolerances: bundle values rtol = atol = 3e-5 and gradients rtol = atol =
2e-4 (tests/test_snag_bundle.py's own); the SNAG loss, aux terms and every
parameter gradient rtol = 1e-4, atol = 1e-5 (a whole encoder of f32 sums in
another order); the port's fused and unfused losses within rel 1e-4.
"""

import dataclasses
import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import snag_tpu.ops.pallas.snag_loss_kernel as sk
from snag_tpu.losses.contrastive import \
    snag_bundle_losses as jax_snag_bundle_losses
from snag_tpu.models import build_model as jax_build_model
from snag_tpu_torch.losses.contrastive import snag_bundle_losses
from snag_tpu_torch.ops.cuda import ntxent as tnx
from snag_tpu_torch.ops.cuda import snag_loss as tsl
from snag_tpu_torch.utils.import_reference import state_dict_from_flax
from torch_port_common import (padded_batch, single_thread, small_argv,
                               model_pair)

single_thread()
VAL_TOL = dict(rtol=3e-5, atol=3e-5)
GRAD_TOL = dict(rtol=2e-4, atol=2e-4)
SNAG_TOL = dict(rtol=1e-4, atol=1e-5)
NAMES = ("d_zis", "d_zjs", "d_a_i", "d_a_j", "d_beta", "d_w_min")


def _bundle_inputs(m, b, d, seed):
    """Unit rows with near-copy positives (one all-zero modality row),
    unit attention rows, beta on the simplex, positive w_min, the last
    rows padding."""
    rng = np.random.default_rng(seed)

    def unit(shape):
        x = rng.normal(size=shape)
        return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)
    zis = unit((m, b, d))
    zjs = unit((m, b, d)) + zis
    zjs /= np.linalg.norm(zjs, axis=-1, keepdims=True)
    zis[1, 2] = 0.0                                   # an all-zero row
    a_i = np.abs(unit((b, m)))
    a_j = np.abs(unit((b, m)))
    u = np.abs(rng.normal(size=(m,))).astype(np.float32) + 0.1
    beta = (u / u.sum()).astype(np.float32)
    w_min = np.abs(rng.normal(size=(m, b))).astype(np.float32)
    valid = np.arange(b) < b - 5
    cot = np.linspace(0.5, 1.5, m + 2).astype(np.float32)
    return (zis, zjs, a_i, a_j, beta, w_min), valid, cot


@pytest.mark.parametrize("m", [4, 6])
def test_bundle_twins_match_jax_pallas_interpret(m):
    _check_bundle_against_jax(m, 12, 8, seed=m)


def test_bundle_twins_match_jax_past_the_f32_accumulator():
    """d = 1,600: past the ~1,500 columns of the f32 gradient kernel's
    shared accumulator on the card, where it takes one modality a block on
    its wide body (``modality_group``), held there to the twins that this
    test holds to the JAX package."""
    assert tsl.modality_group(4, 1600, 1486) == (1, True)
    _check_bundle_against_jax(4, 12, 1600, seed=16, rows=24)


def _check_bundle_against_jax(m, b, d, seed, rows=8):
    """The port's bundle on the CPU (the twins) against the JAX package's
    with its Pallas kernels in interpret mode (row tiles of ``rows``):
    values and the gradients of every input, at the file's tolerances."""
    diff, valid, cot = _bundle_inputs(m, b, d, seed=seed)
    tau, ab = 0.1, 0.6

    def jloss(*args):
        per = jax_snag_bundle_losses(*args[:5], w_min=args[5],
                                     valid=jnp.asarray(valid), tau=tau,
                                     ab_weight=ab)
        return (per * jnp.asarray(cot)).sum(), per
    with mock.patch.object(sk, "FORCE_INTERPRET", True), \
            mock.patch.object(sk, "RT_F", rows), \
            mock.patch.object(sk, "RT_B", rows):
        (_, want), want_g = jax.value_and_grad(
            jloss, argnums=tuple(range(6)), has_aux=True)(
                *map(jnp.asarray, diff))

    ts = [torch.from_numpy(a).requires_grad_() for a in diff]
    before = (tsl.STATS_LSE.twin_calls, tsl.STATS_GRAD.twin_calls)
    per = snag_bundle_losses(*ts[:5], w_min=ts[5],
                             valid=torch.from_numpy(valid), tau=tau,
                             ab_weight=ab)
    (per * torch.from_numpy(cot)).sum().backward()
    assert (tsl.STATS_LSE.twin_calls, tsl.STATS_GRAD.twin_calls) == (
        before[0] + 1, before[1] + 1)
    np.testing.assert_allclose(per.detach().numpy(), np.asarray(want),
                               **VAL_TOL)
    for t, w, name in zip(ts, want_g, NAMES):
        assert np.isfinite(t.grad.numpy()).all(), name
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   err_msg=name, **GRAD_TOL)


def test_twins_agree_with_the_dense_channels_and_autograd():
    """The lse twin is the logsumexp of the masked dense channels, and the
    gradient twin (G + G^T fold, halved dbeta) equals autograd of the loss
    written densely, with and without padding."""
    m, b, d, tau = 3, 10, 6, 0.1
    (zis, zjs, a_i, a_j, beta, _), valid, _ = _bundle_inputs(m, b, d, seed=9)
    z = torch.cat([torch.from_numpy(zis), torch.from_numpy(zjs)], dim=1)
    alpha = torch.cat([torch.from_numpy(a_i), torch.from_numpy(a_j)])
    beta = torch.from_numpy(beta)
    rng = np.random.default_rng(1)
    for v in (torch.ones(2 * b), torch.from_numpy(
            np.concatenate([valid, valid]).astype(np.float32))):
        coef = torch.from_numpy(rng.uniform(0.1, 1.0, size=(m + 2, 2 * b))
                                .astype(np.float32)) * v
        zz, aa, bb = (t.clone().requires_grad_() for t in (z, alpha, beta))
        s = tsl._channels(zz, aa, bb) / tau
        s = s - 1e30 * torch.eye(2 * b) - 1e30 * (1 - v)[None, None, :]
        lse = torch.logsumexp(s, dim=2)
        rows = torch.arange(2 * b)
        pos = s[:, rows, (rows + b) % (2 * b)]
        (coef * (lse - pos)).sum().backward()
        got_lse = tsl.mixture_lse_twin(z, alpha, beta, v, tau)
        np.testing.assert_allclose(got_lse.numpy(), lse.detach().numpy(),
                                   rtol=1e-5, atol=1e-5)
        dz, da, db = tsl.mixture_grad_twin(z, alpha, beta, got_lse, coef, v,
                                           tau)
        for got, want in ((dz, zz.grad), (da, aa.grad), (db, bb.grad)):
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                                       atol=1e-5)


def test_wrappers_dispatch_and_refuse():
    z = torch.zeros(7, 4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        tsl.mixture_lse_cuda(z, torch.zeros(4, 7), torch.zeros(7),
                             torch.ones(4), 0.1)
    # past one modality's fit (250 feature tiles, 185 a block): one
    # modality a block, on the wide body
    assert tsl.modality_group(4, 2000, 1486) == (1, True)
    # M = 4 at d = 300: one group; M = 6: two groups of three
    assert tsl.modality_group(4, 300, 1486) == (4, False)
    assert tsl.modality_group(6, 300, 1486) == (3, False)
    assert tsl.modality_group(6, 1200, 1486) == (1, False)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """All six modalities: with four, two weight_raw slots have a
    gradient that is zero in exact arithmetic (ROADMAP C)."""
    return model_pair(str(tmp_path_factory.mktemp("bundle")), fused_snag_loss=1,
                     use_surface=1)


def _jax_loss(pair, links, valid):
    model = jax_build_model(pair["jcfg"], pair["jdata"])

    def f(p):
        return model.apply({"params": p}, jnp.asarray(links),
                           jnp.asarray(valid), pair["jfeats"],
                           pair["jdata"].graph, deterministic=True)
    (loss, aux), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
        pair["params"])
    return float(loss), jax.device_get(aux), jax.device_get(grads)


def test_fused_snag_loss_aux_and_param_grads_match_jax(pair):
    links, valid = padded_batch(pair["tdata"].train_ill, 24, 20)
    want, want_aux, want_g = _jax_loss(pair, links, valid)
    model = pair["tmodel"]
    model.zero_grad()
    before = (tsl.STATS_GRAD.twin_calls, tnx.STATS_GRAD.twin_calls)
    loss, aux = model(torch.from_numpy(links), torch.from_numpy(valid),
                      pair["tfeats"], pair["tgraph"])
    loss.backward()
    # the bundle once (GMI + ECIA), NT-Xent once (IIR)
    assert (tsl.STATS_GRAD.twin_calls, tnx.STATS_GRAD.twin_calls) == (
        before[0] + 1, before[1] + 1)
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


def test_fused_and_unfused_port_losses_agree(pair):
    model = pair["tmodel"]
    links, valid = padded_batch(pair["tdata"].train_ill, 24, 17)
    out = {}
    try:
        for flag in (1, 0):
            model.cfg = dataclasses.replace(model.cfg, fused_snag_loss=flag)
            with torch.no_grad():
                loss, aux = model(torch.from_numpy(links),
                                  torch.from_numpy(valid), pair["tfeats"],
                                  pair["tgraph"])
            out[flag] = (loss.item(), aux["joint_Intra_modal"].item(),
                         aux["Intra_modal"].item())
    finally:
        model.cfg = dataclasses.replace(model.cfg, fused_snag_loss=1)
    np.testing.assert_allclose(out[1], out[0], rtol=1e-4)


def test_cpu_train_mmea_with_the_default_fused_loss(tmp_path):
    """``train_mmea`` at the default ``--fused_snag_loss 1`` on the CPU:
    the bundle's twins run, the losses fall, the metrics are in range."""
    from snag_tpu_torch.cli.train_mmea import main
    from snag_tpu_torch.config import build_argparser
    assert build_argparser().parse_args([]).fused_snag_loss == 1
    before = tsl.STATS_GRAD.twin_calls
    runner = main(small_argv(tmp_path, epoch=6, eval_epoch=3, batch_size=32,
                              lr=5e-4, scheduler="cos"))
    assert tsl.STATS_GRAD.twin_calls > before
    losses = runner.loss_log.loss[1:]
    assert len(losses) == 6 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    res = runner.last_result
    for v in (*res.acc_l2r, *res.acc_r2l, res.mrr_l2r, res.mrr_r2l):
        assert 0.0 <= v <= 1.0
