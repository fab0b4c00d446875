"""Port GCN structure encoder vs the JAX package.

``weighted_segment_sum_twin`` (``snag_tpu_torch/ops/cuda/tile_segment.py``)
is what CPU tensors run in ``gat_aggregate``'s forward and backward; the
CUDA kernel is held against it on the card (``chip_smoke.py``,
``test_torch_cuda.py``).  References: the JAX package's
``tile_weighted_segment_sum`` in interpret mode (as
tests/test_tile_segment.py:40-75 runs it), ``jax.vjp`` of its
``gat_aggregate``, its ``GCN`` and its SNAG with ``structure_encoder="gcn"``
(weights carried across, noise and dropout off).

Tolerances: the segment sum and ``gat_aggregate`` rtol = atol = 1e-5 (f32
sums in another order); the SNAG loss, ``joint_emb`` and every parameter
gradient rtol = 1e-4, atol = 1e-5 (a whole encoder of f32 sums).

bf16 (``--dtype bfloat16``), against the JAX package's bf16 GCN with its
Pallas segment kernel in interpret mode (``gat_agg.pallas_available``
patched on here, as ``pallas_interpret`` does not): the segment sum and
``gat_aggregate``'s forward rtol = atol = 1e-5 (bf16 products are exact in
f32, and both sides add them in f32); ``gat_aggregate``'s d_x, a bf16
output after a bf16 rounding of each edge's term, max |err| <= 4e-3 x max
|JAX| (about one bf16 ulp of its scale: a term whose f32 product rounds
the other way); the ``GCN`` module's output, input gradient and every
parameter gradient, max |err| <= 1e-2 x max |JAX| per tensor; SNAG's
step-0 loss relative error <= 1e-3 and every parameter gradient max |err|
<= 1e-2 x max |JAX| over its optimizer group (the bf16 limits of
``test_torch_bf16.py``), with the reference's bf16 reductions run as f32
sums (``f32_reductions``).
"""

import contextlib
import dataclasses
import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import snag_tpu.ops.gat_agg as jax_gat_agg
import snag_tpu.ops.pallas.tile_segment as tsg
from snag_tpu.data.graph import build_graph as jax_build_graph
from snag_tpu.models import build_model as jax_build_model
from snag_tpu.models.snag import SNAG as JaxSNAG
from snag_tpu.ops.gat_agg import gat_aggregate as jax_gat_aggregate
from snag_tpu.ops.gnn import GCN as JaxGCN
from snag_tpu_torch.data.graph import build_graph
from snag_tpu_torch.ops.cuda import tile_segment as tts
from snag_tpu_torch.ops.gat_agg import gat_aggregate, reverse_weights
from snag_tpu_torch.ops.gnn import GCN
from snag_tpu_torch.train.optim import param_label
from snag_tpu_torch.utils.import_reference import state_dict_from_flax
from torch_port_common import (assert_close_bf16, bf16_np, f32_reductions,
                               model_pair, padded_batch, pallas_interpret,
                               single_thread, small_argv)

single_thread()
TOL = dict(rtol=1e-5, atol=1e-5)
SNAG_TOL = dict(rtol=1e-4, atol=1e-5)
BF16 = torch.bfloat16
KERNEL_TOL = 4e-3       # x max |JAX|: a bf16 kernel output
MODULE_TOL = 1e-2       # x max |JAX| per tensor: the bf16 GCN module
LOSS_RTOL = 1e-3        # the bf16 SNAG loss at step 0
GRAD_TOL = 1e-2         # x max |JAX| per optimizer group of parameters


def _triples(n, n_tri, seed, hubs=False):
    rng = np.random.default_rng(seed)
    tri = [(int(rng.integers(n)), 0, int(rng.integers(n)))
           for _ in range(n_tri)]
    if hubs:   # a hub row past the tiled grid's chunk cap
        tri += [(7, 0, int(rng.integers(n))) for _ in range(300)]
    return tri


def _padded(jg, e):
    """Port edge values (E, H) in the JAX graph's padded edge order."""
    out = np.zeros((jg.e_pad, e.shape[1]), np.float32)
    out[jg.mask] = e
    return out


def _tile_structure(jg):
    return tsg.TileStructure(
        chunk_base=jg.rt_chunk_base, nc=jg.rt_nc, spill_sel=jg.rt_spill_sel,
        spill_row=jg.rt_spill_row, n_tiles=jg.rt_n_tiles,
        max_chunks=jg.rt_max_chunks, n_spill=jg.rt_n_spill,
        flat_tile=jg.rt_flat_tile, flat_chunk=jg.rt_flat_chunk,
        flat_first=jg.rt_flat_first, n_flat=jg.rt_n_flat)


@contextlib.contextmanager
def jax_gcn_pallas(flat=None):
    """The JAX package's Pallas paths in interpret mode, its GCN's
    aggregation (``gat_agg._row_reduce`` and ``_col_reduce``) included."""
    with pallas_interpret(flat), mock.patch.object(
            jax_gat_agg, "pallas_available", lambda: True):
        yield


@pytest.mark.parametrize("flat", [False, True])
def test_segment_sum_twin_matches_jax_pallas_interpret(flat):
    n, c, h = 200, 40, 3
    tri = _triples(n, 500, seed=3, hubs=True)
    jg, tg = jax_build_graph(n, tri), build_graph(n, tri)
    rng = np.random.default_rng(7)
    x = rng.normal(size=(n, c)).astype(np.float32)
    e = rng.uniform(0.1, 2.0, size=(tg.n_edges, h)).astype(np.float32)
    with pallas_interpret(flat):
        want_agg, want_rs = tsg.tile_weighted_segment_sum(
            jnp.asarray(x)[jnp.asarray(jg.col)], jnp.asarray(_padded(jg, e)),
            jnp.asarray(jg.row), _tile_structure(jg), n)

    before = (tts.STATS.launches, tts.STATS.twin_calls)
    agg, rs = tts.weighted_segment_sum(torch.from_numpy(x),
                                       torch.from_numpy(e), tg.to_torch("cpu"))
    assert (tts.STATS.launches, tts.STATS.twin_calls) == (before[0],
                                                          before[1] + 1)
    np.testing.assert_allclose(agg.numpy(), np.asarray(want_agg), **TOL)
    np.testing.assert_allclose(rs.numpy(), np.asarray(want_rs), **TOL)


@pytest.mark.parametrize("h", [1, 2])
def test_gat_aggregate_forward_and_dx_match_jax_vjp(h):
    """Forward outputs and d_x; the backward walks the reverse edges."""
    n, c = 150, 24
    tri = _triples(n, 450, seed=h)
    jg, tg = jax_build_graph(n, tri), build_graph(n, tri)
    rng = np.random.default_rng(11)
    x = rng.normal(size=(n, c)).astype(np.float32)
    e = rng.uniform(0.5, 1.5, size=(tg.n_edges, h)).astype(np.float32)
    g_agg = rng.normal(size=(n, h, c)).astype(np.float32)
    g_rs = rng.normal(size=(n, h)).astype(np.float32)

    @jax.jit
    def jrun(xx, ee, ga, gr):
        out, vjp = jax.vjp(lambda a: jax_gat_aggregate(a, ee, jg), xx)
        return out, vjp((ga, gr))[0]
    (want_agg, want_rs), want_dx = jrun(
        jnp.asarray(x), jnp.asarray(_padded(jg, e)), jnp.asarray(g_agg),
        jnp.asarray(g_rs))

    xt = torch.from_numpy(x).requires_grad_()
    agg, rs = gat_aggregate(xt, torch.from_numpy(e), tg.to_torch("cpu"))
    ((agg * torch.from_numpy(g_agg)).sum()
     + (rs * torch.from_numpy(g_rs)).sum()).backward()
    np.testing.assert_allclose(agg.detach().numpy(), np.asarray(want_agg), **TOL)
    np.testing.assert_allclose(rs.detach().numpy(), np.asarray(want_rs), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_dx), **TOL)


def test_gat_aggregate_dx_with_cached_reverse_weights_matches_jax_vjp():
    """The GCN's e is the graph's adjacency w: the backward takes w[rev]
    from ``DeviceGraph.w_rev`` (gathered once per graph) and d_x must
    still match ``jax.vjp``; any other e is gathered at rev."""
    n, c = 150, 24
    tri = _triples(n, 450, seed=9, hubs=True)
    jg, tg = jax_build_graph(n, tri), build_graph(n, tri)
    dg = tg.to_torch("cpu")
    np.testing.assert_array_equal(dg.w_rev.numpy(), tg.w[tg.rev])
    e = dg.w[:, None]
    assert reverse_weights(e, dg).data_ptr() == dg.w_rev.data_ptr()
    other = e.clone()
    assert reverse_weights(other, dg).data_ptr() != dg.w_rev.data_ptr()
    torch.testing.assert_close(reverse_weights(other, dg), other[dg.rev],
                               rtol=0, atol=0)
    rng = np.random.default_rng(13)
    x = rng.normal(size=(n, c)).astype(np.float32)
    g_agg = rng.normal(size=(n, 1, c)).astype(np.float32)
    g_rs = rng.normal(size=(n, 1)).astype(np.float32)

    @jax.jit
    def jrun(xx, ga, gr):
        out, vjp = jax.vjp(lambda a: jax_gat_aggregate(
            a, jnp.asarray(jg.w)[:, None], jg), xx)
        return out, vjp((ga, gr))[0]
    (want_agg, want_rs), want_dx = jrun(jnp.asarray(x), jnp.asarray(g_agg),
                                        jnp.asarray(g_rs))

    xt = torch.from_numpy(x).requires_grad_()
    agg, rs = gat_aggregate(xt, e, dg)
    ((agg * torch.from_numpy(g_agg)).sum()
     + (rs * torch.from_numpy(g_rs)).sum()).backward()
    np.testing.assert_allclose(agg.detach().numpy(), np.asarray(want_agg), **TOL)
    np.testing.assert_allclose(rs.detach().numpy(), np.asarray(want_rs), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_dx), **TOL)


def test_reverse_edges_and_refusals():
    n = 60
    tri = _triples(n, 150, seed=4) + [(3, 1, 5), (5, 2, 3), (3, 1, 5)]
    g = build_graph(n, tri)
    assert g.symmetric and g.rev is not None
    np.testing.assert_array_equal(g.row[g.rev], g.col)
    np.testing.assert_array_equal(g.col[g.rev], g.row)
    np.testing.assert_array_equal(g.w[g.rev], g.w)
    dg = g.to_torch("cpu")
    x = torch.ones(n, 4)
    e = dg.w[:, None]
    with pytest.raises(ValueError, match="reverse-edge"):
        gat_aggregate(x, e, dg._replace(rev=None))
    with pytest.raises(ValueError, match="edge weights"):
        gat_aggregate(x, e.clone().requires_grad_(), dg)
    gcn = GCN(4, 4, 4, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="reverse-edge"):
        gcn(x, dg._replace(rev=None))
    assert not dg._replace(rev=None).symmetric
    with pytest.raises(ValueError, match="CUDA"):
        tts.weighted_segment_sum_cuda(x, e, dg)


def test_gcn_module_and_param_grads_match_jax():
    n, c = 120, 16
    tri = _triples(n, 400, seed=6)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(n, c)).astype(np.float32)
    wout = rng.normal(size=(n, c)).astype(np.float32)
    params = {f"gc{i}": {
        "weight": (0.3 * rng.normal(size=(c, c))).astype(np.float32),
        "bias": (0.1 * rng.normal(size=(c,))).astype(np.float32)}
        for i in (1, 2)}
    jgcn = JaxGCN(c, c, c)
    jg = jax_build_graph(n, tri)

    def jloss(p, xx):
        out = jgcn.apply({"params": p}, xx, jg)
        return (out * wout).sum(), out
    (_, want), (want_p, want_x) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))

    gcn = GCN(c, c, c, torch.Generator().manual_seed(0))
    gcn.load_state_dict({f"gc{i}.{k}": torch.from_numpy(v)
                         for i in (1, 2) for k, v in params[f"gc{i}"].items()},
                        strict=True)
    xt = torch.from_numpy(x).requires_grad_()
    out = gcn(xt, build_graph(n, tri).to_torch("cpu"))
    (out * torch.from_numpy(wout)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_x), **TOL)
    for name, p in gcn.named_parameters():
        i, k = name.split(".")
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_p[i][k]),
                                   err_msg=name, **TOL)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return model_pair(str(tmp_path_factory.mktemp("gcn")),
                     structure_encoder="gcn", fused_snag_loss=1, use_surface=1)


def test_snag_gcn_joint_emb_matches_jax(pair):
    want, _ = jax.jit(lambda p: pair["jmodel"].apply(
        {"params": p}, pair["jfeats"], pair["jdata"].graph,
        method=JaxSNAG.joint_emb))(pair["params"])
    with torch.no_grad():
        got, _ = pair["tmodel"].joint_emb(pair["tfeats"], pair["tgraph"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SNAG_TOL)


def test_snag_gcn_loss_and_param_grads_match_jax(pair):
    links, valid = padded_batch(pair["tdata"].train_ill, 24, 20)
    model = jax_build_model(pair["jcfg"], pair["jdata"])

    def f(p):
        return model.apply({"params": p}, jnp.asarray(links),
                           jnp.asarray(valid), pair["jfeats"],
                           pair["jdata"].graph, deterministic=True)
    (want, _), want_g = jax.jit(jax.value_and_grad(f, has_aux=True))(
        pair["params"])

    tmodel = pair["tmodel"]
    tmodel.zero_grad()
    before = tts.STATS.twin_calls
    loss, _ = tmodel(torch.from_numpy(links), torch.from_numpy(valid),
                     pair["tfeats"], pair["tgraph"])
    loss.backward()
    # two layers forward, two backward
    assert tts.STATS.twin_calls == before + 4
    np.testing.assert_allclose(loss.item(), float(want), **SNAG_TOL)
    want_sd = state_dict_from_flax(jax.device_get(want_g))
    named = dict(tmodel.named_parameters())
    assert set(want_sd) == set(named)
    assert "multimodal_encoder.cross_graph_model.gc1.weight" in named
    for k, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(), want_sd[k].numpy(),
                                   err_msg=k, **SNAG_TOL)


def test_cpu_train_mmea_with_the_gcn_encoder(tmp_path):
    from snag_tpu_torch.cli.train_mmea import main
    before = tts.STATS.twin_calls
    runner = main(small_argv(tmp_path, structure_encoder="gcn", epoch=6,
                             eval_epoch=3, batch_size=32, lr=5e-4,
                             scheduler="cos"))
    assert tts.STATS.twin_calls > before
    losses = runner.loss_log.loss[1:]
    assert len(losses) == 6 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    res = runner.last_result
    for v in (*res.acc_l2r, *res.acc_r2l, res.mrr_l2r, res.mrr_r2l):
        assert 0.0 <= v <= 1.0


# ------------------------------------------------------------------ bf16

@pytest.mark.parametrize("flat", [False, True])
def test_segment_sum_bf16_twin_matches_jax_pallas_interpret(flat):
    """bf16 x and e, hub row included: the Pallas kernel's exact products
    added in f32, both outputs f32."""
    n, c, h = 200, 40, 3
    tri = _triples(n, 500, seed=3, hubs=True)
    jg, tg = jax_build_graph(n, tri), build_graph(n, tri)
    rng = np.random.default_rng(17)
    x = bf16_np(rng.normal(size=(n, c)).astype(np.float32))
    e = bf16_np(rng.uniform(0.1, 2.0, size=(tg.n_edges, h)).astype(
        np.float32))
    with pallas_interpret(flat):
        want_agg, want_rs = tsg.tile_weighted_segment_sum(
            jnp.asarray(x, jnp.bfloat16)[jnp.asarray(jg.col)],
            jnp.asarray(_padded(jg, e), jnp.bfloat16), jnp.asarray(jg.row),
            _tile_structure(jg), n)

    before = (tts.STATS_BF16.twin_calls, tts.STATS.twin_calls)
    agg, rs = tts.weighted_segment_sum(torch.from_numpy(x).to(BF16),
                                       torch.from_numpy(e).to(BF16),
                                       tg.to_torch("cpu"))
    assert (tts.STATS_BF16.twin_calls, tts.STATS.twin_calls) == (
        before[0] + 1, before[1])
    assert agg.dtype == rs.dtype == torch.float32
    np.testing.assert_allclose(agg.numpy(), np.asarray(want_agg), **TOL)
    np.testing.assert_allclose(rs.numpy(), np.asarray(want_rs), **TOL)


def test_segment_sum_bf16_round_term_rounds_each_term():
    """``round_term``: each edge's product rounded to bf16, then added in
    f32; held against numpy's f64 sum of the same bf16 terms, where a sum
    of the unrounded products is ~1e-3 off."""
    n, c = 90, 20
    tg = build_graph(n, _triples(n, 300, seed=8, hubs=True))
    rng = np.random.default_rng(29)
    x = bf16_np(rng.normal(size=(n, c)).astype(np.float32))
    e = bf16_np(rng.uniform(0.1, 2.0, size=(tg.n_edges, 1)).astype(
        np.float32))
    terms = bf16_np((e * x[tg.col]).astype(np.float32)).astype(np.float64)
    want = np.zeros((n, c))
    np.add.at(want, tg.row, terms)
    args = (torch.from_numpy(x).to(BF16), torch.from_numpy(e).to(BF16),
            tg.to_torch("cpu"))
    agg, _ = tts.weighted_segment_sum(*args, round_term=True)
    np.testing.assert_allclose(agg[:, 0].numpy(), want, **TOL)
    plain, _ = tts.weighted_segment_sum(*args)
    assert np.abs(plain[:, 0].numpy() - want).max() > 1e-4
    with pytest.raises(ValueError, match="round_term"):
        tts.weighted_segment_sum(torch.from_numpy(x),
                                 torch.from_numpy(e), args[2],
                                 round_term=True)


@pytest.mark.parametrize("flat,adjacency", [(True, True), (False, True),
                                            (True, False), ("xla", True),
                                            ("xla", False)])
def test_gat_aggregate_bf16_forward_and_dx_match_jax_vjp(flat, adjacency):
    """One head (the GCN's): the forward sums, and d_x in bf16 from the
    reverse-edge launch with each edge's term rounded to bf16 and the f32
    sum rounded once to bf16 (the twin's ``out_bf16``, also called on its
    own); on the graph's adjacency the backward takes ``w_rev_bf16``.
    ``flat``: the JAX package's Pallas kernels in interpret mode on either
    grid, or ("xla") its plain segment sums, bf16 reductions run as f32
    sums (``f32_reductions``)."""
    n, c = 150, 24
    tri = _triples(n, 450, seed=21, hubs=True)
    jg, tg = jax_build_graph(n, tri), build_graph(n, tri)
    dg = tg.to_torch("cpu")
    rng = np.random.default_rng(23)
    x = bf16_np(rng.normal(size=(n, c)).astype(np.float32))
    if adjacency:
        e = dg.w_bf16[:, None]
        assert reverse_weights(e, dg).data_ptr() == dg.w_rev_bf16.data_ptr()
    else:
        e = torch.from_numpy(rng.uniform(0.5, 1.5, size=(tg.n_edges, 1)).astype(
            np.float32)).to(BF16)
        assert reverse_weights(e, dg).data_ptr() != dg.w_rev_bf16.data_ptr()
    e_np = e.to(torch.float32).numpy()
    g_agg = rng.normal(size=(n, 1, c)).astype(np.float32)
    g_rs = rng.normal(size=(n, 1)).astype(np.float32)

    @jax.jit
    def jrun(xx, ee, ga, gr):
        out, vjp = jax.vjp(lambda a: jax_gat_aggregate(a, ee, jg), xx)
        return out, vjp((ga, gr))[0]
    with (f32_reductions() if flat == "xla" else jax_gcn_pallas(flat)):
        (want_agg, want_rs), want_dx = jrun(
            jnp.asarray(x, jnp.bfloat16),
            jnp.asarray(_padded(jg, e_np), jnp.bfloat16), jnp.asarray(g_agg),
            jnp.asarray(g_rs))

    xt = torch.from_numpy(x).to(BF16).requires_grad_()
    before = tts.STATS_BF16.twin_calls
    agg, rs = gat_aggregate(xt, e, dg)
    ((agg * torch.from_numpy(g_agg)).sum()
     + (rs * torch.from_numpy(g_rs)).sum()).backward()
    assert tts.STATS_BF16.twin_calls == before + 2
    np.testing.assert_allclose(agg.detach().numpy(), np.asarray(want_agg), **TOL)
    np.testing.assert_allclose(rs.detach().numpy(), np.asarray(want_rs), **TOL)
    assert xt.grad.dtype == BF16 and want_dx.dtype == jnp.bfloat16
    assert_close_bf16(xt.grad, want_dx, "d_x", KERNEL_TOL)
    # the backward's launch alone: the twin's bf16 d_x and no rowsum
    d_x, none = tts.weighted_segment_sum_twin(
        torch.from_numpy(g_agg[:, 0]).to(BF16), reverse_weights(e, dg), dg,
        round_term=True, out_bf16=True)
    assert none is None and d_x.dtype == BF16
    assert torch.equal(d_x[:, 0], xt.grad)
    assert_close_bf16(d_x[:, 0], want_dx, "d_x", KERNEL_TOL)


def test_gcn_bf16_module_and_param_grads_match_jax():
    """``GCN(dtype=bfloat16)``: bf16 support, bf16 adjacency, f32 out."""
    n, c = 120, 16
    tri = _triples(n, 400, seed=6)
    rng = np.random.default_rng(25)
    x = rng.normal(size=(n, c)).astype(np.float32)
    wout = rng.normal(size=(n, c)).astype(np.float32)
    params = {f"gc{i}": {
        "weight": (0.3 * rng.normal(size=(c, c))).astype(np.float32),
        "bias": (0.1 * rng.normal(size=(c,))).astype(np.float32)}
        for i in (1, 2)}
    jgcn = JaxGCN(c, c, c, dtype=jnp.bfloat16)
    jg = jax_build_graph(n, tri)

    def jloss(p, xx):
        out = jgcn.apply({"params": p}, xx, jg)
        return (out * wout).sum(), out
    with jax_gcn_pallas(), f32_reductions():
        (_, want), (want_p, want_x) = jax.jit(jax.value_and_grad(
            jloss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))

    gcn = GCN(c, c, c, torch.Generator().manual_seed(0), dtype=BF16)
    gcn.load_state_dict({f"gc{i}.{k}": torch.from_numpy(v)
                         for i in (1, 2) for k, v in params[f"gc{i}"].items()},
                        strict=True)
    xt = torch.from_numpy(x).requires_grad_()
    before = tts.STATS_BF16.twin_calls
    out = gcn(xt, build_graph(n, tri).to_torch("cpu"))
    (out * torch.from_numpy(wout)).sum().backward()
    assert tts.STATS_BF16.twin_calls == before + 4
    assert out.dtype == torch.float32 and want.dtype == jnp.float32
    assert_close_bf16(out, want, "out", MODULE_TOL)
    assert_close_bf16(xt.grad, want_x, "d_x", MODULE_TOL)
    for name, p in gcn.named_parameters():
        i, k = name.split(".")
        assert p.dtype == torch.float32, name
        assert_close_bf16(p.grad, want_p[i][k], name, MODULE_TOL)


def test_snag_gcn_bf16_loss_and_param_grads_match_jax(tmp_path):
    """SNAG with ``structure_encoder="gcn", dtype="bfloat16"``: the step-0
    loss and every parameter gradient against the JAX package's."""
    pair = model_pair(str(tmp_path), structure_encoder="gcn",
                      fused_snag_loss=1, use_surface=1, dtype="bfloat16")
    links, valid = padded_batch(pair["tdata"].train_ill, 24, 20)
    model = jax_build_model(pair["jcfg"], pair["jdata"])

    def f(p):
        return model.apply({"params": p}, jnp.asarray(links),
                           jnp.asarray(valid), pair["jfeats"],
                           pair["jdata"].graph, deterministic=True)
    with jax_gcn_pallas(), f32_reductions():
        (want, _), want_g = jax.jit(jax.value_and_grad(f, has_aux=True))(
            pair["params"])

    tmodel = pair["tmodel"]
    tmodel.zero_grad()
    before = (tts.STATS_BF16.twin_calls, tts.STATS.twin_calls)
    loss, _ = tmodel(torch.from_numpy(links), torch.from_numpy(valid),
                     pair["tfeats"], pair["tgraph"])
    loss.backward()
    # two layers forward, two backward, all on the bf16 entry
    assert (tts.STATS_BF16.twin_calls, tts.STATS.twin_calls) == (
        before[0] + 4, before[1])
    assert abs(loss.item() - float(want)) <= LOSS_RTOL * abs(float(want)), (
        loss.item(), float(want))
    want_sd = state_dict_from_flax(jax.device_get(want_g))
    named = dict(tmodel.named_parameters())
    assert set(want_sd) == set(named)
    assert "multimodal_encoder.cross_graph_model.gc1.weight" in named
    scale = {}
    for k, w in want_sd.items():
        label = param_label(k)
        scale[label] = max(scale.get(label, 0.0), w.abs().max().item())
    for k, p in named.items():
        assert p.dtype == torch.float32 and torch.isfinite(p.grad).all(), k
        err = (p.grad - want_sd[k]).abs().max().item()
        assert err <= GRAD_TOL * scale[param_label(k)], (
            k, err, param_label(k), scale[param_label(k)])


# the kernel wrappers a bf16 GCN training run goes through (their CPU twins
# here): MCLEA's ICL on the f32 GCN rows and mean-fused joint takes the f32
# NT-Xent, its modalities' the bf16; EVA computes in f32 whatever --dtype
# says
BF16_GCN_KERNELS = {
    "SNAG": {"weighted_segment_sum_bf16", "ntxent_lse_bf16",
             "ntxent_grad_bf16", "mixture_lse_bf16", "mixture_grad_bf16",
             "rank_topk_mean", "rank_counts"},
    "MEAformer": {"weighted_segment_sum_bf16", "ntxent_lse_bf16",
                  "ntxent_grad_bf16", "rank_topk_mean", "rank_counts"},
    "EVA": {"weighted_segment_sum", "rank_topk_mean", "rank_counts"},
}
BF16_GCN_KERNELS["MCLEA"] = BF16_GCN_KERNELS["MEAformer"] | {
    "ntxent_lse", "ntxent_grad"}


@pytest.mark.parametrize("family", ["SNAG", "MCLEA", "MEAformer", "EVA"])
def test_cpu_train_mmea_with_the_bf16_gcn_encoder(tmp_path, family):
    """``train_mmea --dtype bfloat16 --structure_encoder gcn`` trains and
    serves on the CPU through exactly the family's bf16 twins (EVA's f32
    ones), then ``--only_test 1`` from the saved ``.pkl``."""
    from snag_tpu_torch.cli.train_mmea import main
    from snag_tpu_torch.ops import cuda as kernels
    extra = dict(model_name=family, structure_encoder="gcn",
                 dtype="bfloat16", tau2=4.0)
    kernels.reset_stats()
    runner = main(small_argv(tmp_path, epoch=6, eval_epoch=3, batch_size=32,
                             lr=5e-4, scheduler="cos", save_model=1,
                             exp_id="gcn_bf16", **extra))
    ran = {name for name, st in kernels.all_stats().items() if st.twin_calls}
    assert ran == BF16_GCN_KERNELS[family]
    losses = runner.loss_log.loss[1:]
    assert len(losses) == 6 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    res = runner.last_result
    for v in (*res.acc_l2r, *res.acc_r2l, res.mrr_l2r, res.mrr_r2l):
        assert 0.0 <= v <= 1.0
    served = main(small_argv(tmp_path, only_test=1,
                             model_name_save=runner.cfg.exp_id, **extra))
    np.testing.assert_array_equal(served.last_result.ranks_l2r,
                                  res.ranks_l2r)
