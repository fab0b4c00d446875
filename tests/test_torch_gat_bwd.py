"""Port GAT backward (twin and autograd) vs the JAX package.

``gat_backward_twin`` (``snag_tpu_torch/ops/cuda/gat_bwd.py``) is what CPU
tensors run in the backward of ``gat_attention``; the CUDA kernel is held
against it on the card (``chip_smoke.py``, ``test_torch_cuda.py``).  The
reference is ``jax.vjp`` of ``snag_tpu.ops.gat_attn_primitive.gat_attention``:
its XLA backward, and the Pallas backward kernel in interpret mode.
f32 sums in another order: rtol = atol = 1e-5.
"""

import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import snag_tpu.ops.gat_attn_primitive as gp
import snag_tpu.ops.pallas.gat_attention as ga
import snag_tpu.ops.pallas.tile_segment as tsg
from snag_tpu.data.graph import build_graph as jax_build_graph
from snag_tpu.ops.gat_attn_primitive import gat_attention as jax_gat_attention
from snag_tpu.ops.gnn import GAT as JaxGAT
from snag_tpu_torch.data.graph import build_graph, is_symmetric
from snag_tpu_torch.ops.cuda import gat_bwd as tgb
from snag_tpu_torch.ops.gat_attn_primitive import gat_attention
from snag_tpu_torch.ops.gnn import GAT
from torch_port_common import single_thread

single_thread()
TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(n=300, n_tri=900, c=48, h=2, seed=0, hubs=False):
    rng = np.random.default_rng(seed)
    tri = [(int(rng.integers(n)), 0, int(rng.integers(n)))
           for _ in range(n_tri)]
    if hubs:   # a hub column and a hub row, past the tiled grid's chunk cap
        tri += [(int(rng.integers(n)), 0, 7) for _ in range(300)]
        tri += [(5, 0, int(rng.integers(n))) for _ in range(300)]
    arrs = [rng.normal(size=s).astype(np.float32)
            for s in ((n, c), (n, h), (n, h), (n, h, c), (n, h))]
    return n, tri, arrs


def _jax_grads(n, tri, x, s_src, s_dst, g_agg, g_rs):
    graph = jax_build_graph(n, tri)

    @jax.jit
    def grads(*arrs):
        _, vjp = jax.vjp(lambda a, b, c: jax_gat_attention(a, b, c, graph),
                         *arrs[:3])
        return vjp(arrs[3:])
    return [np.asarray(g) for g in grads(*map(jnp.asarray, (
        x, s_src, s_dst, g_agg, g_rs)))]


def _port_grads(n, tri, x, s_src, s_dst, g_agg, g_rs):
    """The twin directly, and autograd through the port's primitive."""
    g = build_graph(n, tri).to_torch("cpu")
    t = [torch.from_numpy(a) for a in (x, s_src, s_dst, g_agg, g_rs)]
    direct = tgb.gat_backward_twin(*t, g)
    xs = [a.clone().requires_grad_() for a in t[:3]]
    agg, rs = gat_attention(*xs, g)
    ((agg * t[3]).sum() + (rs * t[4]).sum()).backward()
    return ([d.numpy() for d in direct], [a.grad.numpy() for a in xs])


NAMES = ("d_x", "d_s_src", "d_s_dst")


@pytest.mark.parametrize("seed,h", [(0, 2), (1, 1), (2, 4)])
def test_twin_and_autograd_match_jax_xla_backward(seed, h):
    n, tri, arrs = _inputs(h=h, seed=seed)
    want = _jax_grads(n, tri, *arrs)
    direct, auto = _port_grads(n, tri, *arrs)
    for got in (direct, auto):
        for a, b, name in zip(got, want, NAMES):
            np.testing.assert_allclose(a, b, err_msg=name, **TOL)


@pytest.mark.parametrize("flat", [False, True])
def test_twin_matches_pallas_interpret(flat):
    """The JAX package's fused Pallas backward in interpret mode (as
    tests/test_gat_bwd_fused.py runs it); hub rows put edges in the tiled
    grid's spill tails."""
    n, tri, arrs = _inputs(n=200, n_tri=250, c=24, seed=3, hubs=True)
    orig = pl.pallas_call

    def interp(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    with mock.patch.object(pl, "pallas_call", interp), \
            mock.patch.object(gp, "pallas_available", lambda: True), \
            mock.patch.object(ga, "pallas_available", lambda: True), \
            mock.patch.object(tsg, "FLAT_GRID", flat):
        want = _jax_grads(n, tri, *arrs)
    direct, _ = _port_grads(n, tri, *arrs)
    for a, b, name in zip(direct, want, NAMES):
        np.testing.assert_allclose(a, b, err_msg=name, **TOL)


def test_gat_module_param_grads_match_jax():
    """Two GAT layers with ELU between: gradients of every parameter and of
    the input, with the weights carried across."""
    n, c, heads = 200, 32, [2, 2]
    _, tri, (x, *_) = _inputs(n=n, n_tri=600, c=c, seed=4)
    rng = np.random.default_rng(5)
    params = {f"gat_{i}": {
        "w": (1.0 + 0.3 * rng.normal(size=(heads[i], 1, c))).astype(np.float32),
        "a_src_dst": (0.2 * rng.normal(size=(heads[i], 2 * c, 1))).astype(np.float32)}
        for i in range(2)}
    wout = rng.normal(size=(n, c)).astype(np.float32)
    jax_gat = JaxGAT(n_units=[c, c, c], n_heads=heads, adj_dtype=jnp.float32)
    jg = jax_build_graph(n, tri)

    def jloss(p, xx):
        return (jax_gat.apply({"params": p}, xx, jg) * wout).sum()
    want_p, want_x = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        params, jnp.asarray(x))

    gat = GAT([c, c, c], heads, torch.Generator().manual_seed(0))
    gat.load_state_dict({f"layer_stack.{i}.{k}": torch.from_numpy(v)
                         for i in range(2)
                         for k, v in params[f"gat_{i}"].items()}, strict=True)
    xt = torch.from_numpy(x).requires_grad_()
    (gat(xt, build_graph(n, tri).to_torch("cpu")) * torch.from_numpy(wout)
     ).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_x), **TOL)
    for i in range(2):
        for k in ("w", "a_src_dst"):
            got = dict(gat.named_parameters())[f"layer_stack.{i}.{k}"].grad
            np.testing.assert_allclose(
                got.numpy(), np.asarray(want_p[f"gat_{i}"][k]),
                err_msg=f"{i}.{k}", **TOL)


def test_symmetry_flag_and_cpu_dispatch():
    n, tri, arrs = _inputs(n=50, n_tri=100, c=8)
    g = build_graph(n, tri)
    assert g.symmetric and g.to_torch("cpu").symmetric
    assert not is_symmetric(3, np.array([0, 1, 2, 0]), np.array([0, 1, 2, 1]))
    before = (tgb.STATS.launches, tgb.STATS.twin_calls)
    _port_grads(n, tri, *arrs)
    # the backward of autograd goes through the dispatcher
    assert tgb.STATS.twin_calls == before[1] + 1
    assert tgb.STATS.launches == before[0]
    with pytest.raises(ValueError, match="CUDA"):
        tgb.gat_backward_cuda(*[torch.from_numpy(a) for a in arrs],
                              g.to_torch("cpu"))
