"""The GAT at any head count and width, and instance normalisation, vs the
JAX package.

The GAT kernels' twins (``gat_attention_twin``, ``gat_backward_twin``) are
what CPU tensors run; past the main path's H <= 4 and C <= 1,280 (C <= 320
where C % 4 != 0) the CUDA kernels take their wide path
(``gat_attention.wide``), held against the same twins on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase ``parity``).  Here
the twins at H = 6 and C = 1,300 (float4 slices, past 1,280) and C = 330
(single floats, past 320) are held against the JAX package's XLA path
(``xla_gat_attention`` and the XLA backward of ``gat_attn_primitive``):
f32 forward rtol = atol = 1e-5 (sums in another order), backward rtol =
atol = 1e-4, the limit of the GAT backward (PERF.md section 2: each edge's
d_e is a dot over all of C, here 1,300 products, added in another order);
bf16 max |err| <= 4e-3 x
max |JAX| per output, about one bf16 ulp of its scale, with JAX's bf16
reductions as f32 sums rounded once (``f32_reductions``).

``--instance_normalization``: the port's GAT with ``InstanceNorm`` against
the JAX GAT with ``instance_normalization=True``, weights carried across
by ``state_dict_from_flax`` (``in_scale`` / ``in_bias`` -> ``norm.weight``
/ ``norm.bias``): output rtol = atol = 1e-5, every gradient within 1e-5 x
max |JAX| of its tensor.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snag_tpu.data.graph import build_graph as jax_build_graph
from snag_tpu.ops.gat_attn_primitive import gat_attention as jax_gat_attention
from snag_tpu.ops.gnn import GAT as JaxGAT
from snag_tpu_torch.data.graph import build_graph
from snag_tpu_torch.ops.cuda import gat_attention as tga
from snag_tpu_torch.ops.cuda import gat_bwd as tgb
from snag_tpu_torch.ops.gat_attn_primitive import gat_attention
from snag_tpu_torch.ops.gnn import GAT
from snag_tpu_torch.train.optim import param_label
from snag_tpu_torch.utils.import_reference import state_dict_from_flax
from torch_port_common import (assert_close_bf16, bf16_np, f32_reductions,
                               single_thread)

single_thread()
TOL = dict(rtol=1e-5, atol=1e-5)
BWD_TOL = dict(rtol=1e-4, atol=1e-4)
BF16 = torch.bfloat16
NAMES = ("d_x", "d_s_src", "d_s_dst")
# (H, C): past the warp's 4 heads, with rows past 1,280 float4 slices and
# past 320 single floats, the shape ``--heads 8,8`` trains at, and two
# heads past 320 columns (the wide kernels' 8-byte slices)
WIDE = [(6, 1300), (6, 330), (8, 300), (2, 330)]


def _inputs(h, c, n=64, n_tri=160, seed=0):
    """A small graph with a hub row of 40 edges (two 32-edge chunks)."""
    rng = np.random.default_rng(seed + c + h)
    tri = [(int(rng.integers(n)), 0, int(rng.integers(n)))
           for _ in range(n_tri)]
    tri += [(int(rng.integers(n)), 0, 3) for _ in range(40)]
    arrs = [rng.normal(size=s).astype(np.float32)
            for s in ((n, c), (n, h), (n, h), (n, h, c), (n, h))]
    return n, tri, arrs


def _jax_forward_and_grads(n, tri, x, s_src, s_dst, g_agg, g_rs, dtype):
    graph = jax_build_graph(n, tri)
    out, vjp = jax.vjp(lambda a, b, c: jax_gat_attention(a, b, c, graph),
                       jnp.asarray(x, dtype), jnp.asarray(s_src),
                       jnp.asarray(s_dst))
    return out, vjp((jnp.asarray(g_agg), jnp.asarray(g_rs)))


def _port_forward_and_grads(n, tri, x, s_src, s_dst, g_agg, g_rs, dtype):
    xs = [torch.from_numpy(x).to(dtype).requires_grad_(),
          torch.from_numpy(s_src).requires_grad_(),
          torch.from_numpy(s_dst).requires_grad_()]
    out = gat_attention(*xs, build_graph(n, tri).to_torch("cpu"))
    torch.autograd.backward(out, (torch.from_numpy(g_agg),
                                  torch.from_numpy(g_rs)))
    return [t.detach() for t in out], [t.grad for t in xs]


@pytest.mark.parametrize("h,c", WIDE)
def test_wide_twins_match_jax_f32(h, c):
    n, tri, arrs = _inputs(h, c)
    assert tga.wide(c, h, 4 if c % 4 == 0 else 1)
    before = (tga.STATS.twin_calls, tgb.STATS.twin_calls)
    out, grads = _port_forward_and_grads(n, tri, *arrs, torch.float32)
    assert (tga.STATS.twin_calls, tgb.STATS.twin_calls) == \
        (before[0] + 1, before[1] + 1)
    want_out, want_grads = _jax_forward_and_grads(n, tri, *arrs, jnp.float32)
    for a, b, name in zip(out, want_out, ("agg", "rowsum")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **TOL)
    for a, b, name in zip(grads, want_grads, NAMES):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **BWD_TOL)


@pytest.mark.parametrize("h,c", WIDE)
def test_wide_twins_match_jax_bf16(h, c):
    n, tri, (x, s_src, s_dst, g_agg, g_rs) = _inputs(h, c, seed=1)
    x, g_agg = bf16_np(x), bf16_np(g_agg)
    out, grads = _port_forward_and_grads(n, tri, x, s_src, s_dst, g_agg,
                                         g_rs, BF16)
    with f32_reductions():
        want_out, want_grads = _jax_forward_and_grads(
            n, tri, x, s_src, s_dst, g_agg, g_rs, jnp.bfloat16)
    assert grads[0].dtype == BF16 and out[0].dtype == torch.float32
    for a, b, name in zip(out + grads, list(want_out) + list(want_grads),
                          ("agg", "rowsum") + NAMES):
        assert_close_bf16(a, b, name)


def _jax_norm_gat(n, tri, c, heads, seed=3):
    rng = np.random.default_rng(seed)
    x = (2.0 + rng.normal(size=(n, c))).astype(np.float32)
    params = {f"gat_{i}": {
        "w": (1.0 + 0.3 * rng.normal(size=(heads[i], 1, c))).astype(np.float32),
        "a_src_dst": (0.2 * rng.normal(size=(heads[i], 2 * c, 1))).astype(
            np.float32)} for i in range(len(heads))}
    params["in_scale"] = (1.0 + 0.2 * rng.normal(size=(c,))).astype(np.float32)
    params["in_bias"] = (0.1 * rng.normal(size=(c,))).astype(np.float32)
    jax_gat = JaxGAT(n_units=[c] * (len(heads) + 1), n_heads=heads,
                     instance_normalization=True, adj_dtype=jnp.float32)
    return x, params, jax_gat


def test_instance_norm_gat_matches_jax():
    n, c, heads = 80, 24, [6, 6]
    _, tri, _ = _inputs(2, c, n=n, n_tri=200, seed=2)
    x, params, jax_gat = _jax_norm_gat(n, tri, c, heads)
    jg = jax_build_graph(n, tri)
    g_out = np.random.default_rng(4).normal(size=(n, c)).astype(np.float32)

    def loss(p, xx):
        return jnp.sum(jax_gat.apply({"params": p}, xx, jg) * g_out)
    want = jax_gat.apply({"params": params}, jnp.asarray(x), jg)
    want_grads, want_dx = jax.grad(loss, argnums=(0, 1))(params,
                                                         jnp.asarray(x))

    sd = state_dict_from_flax({"multimodal_encoder": {
        "cross_graph_model": params}})
    prefix = "multimodal_encoder.cross_graph_model."
    assert {prefix + "norm.weight", prefix + "norm.bias"} <= set(sd)
    gat = GAT([c, c, c], heads, torch.Generator().manual_seed(0),
              instance_normalization=True).eval()
    assert torch.equal(gat.norm.weight, torch.ones(c))
    assert torch.equal(gat.norm.bias, torch.zeros(c))
    gat.load_state_dict({k[len(prefix):]: v for k, v in sd.items()},
                        strict=True)
    xt = torch.from_numpy(x).requires_grad_()
    got = gat(xt, build_graph(n, tri).to_torch("cpu"))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    (got * torch.from_numpy(g_out)).sum().backward()
    pairs = [(gat.norm.weight.grad, want_grads["in_scale"]),
             (gat.norm.bias.grad, want_grads["in_bias"]), (xt.grad, want_dx)]
    pairs += [(getattr(gat.layer_stack[i], k).grad, want_grads[f"gat_{i}"][k])
              for i in range(2) for k in ("w", "a_src_dst")]
    for got_g, want_g in pairs:
        want_g = np.asarray(want_g)
        np.testing.assert_allclose(got_g.numpy(), want_g, rtol=0,
                                   atol=1e-5 * np.abs(want_g).max())
    # the JAX package's optimizer groups: in_scale decays, in_bias does not
    assert param_label(prefix + "norm.weight") == "decay"
    assert param_label(prefix + "norm.bias") == "no_decay"
