"""Port GAT attention twin and GAT module vs the JAX package.

The twin (``snag_tpu_torch/ops/cuda/gat_attention.py``) is what CPU tensors
run; the CUDA kernel is held against it on the card (``chip_smoke.py``
and ``test_torch_cuda.py``).  Here both JAX paths serve as the reference:
the XLA fallback and the Pallas kernel in interpret mode.  f32 sums in a
different order: rtol = atol = 1e-5.
"""

import unittest.mock as mock

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
from snag_tpu_torch.data.graph import build_graph
from snag_tpu_torch.ops.cuda import gat_attention as tga
from snag_tpu_torch.ops.gat_attn_primitive import gat_attention
from snag_tpu_torch.ops.gnn import GAT
from torch_port_common import single_thread

single_thread()
TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(n=300, n_tri=900, c=48, h=2, seed=0):
    rng = np.random.default_rng(seed)
    tri = [(int(rng.integers(n)), 0, int(rng.integers(n)))
           for _ in range(n_tri)]
    x = rng.normal(size=(n, c)).astype(np.float32)
    s_src = rng.normal(size=(n, h)).astype(np.float32)
    s_dst = rng.normal(size=(n, h)).astype(np.float32)
    return n, tri, x, s_src, s_dst


def _port(n, tri, x, s_src, s_dst):
    g = build_graph(n, tri).to_torch("cpu")
    agg, rs = gat_attention(torch.from_numpy(x), torch.from_numpy(s_src),
                            torch.from_numpy(s_dst), g)
    return agg.numpy(), rs.numpy()


@pytest.mark.parametrize("seed,h", [(0, 2), (1, 1), (2, 4)])
def test_twin_matches_jax_xla_path(seed, h):
    n, tri, x, s_src, s_dst = _inputs(h=h, seed=seed)
    jg = jax_build_graph(n, tri)
    want = jax_gat_attention(jnp.asarray(x), jnp.asarray(s_src),
                             jnp.asarray(s_dst), jg)
    got = _port(n, tri, x, s_src, s_dst)
    for a, b, name in zip(got, want, ("agg", "rowsum")):
        np.testing.assert_allclose(a, np.asarray(b), err_msg=name, **TOL)


@pytest.mark.parametrize("flat", [False, True])
def test_twin_matches_pallas_interpret(flat):
    """Hub rows exceed the tiled grid's chunk cap, so the tiled run also
    goes through the spill tail."""
    n, tri, x, s_src, s_dst = _inputs(seed=5)
    rng = np.random.default_rng(9)
    tri += [(int(rng.integers(n)), 0, 7) for _ in range(300)]
    jg = jax_build_graph(n, tri)
    orig = pl.pallas_call

    def interp(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    with mock.patch.object(pl, "pallas_call", interp), \
            mock.patch.object(gp, "pallas_available", lambda: True), \
            mock.patch.object(ga, "pallas_available", lambda: True), \
            mock.patch.object(tsg, "FLAT_GRID", flat):
        want = jax_gat_attention(jnp.asarray(x), jnp.asarray(s_src),
                                 jnp.asarray(s_dst), jg)
    got = _port(n, tri, x, s_src, s_dst)
    for a, b, name in zip(got, want, ("agg", "rowsum")):
        np.testing.assert_allclose(a, np.asarray(b), err_msg=name, **TOL)


def test_gat_module_matches_jax_with_transferred_weights():
    n, c, heads = 200, 32, [2, 2]
    _, tri, x, _, _ = _inputs(n=n, n_tri=600, c=c, seed=3)
    rng = np.random.default_rng(4)
    params = {f"gat_{i}": {
        "w": (1.0 + 0.3 * rng.normal(size=(heads[i], 1, c))).astype(np.float32),
        "a_src_dst": (0.2 * rng.normal(size=(heads[i], 2 * c, 1))).astype(np.float32)}
        for i in range(2)}
    jax_gat = JaxGAT(n_units=[c, c, c], n_heads=heads, adj_dtype=jnp.float32)
    want = jax_gat.apply({"params": params}, jnp.asarray(x),
                         jax_build_graph(n, tri))

    gat = GAT([c, c, c], heads, torch.Generator().manual_seed(0)).eval()
    gat.load_state_dict({f"layer_stack.{i}.{k}": torch.from_numpy(v)
                         for i in range(2)
                         for k, v in params[f"gat_{i}"].items()}, strict=True)
    with torch.no_grad():
        got = gat(torch.from_numpy(x), build_graph(n, tri).to_torch("cpu"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_cpu_dispatch_counts_twin_and_kernel_wrapper_refuses_cpu():
    n, tri, x, s_src, s_dst = _inputs(n=50, n_tri=100, c=8)
    before = (tga.STATS.launches, tga.STATS.twin_calls)
    _port(n, tri, x, s_src, s_dst)
    assert tga.STATS.twin_calls == before[1] + 1
    assert tga.STATS.launches == before[0]
    g = build_graph(n, tri).to_torch("cpu")
    with pytest.raises(ValueError, match="CUDA"):
        tga.gat_attention_cuda(torch.from_numpy(x), torch.from_numpy(s_src),
                               torch.from_numpy(s_dst), g)
