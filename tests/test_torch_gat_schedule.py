"""The GAT kernels' arithmetic, emulated bit for bit on the CPU.

``csrc/gat_bwd.cu`` walks each CSR row j with one warp: lane l owns the
slices l, l + 32, ... ("groups"), each edge p = (j, k) is read as the edge
(k, j) = rev[p], its d_score is computed once and written to a scratch at
rev[p], and a second launch adds each row's scratch into d_s_src in CSR
order.  The block-per-row kernel it replaced gave thread s slice s, summed
each warp's butterfly in warp order, and computed every d_score twice: in
row k for d_s_dst and again in row i, from x[k] and G[i], for d_s_src.

Here both schedules run in float32 numpy with an exact fmaf, and must give
the same bits for d_x, d_s_src and d_s_dst (and, for the forward, agg and
rowsum); both must agree with ``gat_backward_twin`` / ``gat_attention_twin``
and with the JAX XLA forward and backward at the tolerance of
``tests/test_torch_gat_bwd.py`` (rtol = atol = 1e-5).  ``rev`` must be an
involution that swaps row and col and fixes the self-loops, and the scratch
positions must cover every edge once.

The emulation rounds each slice's product before the butterfly adds it.
That is the kernels' arithmetic for float4 slices (C % 4 == 0), whose dot
is an explicit fmaf chain from a rounded first product, so the bit-for-bit
claim covers VEC = 4.  For single-float slices nvcc may contract a lane's
product into the butterfly's first add; the kernel then keeps lane 0's sum,
as the block-per-row kernel did, but this model does not show that the two
builds contract alike.  Those bits are held against the earlier build on
the card instead, by ``scripts/torch_grad_ab.py`` at C = 30 and C = 319.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snag_tpu.data.graph import build_graph as jax_build_graph
from snag_tpu.ops.gat_attn_primitive import gat_attention as jax_gat_attention
from snag_tpu_torch.data.graph import build_graph
from snag_tpu_torch.ops.cuda import gat_attention as tga
from snag_tpu_torch.ops.cuda import gat_bwd as tgb
from torch_port_common import single_thread

single_thread()
TOL = dict(rtol=1e-5, atol=1e-5)
F32 = np.float32
LANES = np.arange(32)
CASES = [(30, 1), (48, 2), (300, 2)]     # C = 30: one float a slice


def fmaf(a, b, c):
    """float32 a * b + c rounded once: the product is exact in float64, the
    float64 sum is rounded to odd (TwoSum gives its error), and rounding
    that to float32 is then the correctly rounded fma."""
    p = np.asarray(a, np.float64) * np.asarray(b, np.float64)
    c = np.asarray(c, np.float64)
    s = p + c
    bv = s - p
    err = (p - (s - bv)) + (c - bv)
    even = (s.view(np.int64) & 1) == 0
    s = np.where((err != 0) & even,
                 np.nextafter(s, np.where(err > 0, np.inf, -np.inf)), s)
    return s.astype(F32)


def edge_weight(score):
    lr = np.where(score > 0, score, F32(0.2) * score)
    return np.exp(-lr).astype(F32)


def leaky_grad(score):
    return np.where(score > 0, F32(1.0), F32(0.2)).astype(F32)


def vec_of(c):
    return 4 if c % 4 == 0 else 1


def slice_dots(a, b, vec):
    """Vec<vec>::dot of every slice: (M, C), (M, C) -> (M, C / vec)."""
    if vec == 1:
        return a * b
    a4 = a.reshape(a.shape[0], -1, 4)
    b4 = b.reshape(b.shape[0], -1, 4)
    t = a4[..., 0] * b4[..., 0]
    for i in (1, 2, 3):
        t = fmaf(a4[..., i], b4[..., i], t)
    return t


def butterfly(v):
    """xor butterfly over the last axis (32 lanes), offsets 16..1."""
    for off in (16, 8, 4, 2, 1):
        v = v + v[..., LANES ^ off]
    return v


def by_lane(parts, groups):
    """(M, nv) slice values -> (M, groups, 32): slice 32 g + l at [g, l],
    0 past the row."""
    m, nv = parts.shape
    out = np.zeros((m, groups * 32), F32)
    out[:, :nv] = parts
    return out.reshape(m, groups, 32)


def parent_dot(a, b, vec):
    """Block per row: thread s owns slice s; warp w's butterfly sum P_w is
    read from its lane 0, and the warps are added in order from 0."""
    parts = slice_dots(a, b, vec)
    warps = max(-(-parts.shape[1] // 32), 1)
    p = butterfly(by_lane(parts, warps))[:, :, 0]
    dot = np.zeros(a.shape[0], F32)
    for w in range(warps):
        dot = dot + p[:, w]
    return dot


def warp_dot(a, b, vec, lane):
    """Warp per row: lane l's group g is slice 32 g + l, padded to the
    kernel's template bucket; each group is butterflied on its own and a
    lane adds the groups inside the row in order from 0.  Returns the sum
    of lane ``lane`` (M,), and checks that every lane holds it."""
    parts = slice_dots(a, b, vec)
    nv = parts.shape[1]
    groups = -(-nv // 32)
    bucket = next(g for g in (1, 2, 3, 5, 10) if g >= groups)
    p = butterfly(by_lane(parts, bucket))
    dot = np.zeros((a.shape[0], 32), F32)
    for g in range(bucket):
        if 32 * g < nv:
            dot = dot + p[:, g, :]
    assert (dot == dot[:, :1]).all()
    return dot[np.arange(a.shape[0]), lane]


def row_sums(vals, row_ptr):
    """Per row, the values of its edges added in CSR order from 0."""
    n = row_ptr.shape[0] - 1
    deg = np.diff(row_ptr)
    out = np.zeros((n,) + vals.shape[1:], F32)
    for t in range(deg.max()):
        live = deg > t
        out[live] = out[live] + vals[row_ptr[:-1][live] + t]
    return out


def dx_chain(e, g_agg, row_ptr, col, c):
    """d_x[j] per slice: fmaf(e[p, h], G[col[p], h], acc) over the row's
    edges in order, heads in order, from 0."""
    n = row_ptr.shape[0] - 1
    deg = np.diff(row_ptr)
    acc = np.zeros((n, c), F32)
    for t in range(deg.max()):
        live = deg > t
        p = row_ptr[:-1][live] + t
        for h in range(e.shape[1]):
            acc[live] = fmaf(e[p, h][:, None], g_agg[col[p], h], acc[live])
    return acc


def parent_backward(x, s_src, s_dst, g_agg, g_rs, g):
    """Block per row j: its edges (j, k) as reverse edges (k, j) give d_x[j]
    and d_s_dst[j]; as forward edges, from x[k] and G[j], d_s_src[j]."""
    row, col, rp = g.row.astype(np.int64), g.col.astype(np.int64), g.row_ptr
    vec = vec_of(x.shape[1])
    e_rev = edge_weight(s_src[col] + s_dst[row])
    ds_rev, ds_fwd = [], []
    for h in range(s_src.shape[1]):
        score = s_src[col, h] + s_dst[row, h]
        d_e = parent_dot(x[row], g_agg[col, h], vec) + g_rs[col, h]
        ds_rev.append(-d_e * edge_weight(score) * leaky_grad(score))
        score = s_src[row, h] + s_dst[col, h]
        d_e = parent_dot(x[col], g_agg[row, h], vec) + g_rs[row, h]
        ds_fwd.append(-d_e * edge_weight(score) * leaky_grad(score))
    d_x = dx_chain(e_rev, g_agg, rp, col, x.shape[1])
    return (d_x, row_sums(np.stack(ds_fwd, 1), rp),
            row_sums(np.stack(ds_rev, 1), rp))


def warp_backward(x, s_src, s_dst, g_agg, g_rs, g):
    """Pass 1, a warp per row j: edge p = (j, k), the lane p - beg mod 32,
    d_score once, to scratch[rev[p]] and into d_s_dst[j]; pass 2: d_s_src
    from the scratch in CSR order."""
    row, col, rp = g.row.astype(np.int64), g.col.astype(np.int64), g.row_ptr
    vec = vec_of(x.shape[1])
    lane = (np.arange(g.n_edges) - rp[row]) % 32
    e = edge_weight(s_src[col] + s_dst[row])
    ds = np.empty((g.n_edges, s_src.shape[1]), F32)
    for h in range(s_src.shape[1]):
        score = s_src[col, h] + s_dst[row, h]
        dot = warp_dot(x[row], g_agg[col, h], vec, lane)
        ds[:, h] = -(dot + g_rs[col, h]) * e[:, h] * leaky_grad(score)
    scratch = np.full_like(ds, np.nan)
    scratch[g.rev] = ds
    d_x = dx_chain(e, g_agg, rp, col, x.shape[1])
    return d_x, row_sums(scratch, rp), row_sums(ds, rp)


def forward_model(x, s_src, s_dst, g):
    """Both forward kernels: agg[i, h] an fmaf chain over the row's edges
    in order from 0, rowsum their sum in order from 0 (block per row:
    thread s's slice and thread 0's sum; warp per row: lane l's groups and
    every lane's sum)."""
    row, col, rp = g.row.astype(np.int64), g.col.astype(np.int64), g.row_ptr
    n, c = x.shape
    e = edge_weight(s_src[row] + s_dst[col])
    deg = np.diff(rp)
    agg = np.zeros((n, s_src.shape[1], c), F32)
    for t in range(deg.max()):
        live = deg > t
        p = rp[:-1][live] + t
        for h in range(s_src.shape[1]):
            agg[live, h] = fmaf(e[p, h][:, None], x[col[p]], agg[live, h])
    return agg, row_sums(e, rp)


def _inputs(c, h, n=160, n_tri=500, seed=0):
    """A graph with a hub row of 200+ edges (several 32-edge chunks)."""
    rng = np.random.default_rng(seed + c)
    tri = [(int(rng.integers(n)), 0, int(rng.integers(n)))
           for _ in range(n_tri)]
    tri += [(int(rng.integers(n)), 0, 7) for _ in range(200)]
    arrs = [rng.normal(size=s).astype(F32)
            for s in ((n, c), (n, h), (n, h), (n, h, c), (n, h))]
    return n, tri, build_graph(n, tri), arrs


def _jax_backward(n, tri, x, s_src, s_dst, g_agg, g_rs):
    graph = jax_build_graph(n, tri)

    @jax.jit
    def grads(*arrs):
        _, vjp = jax.vjp(lambda a, b, c: jax_gat_attention(a, b, c, graph),
                         *arrs[:3])
        return vjp(arrs[3:])
    return [np.asarray(t) for t in grads(*map(jnp.asarray, (
        x, s_src, s_dst, g_agg, g_rs)))]


NAMES = ("d_x", "d_s_src", "d_s_dst")


@pytest.mark.parametrize("c,h", CASES)
def test_backward_schedules_give_the_same_bits(c, h):
    _, _, g, arrs = _inputs(c, h)
    assert np.diff(g.row_ptr).max() > 64
    old = parent_backward(*arrs, g)
    new = warp_backward(*arrs, g)
    for a, b, name in zip(new, old, NAMES):
        assert a.dtype == np.float32 and np.isfinite(a).all()
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32),
                                      err_msg=name)


@pytest.mark.parametrize("c,h", CASES)
def test_backward_schedule_matches_twin_and_jax(c, h):
    n, tri, g, arrs = _inputs(c, h)
    new = warp_backward(*arrs, g)
    twin = tgb.gat_backward_twin(*[torch.from_numpy(a) for a in arrs],
                                 g.to_torch("cpu"))
    jax_grads = _jax_backward(n, tri, *arrs)
    for a, t, j, name in zip(new, twin, jax_grads, NAMES):
        np.testing.assert_allclose(a, t.numpy(), err_msg=name, **TOL)
        np.testing.assert_allclose(a, j, err_msg=name, **TOL)


@pytest.mark.parametrize("c,h", CASES)
def test_forward_schedule_matches_twin_and_jax(c, h):
    n, tri, g, (x, s_src, s_dst, _, _) = _inputs(c, h)
    agg, rs = forward_model(x, s_src, s_dst, g)
    t_agg, t_rs = tga.gat_attention_twin(
        torch.from_numpy(x), torch.from_numpy(s_src), torch.from_numpy(s_dst),
        g.to_torch("cpu"))
    j_agg, j_rs = jax.jit(lambda a, b, d: jax_gat_attention(
        a, b, d, jax_build_graph(n, tri)))(x, s_src, s_dst)
    np.testing.assert_allclose(agg, t_agg.numpy(), **TOL)
    np.testing.assert_allclose(rs, t_rs.numpy(), **TOL)
    np.testing.assert_allclose(agg, np.asarray(j_agg), **TOL)
    np.testing.assert_allclose(rs, np.asarray(j_rs), **TOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_rev_pairs_every_edge_with_its_reverse(seed):
    _, _, g, _ = _inputs(48, 2, seed=seed)
    rev = g.rev
    assert rev.dtype == np.int64
    assert np.array_equal(rev[rev], np.arange(g.n_edges))
    assert np.array_equal(g.row[rev], g.col)
    assert np.array_equal(g.col[rev], g.row)
    loops = g.row == g.col
    assert loops.sum() == g.n_nodes
    assert np.array_equal(rev[loops], np.flatnonzero(loops))
    # pass 1 writes scratch[rev[p]] once for every edge p
    assert np.array_equal(np.bincount(rev, minlength=g.n_edges),
                          np.ones(g.n_edges, np.int64))


def test_fmaf_rounds_once():
    """The emulated fmaf against float64 where the float64 sum is exact,
    and on a case where a rounded product would differ."""
    rng = np.random.default_rng(0)
    a, b = rng.normal(size=(2, 1000)).astype(F32)
    c = rng.normal(size=1000).astype(F32)
    want = (a.astype(np.float64) * b + c).astype(F32)
    got = fmaf(a, b, c)
    assert np.mean(got == want) > 0.99
    x, c = F32(1 + 2.0 ** -12), F32(-1 - 2.0 ** -11)
    assert fmaf(x, x, c) == F32(2.0 ** -24)
    assert x * x + c == 0


@pytest.mark.parametrize("c,aligned,vec", [(300, True, 4), (300, False, 1),
                                           (30, True, 1), (1280, True, 4),
                                           (320, False, 1), (319, True, 1)])
def test_slice_width(c, aligned, vec):
    t = torch.zeros(c + 1)
    assert tga.slice_width(c, t if aligned else t[1:]) == vec


@pytest.mark.parametrize("c,aligned", [(1284, True), (321, True),
                                       (324, False)])
def test_slice_width_refuses_wider_rows(c, aligned):
    """Rows wider than a warp's ``MAX_GROUPS`` slices a lane are no longer
    refused: they take the wide kernels (``gat_attention.wide``), as do
    more than ``MAX_HEADS`` heads; the main path's shapes do not."""
    t = torch.zeros(c + 1)
    vec = tga.slice_width(c, t if aligned else t[1:])
    assert vec == (4 if aligned and c % 4 == 0 else 1)
    assert tga.wide(c, 2, vec) and tga.wide(300, 5, 4)
    assert not tga.wide(300, 2, 4) and not tga.wide(1280, 4, 4)
