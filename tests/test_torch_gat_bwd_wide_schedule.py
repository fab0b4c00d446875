"""The wide GAT backward's order of sums, emulated bit for bit on the CPU.

``csrc/gat_bwd.cu``'s wide first pass (``gat_bwd_wide_rows``, any H and C
past the main path's) walks each CSR row's edges once.  The row's warps
split its columns (``gat_bwd.wide_plan``: ``warps`` warps of ``gw`` groups
of 32 slices a lane, warp w from slice 32 gw w on, and more launches,
"passes", past 16 warps' columns); an edge's heads go in groups of four
(two, where a row of at most 2 heads of pairs takes one warp of 6 groups),
whose lane partials (heads x groups) one reduce-scatter sums, and each
(head, group) sum goes to shared memory.  A thread an (edge, head) then
adds the row's group sums in order from 0, after the partial dot that the
pass before left in the edge's scratch slot, and forms the d_score.

The body it replaced walked a row's column chunks of 5 groups one after
the other in one warp, an edge's heads one at a time, butterflied every
group and carried the partial dot in the edge's scratch slot from chunk
to chunk.  Both add the same group sums (each group's butterfly, which the
reduce-scatter reproduces: ``tests/test_torch_gat_bwd_bf16_schedule.py``)
in the same order, so every d_score keeps its bits; d_x is the same fmaf
chain (edges in order, heads in order, from 0), in bf16 the same term
rounded at the same points.  The tests emulate both orders in float32
numpy, the new one launch by launch and group by group as the plan lays
it out, at (H, C) = (8, 300) (``--heads 8,8``: one warp a row, two head
groups), (2, 330) (8-byte slices, one warp of two heads and 6 groups a
lane), (3, 330) (two warps a row), (6, 1,300) (four
warps) and (8, 1,536) (four warps, three groups each), and at (3, 1,601)
(single floats, two passes), on a small graph with a hub row of 40+
edges (two batches of 32), in f32 and with the bf16 rounding points.  They
require the same bits for d_s_src and d_s_dst, the narrow kernels' bits
on each half of the heads at H = 8 (as ``tests/test_torch_cuda.py``'s
card test does), and agreement with ``gat_backward_twin``: f32 rtol = atol
= 1e-4; bf16 d_x bit for bit and d_s_src, d_s_dst within 4e-3 x max
|twin|.  The slice width the new path takes at C = 330 (2, where the
parent read single floats) changes how each slice's products are summed,
so there the parent's order is emulated at the same width.
"""

import numpy as np
import pytest
import torch

from snag_tpu_torch.data.graph import build_graph
from snag_tpu_torch.ops.cuda import gat_bwd as tgb
from test_torch_gat_bwd_bf16_schedule import backward_bf16, bf16, reduce_scatter
from test_torch_gat_schedule import (F32, LANES, butterfly, by_lane,
                                     dx_chain, edge_weight, fmaf, leaky_grad,
                                     row_sums, warp_backward)
from torch_port_common import single_thread

single_thread()
BF16_TOL = 4e-3
PARENT_GROUPS = 5       # the parent's groups a lane in a column chunk
SHAPES = [(8, 300), (2, 330), (3, 330), (6, 1300), (8, 1536)]
NAMES = ("d_x", "d_s_src", "d_s_dst")


def _inputs(h, c, n=96, n_tri=200, seed=0):
    """A small graph with a hub row of 40+ edges (two 32-edge batches)."""
    rng = np.random.default_rng(seed + c + h)
    tri = [(int(rng.integers(n)), 0, int(rng.integers(n)))
           for _ in range(n_tri)]
    tri += [(int(rng.integers(n)), 0, 3) for _ in range(70)]
    arrs = [rng.normal(size=s).astype(F32)
            for s in ((n, c), (n, h), (n, h), (n, h, c), (n, h))]
    return build_graph(n, tri), arrs


def vec_of(c):
    """The wide path's slice width on aligned rows."""
    return 4 if c % 4 == 0 else 2 if c % 2 == 0 else 1


def slice_dots(a, b, vec):
    """Vec<vec>::dot (and dot_packed) of every slice: an fmaf chain from
    the first slice element's rounded product."""
    m, c = a.shape
    a, b = a.reshape(m, c // vec, vec), b.reshape(m, c // vec, vec)
    t = a[..., 0] * b[..., 0]
    for i in range(1, vec):
        t = fmaf(a[..., i], b[..., i], t)
    return t


def parent_dots(xr, gr, vec):
    """The parent: column chunks of PARENT_GROUPS groups in turn, a head
    at a time; each group butterflied, lane 0 adding the chunk's group
    sums to the edge's carried partial dot.  (E, H)."""
    e, h, c = gr.shape
    nv = c // vec
    groups = -(-nv // 32)
    dots = np.empty((e, h), F32)
    for hh in range(h):
        sums = butterfly(by_lane(slice_dots(xr, gr[:, hh], vec), groups))
        dot = np.zeros(e, F32)
        for ch in range(-(-groups // PARENT_GROUPS)):
            for g in range(PARENT_GROUPS):
                gg = ch * PARENT_GROUPS + g
                if gg < groups:
                    dot = dot + sums[:, gg, 0]
        dots[:, hh] = dot
    return dots


def wide_dots(xr, gr, vec):
    """The new pass, as ``wide_plan`` lays it out: per pass and warp, each
    head group's lane partials (plan heads x gw values, the missing heads'
    zero) by one reduce-scatter into the (head, group) sums; then,
    per (edge, head), the pass's live groups added in order from 0 to the
    partial dot the pass before carried.  (E, H)."""
    e, h, c = gr.shape
    nv = c // vec
    plan = tgb.wide_plan(c, h, vec)
    gw, warps, hg = plan["gw"], plan["warps"], plan["heads"]
    ng = gw * warps
    parts = np.zeros((e, h, plan["passes"] * ng * 32), F32)
    for hh in range(h):
        parts[:, hh, :nv] = slice_dots(xr, gr[:, hh], vec)
    dots = np.zeros((e, h), F32)
    for p in range(plan["passes"]):
        held = np.zeros((e, h, ng), F32)
        for w in range(warps):
            s_lo = (p * warps + w) * 32 * gw
            for hb in range(0, h, hg):
                vals = np.zeros((e, hg * gw, 32), F32)
                for i in range(min(hg, h - hb)):
                    for g in range(gw):
                        s = s_lo + 32 * g + LANES
                        vals[:, i * gw + g] = parts[:, hb + i, s]
                sums = reduce_scatter(vals)
                for i in range(min(hg, h - hb)):
                    held[:, hb + i, w * gw:(w + 1) * gw] = \
                        sums[:, i * gw:(i + 1) * gw]
        live = min(ng, -(-(nv - p * ng * 32) // 32))
        for g in range(live):
            dots = dots + held[:, :, g]
    return dots


def backward(x, s_src, s_dst, g_agg, g_rs, g, order, bf16_points):
    """Both passes of the wide backward with the dots of ``order``
    (parent_dots or wide_dots); ``bf16_points``: x and G bf16, s_src,
    s_dst and r rounded to bf16, each d_score and d_x term rounded."""
    row, col, rp = g.row.astype(np.int64), g.col.astype(np.int64), g.row_ptr
    n, c = x.shape
    heads = s_src.shape[1]
    rnd = bf16 if bf16_points else (lambda a: a)
    score = rnd(s_src)[col] + rnd(s_dst)[row]                  # (E, H)
    e = edge_weight(score)
    r = rnd(g_rs)[col]
    dot = order(x[row], g_agg[col], vec_of(c))
    ds = rnd(-(dot + r) * e * leaky_grad(score))
    if bf16_points:
        eb = bf16(e)
        g_rows = g_agg[col]
        term = bf16(eb[:, 0, None] * g_rows[:, 0])
        for hh in range(1, heads):
            term = bf16(term + bf16(eb[:, hh, None] * g_rows[:, hh]))
        deg = np.diff(rp)
        acc = np.zeros((n, c), F32)
        for t in range(deg.max()):             # edges in order, from 0
            live = deg > t
            acc[live] = acc[live] + term[rp[:-1][live] + t]
        d_x = bf16(acc)
    else:
        d_x = dx_chain(e, g_agg, rp, col, c)
    scratch = np.full_like(ds, np.nan)
    scratch[g.rev] = ds
    return d_x, row_sums(scratch, rp), row_sums(ds, rp)


def _arrays(h, c, bf16_points):
    g, (x, s_src, s_dst, g_agg, g_rs) = _inputs(h, c)
    if bf16_points:
        x, g_agg = bf16(x), bf16(g_agg)
    return g, (x, s_src, s_dst, g_agg, g_rs)


@pytest.mark.parametrize("bf16_points", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("h,c", SHAPES + [(3, 1601)])
def test_wide_order_gives_the_parents_bits(h, c, bf16_points):
    g, arrs = _arrays(h, c, bf16_points)
    assert np.diff(g.row_ptr).max() > 32
    old = backward(*arrs, g, parent_dots, bf16_points)
    new = backward(*arrs, g, wide_dots, bf16_points)
    for a, b, name in zip(new, old, NAMES):
        assert a.dtype == np.float32 and np.isfinite(a).all()
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32),
                                      err_msg=name)


@pytest.mark.parametrize("bf16_points", [False, True], ids=["f32", "bf16"])
def test_wide_order_gives_the_narrow_bits_on_each_half_of_the_heads(
        bf16_points):
    """H = 8, C = 300 against the main path's bodies at H = 4 (f32: a
    butterfly a group; bf16: its own body's reduce-scatter)."""
    g, (x, s_src, s_dst, g_agg, g_rs) = _arrays(8, 300, bf16_points)
    _, d_src, d_dst = backward(x, s_src, s_dst, g_agg, g_rs, g, wide_dots,
                               bf16_points)
    for heads in (slice(0, 4), slice(4, 8)):
        half = (x, s_src[:, heads], s_dst[:, heads], g_agg[:, heads],
                g_rs[:, heads])
        if bf16_points:
            _, n_src, n_dst = backward_bf16(*half, g, new=True)
        else:
            _, n_src, n_dst = warp_backward(*half, g)
        for a, b, name in ((d_src[:, heads], n_src, "d_s_src"),
                           (d_dst[:, heads], n_dst, "d_s_dst")):
            np.testing.assert_array_equal(
                np.ascontiguousarray(a).view(np.int32), b.view(np.int32),
                err_msg=name)


@pytest.mark.parametrize("bf16_points", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("h,c", SHAPES)
def test_wide_order_matches_twin(h, c, bf16_points):
    g, arrs = _arrays(h, c, bf16_points)
    new = backward(*arrs, g, wide_dots, bf16_points)
    x, s_src, s_dst, g_agg, g_rs = (torch.from_numpy(a) for a in arrs)
    if bf16_points:
        x, g_agg = x.to(torch.bfloat16), g_agg.to(torch.bfloat16)
    twin = tgb.gat_backward_twin(x, s_src, s_dst, g_agg, g_rs,
                                 g.to_torch("cpu"))
    twin = [t.to(torch.float32).numpy() for t in twin]
    if bf16_points:
        np.testing.assert_array_equal(new[0].view(np.int32),
                                      twin[0].view(np.int32), err_msg="d_x")
        for a, t, name in zip(new[1:], twin[1:], NAMES[1:]):
            assert np.abs(a - t).max() <= BF16_TOL * np.abs(t).max(), name
    else:
        for a, t, name in zip(new, twin, NAMES):
            np.testing.assert_allclose(a, t, rtol=1e-4, atol=1e-4,
                                       err_msg=name)


@pytest.mark.parametrize("h,c,vec,want", [
    (8, 300, 4, dict(gw=3, heads=4, warps=1, rows=4, batch=32, passes=1)),
    (8, 1536, 4, dict(gw=3, warps=4, rows=1, batch=32, passes=1)),
    (2, 330, 2, dict(gw=6, heads=2, warps=1, rows=4, batch=32, passes=1)),
    (3, 330, 2, dict(gw=3, heads=4, warps=2, rows=1, batch=32, passes=1)),
    (8, 64, 4, dict(gw=1, warps=1, rows=4, batch=32, passes=1)),
    (3, 1601, 1, dict(gw=3, warps=16, rows=1, batch=32, passes=2)),
    (64, 1536, 4, dict(gw=3, warps=4, rows=1, batch=8, passes=1)),
])
def test_wide_plan(h, c, vec, want):
    """One warp a row up to three groups a lane, else a block whose warps
    split the columns (at most 16, then passes); edge batches of 32 unless
    the shared memory of a block would pass 48 KB."""
    plan = tgb.wide_plan(c, h, vec)
    assert {k: plan[k] for k in want} == want
    assert plan["smem"] == plan["rows"] * tgb.wide_row_bytes(
        plan["batch"], h, plan["gw"] * plan["warps"]) <= tgb.WIDE_SMEM
    # the pass's groups cover the row's slices
    groups = -(-(c // vec) // 32)
    assert plan["passes"] * plan["gw"] * plan["warps"] >= groups


@pytest.mark.parametrize("h,c,aligned,want", [
    (2, 330, True, (2, True)), (2, 330, False, (1, True)),
    (8, 300, True, (4, True)), (2, 300, True, (4, False)),
    (2, 319, True, (1, False)), (3, 1601, True, (1, True)),
])
def test_backward_slice_width(h, c, aligned, want):
    """The wide path reads 8-byte f32 slices where C is even and the rows
    are aligned to 2 floats; the main path's widths are slice_width's."""
    t = torch.zeros(c + 1)
    assert tgb.backward_slice_width(c, h, t if aligned else t[1:]) == want
