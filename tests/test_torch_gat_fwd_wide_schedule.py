"""The wide GAT forward's order of sums, emulated bit for bit on the CPU.

``csrc/gat_attention.cu``'s wide body (``gat_fwd_wide_tile``, any H and C
past the main path's) walks each CSR row's edges once for up to 8 heads
(``gat_attention.wide_plan``: heads in groups of ``hn``, ``warps`` warps
of ``gw`` groups of 32 slices a lane splitting a row's columns, warp w
from slice 32 gw w on, and more blocks, "passes", past 8 warps' columns).
A block takes a tile of consecutive rows: ``rows`` row groups each walk
4 rows in turn.  The tile's edges, contiguous in CSR, go in chunks
(2 edges a thread): all threads stage a chunk's column ids and weights in
shared memory, then each group streams its rows' edges of the chunk
through a ring of ``depth`` slots (edge q + depth - 1's x slices copied
before edge q's feed the fmaf of every head) and writes a row's sums
where the stream passes its end.  Warp 0 of a group in the first pass
adds rowsum, a lane a head, in edge order.

The body it replaced ran a block per (row block, column chunk of 160
slices, head group of 4): each warp walked its row's edges for its chunk
and its heads, one x row at a time, and chunk 0 added rowsum.  In both,
agg[i, h, col] is the fmaf chain over the row's edges in order from 0 and
rowsum[i, h] their sum in order from 0, from e = exp(-leakyrelu(s_src +
s_dst)).  The tests emulate both schedules in float32 numpy with an exact
fmaf, launch by launch and warp by warp as each lays its work out, at
(H, C) = (8, 300) (``--heads 8,8``: one warp a row, two rows of 4 heads
in the parent), (8, 1,536) (four warps of three float4 groups), (2, 330)
(8-byte slices, one warp of 6 groups; the parent's single floats in
three chunks), (6, 1,300) and (3, 1,601) (single floats, five warps), on
a graph of 400 rows with a hub row of 256+ edges (its tile's edges pass a
chunk, and the hub row spans two), in f32 and with the bf16 rounding
points (x bf16; s_src, s_dst and e rounded to bf16).  They require the
same bits for agg and rowsum, that the plan writes every (row, head,
column) once, and agreement with ``gat_attention_twin`` (rtol = atol =
1e-5; the kernels' fmaf chain against the twin's products and
``index_add_``).
"""

import itertools

import numpy as np
import pytest
import torch

from snag_tpu_torch.data.graph import build_graph
from snag_tpu_torch.ops.cuda import gat_attention as tga
from test_torch_gat_bwd_bf16_schedule import bf16
from test_torch_gat_schedule import F32, edge_weight, fmaf
from torch_port_common import single_thread

single_thread()
TOL = dict(rtol=1e-5, atol=1e-5)
PARENT_SLICES = 160     # the parent's slices a column chunk
PARENT_HEADS = 4        # the parent's heads a block
SHAPES = [(8, 300), (8, 1536), (2, 330), (6, 1300), (3, 1601)]


def _inputs(h, c, n=400, n_tri=300, seed=0):
    """A small graph with a hub row of 256+ edges: its tile's edges pass a
    chunk (256 edges for a block of 4 warps), and the hub row spans two."""
    rng = np.random.default_rng(seed + c + h)
    tri = [(int(rng.integers(n)), 0, int(rng.integers(n)))
           for _ in range(n_tri)]
    tri += [(int(rng.integers(n)), 0, 3) for _ in range(600)]
    arrs = [rng.normal(size=s).astype(F32) for s in ((n, c), (n, h), (n, h))]
    return build_graph(n, tri), arrs


def vec_of(c):
    """The wide path's slice width on aligned rows."""
    return 4 if c % 4 == 0 else 2 if c % 2 == 0 else 1


def _weights(x, s_src, s_dst, g, bf16_points):
    """x as the kernels read it and the edges' weights e (E, H)."""
    rnd = bf16 if bf16_points else (lambda a: a)
    row, col = g.row.astype(np.int64), g.col.astype(np.int64)
    e = rnd(edge_weight(rnd(s_src)[row] + rnd(s_dst)[col]))
    return (bf16(x) if bf16_points else x), e


def _by_degree(rp):
    """(rows of degree > t, their edge t) for t in order: the rows' walks
    side by side."""
    deg = np.diff(rp)
    for t in range(deg.max()):
        live = np.nonzero(deg > t)[0]
        yield live, rp[live] + t


def parent_forward(x, s_src, s_dst, g, bf16_points):
    """The parent: per column chunk of PARENT_SLICES slices (at its slice
    width, 4 or 1) and head group of PARENT_HEADS, each row's edges in
    order, one x row at a time; chunk 0 adds rowsum."""
    xr, e = _weights(x, s_src, s_dst, g, bf16_points)
    col = g.col.astype(np.int64)
    n, c = x.shape
    h = s_src.shape[1]
    vec = 4 if c % 4 == 0 else 1
    agg = np.full((n, h, c), np.nan, F32)
    rowsum = np.full((n, h), np.nan, F32)
    for c0 in range(0, c, PARENT_SLICES * vec):
        cols = slice(c0, min(c0 + PARENT_SLICES * vec, c))
        for h0 in range(0, h, PARENT_HEADS):
            heads = slice(h0, min(h0 + PARENT_HEADS, h))
            acc = np.zeros((n, heads.stop - h0, cols.stop - c0), F32)
            rs = np.zeros((n, heads.stop - h0), F32)
            for live, p in _by_degree(g.row_ptr):
                acc[live] = fmaf(e[p, heads][:, :, None],
                                 xr[col[p], cols][:, None, :], acc[live])
                rs[live] = rs[live] + e[p, heads]
            agg[:, heads, cols] = acc
            if c0 == 0:
                rowsum[:, heads] = rs
    return agg, rowsum


def wide_forward(x, s_src, s_dst, g, bf16_points, writes=None):
    """The new body as ``wide_plan`` lays it out: per head group, pass and
    block, a tile of rows whose edges go in chunks; per row group of the
    tile and warp, its rows' edges of each chunk streamed through the ring
    of ``depth`` slots (edge q + depth - 1 loaded before edge q is
    consumed), every head's fmaf from the staged weights, a row's sums
    written where the stream passes its end; rowsum from warp 0 of pass 0.
    ``writes`` (N, H, C), if given, counts each output element's writes."""
    xr, e = _weights(x, s_src, s_dst, g, bf16_points)
    col = g.col.astype(np.int64)
    rp = g.row_ptr
    n, c = x.shape
    h = s_src.shape[1]
    vec = vec_of(c)
    plan = tga.wide_plan(c, h, vec, bf16_points)
    depth, gw, warps, hn = plan["depth"], plan["gw"], plan["warps"], plan["hn"]
    agg = np.full((n, h, c), np.nan, F32)
    rowsum = np.full((n, h), np.nan, F32)
    for hg, p, t0, rg, w in itertools.product(
            range(plan["head_groups"]), range(plan["passes"]),
            range(0, n, plan["tile"]), range(plan["rows"]), range(warps)):
        heads = slice(hg * hn, min((hg + 1) * hn, h))
        s_lo = (p * warps + w) * 32 * gw
        cols = slice(min(s_lo * vec, c), min((s_lo + 32 * gw) * vec, c))
        tn = min(plan["tile"], n - t0)
        ra = min(tn, rg * tga.WIDE_RUN)
        rb = min(tn, ra + tga.WIDE_RUN)
        acc = np.zeros((heads.stop - heads.start, cols.stop - cols.start), F32)
        rs = np.zeros(heads.stop - heads.start, F32)
        r = ra

        def flush(rr, acc, rs):
            agg[t0 + rr, heads, cols] = acc
            if writes is not None:
                writes[t0 + rr, heads, cols] += 1
            if p == 0 and w == 0:
                rowsum[t0 + rr, heads] = rs
            return np.zeros_like(acc), np.zeros_like(rs)
        e_lo, e_hi = rp[t0 + ra], rp[t0 + rb]
        for c0 in range(rp[t0], rp[t0 + tn], plan["chunk"]):
            c1 = min(rp[t0 + tn], c0 + plan["chunk"])
            qa, qb = max(e_lo, c0) - c0, min(e_hi, c1) - c0
            slots = {}

            def load(q):
                if q < qb:
                    slots[q % depth] = (q, xr[col[c0 + q], cols])
            for u in range(depth - 1):
                load(qa + u)
            for q in range(qa, qb):
                load(q + depth - 1)
                while c0 + q >= rp[t0 + r + 1]:
                    acc, rs = flush(r, acc, rs)
                    r += 1
                held, xrow = slots[q % depth]
                assert held == q
                acc = fmaf(e[c0 + q, heads][:, None], xrow[None, :], acc)
                rs = rs + e[c0 + q, heads]
        while r < rb:
            acc, rs = flush(r, acc, rs)
            r += 1
    return agg, rowsum


def _arrays(h, c):
    g, arrs = _inputs(h, c)
    assert np.diff(g.row_ptr).max() > 256
    return g, arrs


@pytest.mark.parametrize("bf16_points", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("h,c", SHAPES)
def test_wide_walk_gives_the_parents_bits(h, c, bf16_points):
    g, arrs = _arrays(h, c)
    old = parent_forward(*arrs, g, bf16_points)
    new = wide_forward(*arrs, g, bf16_points)
    for a, b, name in zip(new, old, ("agg", "rowsum")):
        assert a.dtype == np.float32 and np.isfinite(a).all(), name
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32),
                                      err_msg=name)


@pytest.mark.parametrize("bf16_points", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("h,c", [(8, 300), (2, 330), (3, 1601)])
def test_wide_walk_matches_twin(h, c, bf16_points):
    g, (x, s_src, s_dst) = _arrays(h, c)
    new = wide_forward(x, s_src, s_dst, g, bf16_points)
    xt = torch.from_numpy(x)
    if bf16_points:
        xt = xt.to(torch.bfloat16)
    twin = tga.gat_attention_twin(xt, torch.from_numpy(s_src),
                                  torch.from_numpy(s_dst), g.to_torch("cpu"))
    for a, t, name in zip(new, twin, ("agg", "rowsum")):
        np.testing.assert_allclose(a, t.numpy(), err_msg=name, **TOL)


@pytest.mark.parametrize("h,c", SHAPES + [(12, 300), (5, 30), (8, 64),
                                          (2, 2600), (2, 100000)])
def test_wide_plan_writes_every_output_once(h, c):
    """Every (row, head, column) is written by one warp of one launch
    block, within the block's shared memory (the H100's 227 KB) and warps
    (at most WIDE_WARPS)."""
    vec = vec_of(c)
    plan = tga.wide_plan(c, h, vec)
    assert plan["smem"] <= 227 * 1024
    assert 1 <= plan["warps"] <= tga.WIDE_WARPS
    assert plan["hn"] <= plan["hb"] <= tga.WIDE_HEADS
    assert plan["gw"] in tga.wide_gw_options(plan["hb"], vec)
    assert plan["hb"] * plan["gw"] * vec <= 96
    # a warp's ring within WIDE_RING bytes, but for its two slots at least
    per_warp = plan["depth"] * 32 * plan["gw"] * plan["slice_bytes"]
    assert per_warp <= tga.WIDE_RING or plan["depth"] == 2
    assert plan["ring"] == plan["rows"] * plan["warps"] * per_warp
    # heads: groups of hn, the last one live
    heads = np.zeros(h, np.int64)
    for hg in range(plan["head_groups"]):
        heads[hg * plan["hn"]:(hg + 1) * plan["hn"]] += 1
    assert (heads == 1).all() and (plan["head_groups"] - 1) * plan["hn"] < h
    # columns: warp w of pass p, lane l, group g holds slice
    # (p warps + w) 32 gw + 32 g + l when it lies in the row
    slices = c // vec
    seen = np.zeros(slices, np.int64)
    for p in range(plan["passes"]):
        for w in range(plan["warps"]):
            s_lo = (p * plan["warps"] + w) * 32 * plan["gw"]
            for g in range(plan["gw"]):
                s = s_lo + 32 * g + np.arange(32)
                seen[s[s < slices]] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("h,c", SHAPES)
def test_wide_walk_writes_every_output_once(h, c):
    g, arrs = _arrays(h, c)
    writes = np.zeros((g.n_nodes, h, c), np.int64)
    wide_forward(*arrs, g, False, writes=writes)
    assert (writes == 1).all()


@pytest.mark.parametrize("h,c,vec,bf16,want", [
    (8, 300, 4, False, dict(hn=8, hb=8, gw=3, warps=1, rows=4, passes=1,
                            depth=6, ring=36864)),
    (8, 1536, 4, False, dict(hn=8, gw=3, warps=4, rows=1, passes=1, depth=6)),
    (2, 330, 2, False, dict(hn=2, hb=2, gw=6, warps=1, rows=4, depth=6)),
    (6, 1300, 4, False, dict(hn=6, hb=8, gw=3, warps=4, rows=1)),
    (3, 1601, 1, False, dict(hn=3, hb=4, gw=12, warps=5, passes=1, depth=6)),
    (8, 64, 4, False, dict(gw=1, warps=1, depth=8)),
    (8, 300, 4, True, dict(gw=3, warps=1, depth=8, slice_bytes=8)),
    (12, 300, 4, False, dict(head_groups=2, hn=6, hb=8, gw=3)),
    (2, 100000, 4, False, dict(gw=6, warps=8, passes=17)),
])
def test_wide_plan(h, c, vec, bf16, want):
    """One warp a row (4 rows a block) where its groups fit a lane, else a
    block whose warps split the columns (at most 8, then passes); 8 heads
    a warp at most; a warp's ring of x rows in 9 KB of shared memory (a
    bf16 slice of 4 in 8 bytes)."""
    plan = tga.wide_plan(c, h, vec, bf16)
    assert {k: plan[k] for k in want} == want


@pytest.mark.parametrize("h,c,aligned,want", [
    (2, 330, True, (2, True)), (2, 330, False, (1, True)),
    (8, 300, True, (4, True)), (2, 300, True, (4, False)),
    (2, 319, True, (1, False)), (3, 1601, True, (1, True)),
])
def test_wide_slice_width(h, c, aligned, want):
    """The wide path reads 8-byte f32 slices where C is even and the rows
    are aligned to 2 floats; the main path's widths are slice_width's."""
    t = torch.zeros(c + 1)
    assert tga.wide_slice_width(c, h, t if aligned else t[1:]) == want
