"""The bf16 GAT backward kernel's arithmetic, emulated bit for bit on the CPU.

``csrc/gat_bwd.cu``'s ``gat_bwd_bf16`` keeps G and each edge's d_x term as
bf16 pairs and forms the term with sm_90's bf16 instructions, each result
rounded once to nearest even: bf16(e_h) G[k, h] by ``mul.rn.bf16x2`` and
the sum over heads by ``add.rn.bf16x2``.  Its parent formed the same term
in fp32 and rounded each result to bf16 (``round_bf16(e * g)``,
``round_bf16(t + p)``).  The two agree on every pair of bf16 operands: a
product of two bf16 is exact in fp32 (or, below fp32's normal range, its
one fp32 rounding cannot land on a bf16 midpoint), and a sum of two bf16 is
exact in fp32 unless their exponents differ by 16 or more, when both round
to the larger.  The first tests hold that claim against f64 on operands
drawn from a numpy seed: signed zeros, subnormals, exponent gaps of 0-40,
exact ties, huge and tiny values.

The kernel also sums each edge's lane partials of its H x G dots (head h,
lane group g) by a reduce-scatter (``warp_sums``) in place of one xor
butterfly a value: at offset 16, 8, ... a lane keeps half of its values,
adds its partner's copy of each, and sends the other half; one shuffle a
value brings every sum back.  Each kept value is the butterfly's value at
that lane (fp32 addition is commutative), so the dot's bits stay the
parent's: each group butterflied, the group sums added from 0.  The tests
emulate both schedules in float32 numpy, the new one step for step as the
kernel runs it, and require the same bits for every value, and for d_x,
d_s_src and d_s_dst of the whole backward on the small graphs of
``tests/test_torch_gat_schedule.py`` (a hub row of 200+ edges) at C = 30,
300 and 301 and H = 1, 2 and 4.  Both are held against the bf16 twin,
``gat_backward_twin``: d_x bit for bit, and d_s_src, d_s_dst within 4e-3 x
max |twin| (the twin sums each dot in torch's order, and a d_score
rounded to bf16 can then land one bf16 ulp apart).
"""

import numpy as np
import pytest
import torch

from snag_tpu_torch.ops.cuda import gat_bwd as tgb
from snag_tpu_torch.ops.cuda.snag_loss import round_bf16_once
from test_torch_gat_schedule import (F32, LANES, _inputs, butterfly, by_lane,
                                     edge_weight, leaky_grad, row_sums,
                                     slice_dots, vec_of, warp_dot)
from torch_port_common import single_thread

single_thread()
BF16_TOL = 4e-3
CASES = [(c, h) for c in (30, 300, 301) for h in (1, 2, 4)]


def bf16(a):
    """float32 values rounded to bf16 (to nearest, ties to even), as
    float32: the kernels' round_bf16, __float2bfloat16_rn."""
    t = torch.from_numpy(np.ascontiguousarray(a, dtype=F32))
    return t.to(torch.bfloat16).to(torch.float32).numpy()


def once(exact):
    """f64 values rounded once to bf16, as float32: the result of one
    correctly rounded bf16 instruction on operands whose exact result is
    ``exact``."""
    return round_bf16_once(torch.from_numpy(np.asarray(exact, np.float64))
                           ).numpy()


def random_bf16(rng, n, lo=-133, hi=127):
    """n bf16 values (as float32) of random sign, exponent in [lo, hi] and
    7 random fraction bits; exponents below -126 give subnormals."""
    e = rng.integers(lo, hi + 1, size=n)
    frac = rng.integers(0, 128, size=n)
    mag = (1 + frac / 128.0) * np.exp2(e.astype(np.float64))
    val = np.where(rng.random(n) < 0.5, -mag, mag)
    return bf16(val.astype(F32))


def special_bf16():
    """Zeros of both signs, the smallest and largest subnormals and
    normals, 1, and the largest finite bf16."""
    tiny = [2.0 ** -133, 2.0 ** -127, 2.0 ** -126, 1.5 * 2.0 ** -126]
    big = [1.0, 1.0 + 2.0 ** -7, 2.0 ** 127, (2 - 2.0 ** -7) * 2.0 ** 127]
    vals = [0.0] + tiny + big
    return bf16(np.array(vals + [-v for v in vals], F32))


def _operand_pairs():
    rng = np.random.default_rng(18)
    a = random_bf16(rng, 20000)
    b = random_bf16(rng, 20000)
    # products near and below fp32's normal range
    c = random_bf16(rng, 4000, -80, -40)
    d = random_bf16(rng, 4000, -100, -60)
    s = special_bf16()
    sa, sb = np.meshgrid(s, s)
    return (np.concatenate([a, c, sa.ravel()]),
            np.concatenate([b, d, sb.ravel()]))


def test_one_bf16_multiply_is_the_parents_rounded_fp32_product():
    a, b = _operand_pairs()
    with np.errstate(over="ignore"):
        parent = bf16(a * b)                      # fp32 product, then bf16
    new = once(a.astype(np.float64) * b)          # exact product, once
    assert np.array_equal(parent.view(np.int32), new.view(np.int32))
    # the products below fp32's normal range were reached
    assert (np.abs(a.astype(np.float64) * b) < 2.0 ** -126).sum() > 1000


def test_one_bf16_add_is_the_parents_rounded_fp32_sum():
    rng = np.random.default_rng(19)
    a = random_bf16(rng, 20000, -120, 120)
    gap = rng.integers(0, 41, size=a.size)
    # b: exponent a's minus a gap of 0-40, either sign
    b = bf16((a * np.exp2(-gap.astype(np.float64))
              * rng.uniform(0.5, 2.0, size=a.size)
              * np.where(rng.random(a.size) < 0.5, -1, 1)).astype(F32))
    # exact ties: a plus half an ulp of a, and a bf16 midpoint's neighbours
    ulp = np.exp2(np.floor(np.log2(np.abs(a).astype(np.float64))) - 7)
    ties = bf16(ulp.astype(F32) / 2)
    sa, sb = np.meshgrid(special_bf16(), special_bf16())
    x = np.concatenate([a, a, sa.ravel()])
    y = np.concatenate([b, ties, sb.ravel()])
    with np.errstate(over="ignore", invalid="ignore"):
        parent = bf16(x + y)                      # fp32 sum, then bf16
        new = once(x.astype(np.float64) + y)
    keep = ~np.isnan(parent)                      # inf - inf
    assert np.array_equal(parent[keep].view(np.int32),
                          new[keep].view(np.int32))
    assert keep.sum() > 40000
    # the ties were ties, and gaps past 16 were reached
    assert (gap > 16).sum() > 5000


def test_once_is_a_nearest_bf16_value():
    """The reference rounding: no bf16 neighbour is nearer the exact
    value."""
    a, b = _operand_pairs()
    exact = a.astype(np.float64) * b
    fin = np.abs(exact) < 3e38
    got = once(exact[fin])
    err = np.abs(got.astype(np.float64) - exact[fin])
    bits = got.view(np.int32)
    for step in (0x10000, -0x10000):
        other = (bits + step).view(np.float32).astype(np.float64)
        ok = np.isfinite(other)
        assert (np.abs(other - exact[fin])[ok] >= err[ok]).all()


def reduce_scatter(vals):
    """``warp_sums`` step for step: vals (M, N, 32) lane values -> (M, N),
    each value's sum as the kernel's lanes end with it (every lane alike)."""
    m, n, _ = vals.shape
    p = 1
    while p < n:
        p *= 2
    lp = p.bit_length() - 1
    steps = min(lp, 5)
    w = np.zeros((m, p, 32), F32)
    w[:, :n] = vals
    live, off = p, 16
    while off:
        if live > 1:
            half = live // 2
            up = (LANES & off) != 0
            send = np.where(up, w[:, :half], w[:, half:live])
            keep = np.where(up, w[:, half:live], w[:, :half])
            w[:, :half] = keep + send[..., LANES ^ off]
            live = half
        else:
            w[:, 0] = w[:, 0] + w[:, 0][..., LANES ^ off]
        off //= 2
    out = np.empty((m, n, 32), F32)
    for i in range(n):
        holder = sum(((i >> (lp - 1 - k)) & 1) * (16 >> k)
                     for k in range(steps))
        out[:, i] = w[:, i & (live - 1), holder][:, None]
    if p == 1:
        out[:, 0] = w[:, 0]
    assert (out == out[..., :1]).all()
    return out[..., 0]


@pytest.mark.parametrize("n_values", [1, 2, 3, 6, 8, 20, 32, 40])
def test_reduce_scatter_gives_the_butterflys_bits(n_values):
    rng = np.random.default_rng(n_values)
    vals = (rng.normal(size=(64, n_values, 32))
            * np.exp2(rng.integers(-20, 20, size=(64, n_values, 32)))
            ).astype(F32)
    want = butterfly(vals)
    assert (want == want[..., :1]).all()
    got = reduce_scatter(vals)
    assert np.array_equal(got.view(np.int32), want[..., 0].view(np.int32))


def bf16_inputs(c, h):
    n, tri, g, arrs = _inputs(c, h)
    x, s_src, s_dst, g_agg, g_rs = arrs
    return g, bf16(x), s_src, s_dst, bf16(g_agg), g_rs


def backward_bf16(x, s_src, s_dst, g_agg, g_rs, g, new):
    """Pass 1 a warp per row j, pass 2 d_s_src's row sums, with the bf16
    rounding points; ``new``: the redesigned kernel (the term by single
    roundings of exact values, the dots by ``reduce_scatter``), else its
    parent (fp32 then round_bf16, a butterfly a group)."""
    row, col, rp = g.row.astype(np.int64), g.col.astype(np.int64), g.row_ptr
    n, c = x.shape
    heads = s_src.shape[1]
    vec = vec_of(c)
    lane = (np.arange(g.n_edges) - rp[row]) % 32
    score = bf16(s_src)[col] + bf16(s_dst)[row]                # (E, H)
    e = edge_weight(score)
    r = bf16(g_rs)[col]
    eb = bf16(e)
    ds = np.empty((g.n_edges, heads), F32)
    if new:
        parts = [slice_dots(x[row], g_agg[col, hh], vec) for hh in range(heads)]
        nv = parts[0].shape[1]
        groups = -(-nv // 32)
        bucket = next(b for b in (1, 2, 3, 5, 10) if b >= groups)
        lanes = np.concatenate([by_lane(p, bucket) for p in parts], axis=1)
        sums = reduce_scatter(lanes)                    # (E, H x bucket)
    for hh in range(heads):
        if new:
            dot = np.zeros(g.n_edges, F32)
            for gg in range(bucket):
                if 32 * gg < nv:
                    dot = dot + sums[:, hh * bucket + gg]
        else:
            dot = warp_dot(x[row], g_agg[col, hh], vec, lane)
        ds[:, hh] = bf16(-(dot + r[:, hh]) * e[:, hh] * leaky_grad(score[:, hh]))
    # the d_x term: bf16(bf16(e_h) G[k, h]) summed over heads in bf16
    g_rows = g_agg[col]                                        # (E, H, C)
    if new:
        term = once(eb[:, 0, None].astype(np.float64) * g_rows[:, 0])
        for hh in range(1, heads):
            p = once(eb[:, hh, None].astype(np.float64) * g_rows[:, hh])
            term = once(term.astype(np.float64) + p)
    else:
        term = bf16(eb[:, 0, None] * g_rows[:, 0])
        for hh in range(1, heads):
            term = bf16(term + bf16(eb[:, hh, None] * g_rows[:, hh]))
    acc = np.zeros((n, c), F32)
    deg = np.diff(rp)
    for t in range(deg.max()):                 # edges in order, from 0
        live = deg > t
        acc[live] = acc[live] + term[rp[:-1][live] + t]
    scratch = np.full_like(ds, np.nan)
    scratch[g.rev] = ds
    return bf16(acc), row_sums(scratch, rp), row_sums(ds, rp)


NAMES = ("d_x", "d_s_src", "d_s_dst")


@pytest.mark.parametrize("c,h", CASES)
def test_bf16_backward_schedule_gives_the_parents_bits(c, h):
    g, *arrs = bf16_inputs(c, h)
    assert np.diff(g.row_ptr).max() > 64
    old = backward_bf16(*arrs, g, new=False)
    new = backward_bf16(*arrs, g, new=True)
    for a, b, name in zip(new, old, NAMES):
        assert a.dtype == np.float32 and np.isfinite(a).all()
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32),
                                      err_msg=name)
    x, s_src, s_dst, g_agg, g_rs = (torch.from_numpy(a) for a in arrs)
    twin = tgb.gat_backward_twin(x.to(torch.bfloat16), s_src, s_dst,
                                 g_agg.to(torch.bfloat16), g_rs,
                                 g.to_torch("cpu"))
    # the twin takes x and G in bf16 and returns d_x in bf16
    assert twin[0].dtype == torch.bfloat16
    twin = [t.to(torch.float32).numpy() for t in twin]
    np.testing.assert_array_equal(new[0].view(np.int32),
                                  twin[0].view(np.int32), err_msg="d_x")
    for a, t, name in zip(new[1:], twin[1:], NAMES[1:]):
        scale = np.abs(t).max()
        assert np.abs(a - t).max() <= BF16_TOL * scale, name
