"""The port's CUDA kernels vs their plain-PyTorch twins, on the card.

Marked ``cuda``: these skip where torch sees no GPU.  On a GPU machine
(which need not have JAX) run them without the JAX test set-up:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: the GAT kernel sums a row's edges in a fixed order and the
twin with ``index_add_``: rtol = atol = 1e-5; the GAT backward adds
per-edge dot products over C and heads, rtol = atol = 1e-4.  Both GAT
kernels and the weighted segment sum are held against their twins run on
CPU copies of the inputs (``on_cpu``), where ``index_add_`` adds in a
fixed order; on the card it adds by atomics in an order that changes from
run to run, a reference that moved by more than the limit once.  The NT-Xent
kernels sum 2B * d products per row in another order than cuBLAS: lse
rtol = atol = 1e-5, gradients max |err| <= 1e-4 * max |twin|; so do the
mixture kernels, under the same limits for lse, dz, dalpha and dbeta, and
two runs of any of the four loss kernels give the same bits.  The bf16
entries (``--dtype bfloat16``: both GAT kernels and the four loss kernels
on bf16 operands) are held against their bf16 twins on CPU copies of the
inputs at max |err| <= 4e-3 x max |twin| per output, about one bf16 ulp
of the output's scale, with bitwise repeats.  The weighted segment
sum adds a row's edges in CSR order, the twin with ``index_add_``: rtol =
atol = 1e-5, and two runs give the same bits; so does its bf16 entry,
whose terms are exact in f32 (or, with ``round_term``, rounded to bf16
alike on both sides) and whose outputs are f32, well inside 4e-3 x max
|twin|.  The GAT under attention dropout sums on the same kernel: its
output rtol = atol = 1e-5, its gradients (a dot per edge beside the
sums) rtol = atol = 1e-4, and two runs give the same bits.  The rank
kernels sum the dot products in another order than cuBLAS, so a near-tie
may flip: ranks must agree on >= 99 % of queries; tie rules are checked on
the kernel's own exact ties; two runs, and runs with any number of column
splits, give the same bits.
"""

import numpy as np
import pytest
import torch

from snag_tpu_torch.data.graph import DeviceGraph, build_graph
from snag_tpu_torch.ops.cuda import gat_attention as ga
from snag_tpu_torch.ops.cuda import gat_bwd as gb
from snag_tpu_torch.ops.cuda import ntxent as nx
from snag_tpu_torch.ops.cuda import rank_eval as rk
from snag_tpu_torch.ops.cuda import snag_loss as sl
from snag_tpu_torch.ops.cuda import tile_segment as ts
from snag_tpu_torch.ops.gat_agg import (gat_aggregate, gat_dropout_aggregate,
                                        reverse_weights)
from snag_tpu_torch.ops.gat_attn_primitive import gat_attention

pytestmark = pytest.mark.cuda
BF16_TOL = 4e-3          # x max |twin| per output of a bf16 kernel


def on_cpu(twin, *args):
    """``twin`` on CPU copies of ``args`` (tensors and a DeviceGraph), its
    outputs moved back to the device of the first tensor."""
    dev = next(a.device for a in args if isinstance(a, torch.Tensor))

    def cpu(a):
        if isinstance(a, DeviceGraph):
            return DeviceGraph(*(cpu(t) for t in a))
        return a.cpu() if isinstance(a, torch.Tensor) else a
    out = twin(*(cpu(a) for a in args))
    return tuple(o.to(dev) for o in out)


def assert_bf16_close(got, want):
    for a, w in zip(got, want):
        assert a.dtype == w.dtype and torch.isfinite(a.float()).all()
        err = (a.float() - w.float()).abs().max().item()
        assert err <= BF16_TOL * w.float().abs().max().item()


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _gat_inputs(dev, n=300, n_tri=900, c=48, h=2, seed=0):
    rng = np.random.default_rng(seed)
    tri = [(int(rng.integers(n)), 0, int(rng.integers(n)))
           for _ in range(n_tri)]
    tri += [(int(rng.integers(n)), 0, 7) for _ in range(200)]   # a hub row
    g = build_graph(n, tri).to_torch(dev)

    def t(*shape):
        return torch.as_tensor(rng.normal(size=shape).astype(np.float32),
                               device=dev)
    return g, t(n, c), t(n, h), t(n, h)


# a warp per row, lane l owning slices l + 32 g: C = 1,280 is the widest row
# of float4 slices (10 a lane), C = 319 the widest of single floats
GAT_WIDTHS = [(48, 2), (30, 1), (300, 2), (64, 4), (1200, 2), (1280, 2),
              (319, 1)]


@pytest.mark.parametrize("c,h", GAT_WIDTHS)
def test_gat_kernel_matches_twin(dev, c, h):
    g, x, s_src, s_dst = _gat_inputs(dev, c=c, h=h)
    agg, rs = ga.gat_attention_cuda(x, s_src, s_dst, g)
    torch.cuda.synchronize()
    want_agg, want_rs = on_cpu(ga.gat_attention_twin, x, s_src, s_dst, g)
    torch.testing.assert_close(agg, want_agg, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(rs, want_rs, rtol=1e-5, atol=1e-5)


def test_gat_wrappers_refuse_what_the_kernel_does_not_take(dev):
    g, x, s_src, s_dst = _gat_inputs(dev)
    with pytest.raises(TypeError):
        ga.gat_attention_cuda(x.double(), s_src, s_dst, g)
    with pytest.raises(ValueError):
        ga.gat_attention_cuda(x.t().contiguous().t(), s_src, s_dst, g)
    with pytest.raises(ValueError):
        ga.gat_attention_cuda(x, s_src.cpu(), s_dst, g)
    for c in (1284, 321):       # 321 floats, or 321 float4 slices: wide
        wide = torch.ones(x.shape[0], c, device=dev)
        agg, rs = ga.gat_attention_cuda(wide, s_src, s_dst, g)
        torch.testing.assert_close(agg, rs[:, :, None].expand(-1, -1, c))
        d_x, _, _ = gb.gat_backward_cuda(
            wide, s_src, s_dst, torch.zeros(x.shape[0], 2, c, device=dev),
            s_src, g)
        assert not d_x.any()
    with pytest.raises(ValueError, match="at least one head"):
        ga.gat_attention_cuda(x, s_src[:, :0], s_dst[:, :0], g)
    before = ga.STATS.launches
    with torch.no_grad():
        gat_attention(x, s_src, s_dst, g)
    assert ga.STATS.launches == before + 1
    # the backward kernel needs the symmetric multiset
    g_agg = torch.ones(x.shape[0], 2, x.shape[1], device=dev)
    with pytest.raises(ValueError, match="symmetric"):
        gb.gat_backward_cuda(x, s_src, s_dst, g_agg, s_src,
                             g._replace(rev=None))


@pytest.mark.parametrize("c,h", GAT_WIDTHS)
def test_gat_backward_kernel_matches_twin(dev, c, h):
    g, x, s_src, s_dst = _gat_inputs(dev, c=c, h=h, seed=c)
    rng = np.random.default_rng(h)
    g_agg = torch.as_tensor(rng.normal(size=(x.shape[0], h, c)).astype(
        np.float32), device=dev)
    g_rs = torch.as_tensor(rng.normal(size=(x.shape[0], h)).astype(
        np.float32), device=dev)
    got = gb.gat_backward_cuda(x, s_src, s_dst, g_agg, g_rs, g)
    torch.cuda.synchronize()
    want = on_cpu(gb.gat_backward_twin, x, s_src, s_dst, g_agg, g_rs, g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def _gat_grads_inputs(dev, n, c, h, seed):
    g, x, s_src, s_dst = _gat_inputs(dev, n=n, c=c, h=h, seed=seed)
    rng = np.random.default_rng(seed + 1)
    g_agg = torch.as_tensor(rng.normal(size=(n, h, c)).astype(np.float32),
                            device=dev)
    g_rs = torch.as_tensor(rng.normal(size=(n, h)).astype(np.float32),
                           device=dev)
    return g, x, s_src, s_dst, g_agg, g_rs


@pytest.mark.parametrize("n", [301, 302, 303])
def test_gat_kernels_partial_last_block(dev, n):
    """A row count that leaves the last block of 4 (or 8) rows part
    empty: its idle warps return, the rows before them are complete."""
    g, x, s_src, s_dst, g_agg, g_rs = _gat_grads_inputs(dev, n, 300, 2, n)
    agg, rs = ga.gat_attention_cuda(x, s_src, s_dst, g)
    got = gb.gat_backward_cuda(x, s_src, s_dst, g_agg, g_rs, g)
    torch.cuda.synchronize()
    want_agg, want_rs = on_cpu(ga.gat_attention_twin, x, s_src, s_dst, g)
    torch.testing.assert_close(agg, want_agg, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(rs, want_rs, rtol=1e-5, atol=1e-5)
    want = on_cpu(gb.gat_backward_twin, x, s_src, s_dst, g_agg, g_rs, g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("c,h", [(300, 2), (30, 1), (1200, 2)])
def test_gat_kernels_repeat_bitwise(dev, c, h):
    g, x, s_src, s_dst, g_agg, g_rs = _gat_grads_inputs(dev, 300, c, h, c)
    for fn in (lambda: ga.gat_attention_cuda(x, s_src, s_dst, g),
               lambda: gb.gat_backward_cuda(x, s_src, s_dst, g_agg, g_rs, g)):
        first, again = fn(), fn()
        torch.cuda.synchronize()
        for a, b in zip(first, again):
            assert torch.equal(a, b)


def test_gat_autograd_launches_both_kernels(dev):
    g, x, s_src, s_dst = _gat_inputs(dev)
    before = (ga.STATS.launches, gb.STATS.launches)
    xs = [t.clone().requires_grad_() for t in (x, s_src, s_dst)]
    agg, rs = gat_attention(*xs, g)
    (agg.sum() + rs.sum()).backward()
    torch.cuda.synchronize()
    assert (ga.STATS.launches, gb.STATS.launches) == (before[0] + 1,
                                                      before[1] + 1)
    want = on_cpu(gb.gat_backward_twin, x, s_src, s_dst,
                  torch.ones_like(agg), torch.ones_like(rs), g)
    for t, w in zip(xs, want):
        torch.testing.assert_close(t.grad, w, rtol=1e-4, atol=1e-4)


def _ntxent_inputs(dev, m, b, d, n_valid, seed):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(m, 2 * b, d)).astype(np.float32)
    z[:, b:] = z[:, :b] + 0.5 * z[:, b:]
    z /= np.linalg.norm(z, axis=-1, keepdims=True)
    z[0, 1] = 0.0                                   # an all-zero row
    v = np.concatenate([np.arange(b) < n_valid] * 2).astype(np.float32)
    coef = rng.uniform(0.1, 1.0, size=(m, 2 * b)).astype(np.float32) * v
    return [torch.as_tensor(a, device=dev) for a in (z, v, coef)]


# the gradient kernel's tiles (gram_grad.cuh): 32 rows, 64 columns, n8
# feature tiles in passes of 320 features; d = 1,800 takes two feature
# chunks (the accumulator holds 1,504 columns on the H100), d = 37 the
# scalar loads (d % 4 != 0); the families' shapes at batch 3,500:
# MEAformer's joint loss (M = 1, d = 1,200) and an MCLEA modality's padded
# last batch (M = 1, d = 300, 1,000 valid)
@pytest.mark.parametrize("m,b,d,n_valid", [(2, 9, 8, 9), (3, 130, 48, 100),
                                           (2, 257, 300, 257),
                                           (1, 70, 1200, 64),
                                           (2, 300, 1800, 290),
                                           (4, 75, 37, 70),
                                           (1, 3500, 1200, 3500),
                                           (1, 3500, 300, 1000)])
def test_ntxent_kernels_match_twins(dev, m, b, d, n_valid):
    z, v, coef = _ntxent_inputs(dev, m, b, d, n_valid, seed=b)
    lse = nx.streaming_lse_cuda(z, v, 0.1)
    torch.cuda.synchronize()
    want_lse = nx.streaming_lse_twin(z, v, 0.1)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-5)
    dz = nx.ntxent_grad_cuda(z, want_lse, coef, v, 0.1)
    torch.cuda.synchronize()
    want = nx.ntxent_grad_twin(z, want_lse, coef, v, 0.1)
    assert torch.isfinite(dz).all()
    assert (dz - want).abs().max().item() <= 1e-4 * want.abs().max().item()
    again = nx.ntxent_grad_cuda(z, want_lse, coef, v, 0.1)
    assert torch.equal(dz, again)


def test_ntxent_grad_plan(dev):
    """Two blocks per SM and the main-path body at the IIR shape; the
    main-path body, one chunk, up to the accumulator's 1,504 columns; past
    it the wide body in one cluster of balanced chunks, two blocks an
    SM."""
    iir = nx.grad_plan(4, 7000, 300, dev)
    assert (iir["chunks"], iir["blocks_per_sm"], iir["wide"]) == (1, 2, 0)
    p = nx.grad_plan(2, 7000, 1504, dev)
    assert (p["wide"], p["chunks"], p["cluster"], p["groups"]) == \
        (0, 1, 1, 1), p
    for d, chunks in ((1505, 5), (1800, 6)):
        p = nx.grad_plan(2, 7000, d, dev)
        assert (p["wide"], p["chunks"], p["cluster"], p["groups"],
                p["blocks_per_sm"]) == (1, chunks, chunks, 1, 2), p
    assert nx.grad_plan(1, 600, 4000, dev)["wide"] == 1


# (M, d, mixture, chunks, blocks a cluster, blocks an SM) of the wide
# body's plan (csrc/gram_grad.cuh wide_plan) at n2 = 7,000: one cluster
# group (K and W once a tile pair), two blocks an SM where a chunk's
# accumulator allows it, clusters of up to 16
@pytest.mark.parametrize("m,d,mix,chunks,cluster,per_sm", [
    (2, 1800, False, 6, 6, 2), (1, 4000, False, 13, 13, 2),
    (4, 1600, True, 4, 16, 2), (1, 1512, True, 5, 5, 2),
    (6, 1600, True, 2, 12, 1)])
def test_wide_plan_on_the_card(dev, m, d, mix, chunks, cluster, per_sm):
    """The wide plan, and scratch for the splits' partials (and the
    mixture's dalpha and per-block dbeta partials)."""
    p = (sl if mix else nx).grad_plan(m, 7000, d, dev)
    assert (p["wide"], p["chunks"], p["cluster"], p["groups"],
            p["blocks_per_sm"]) == (1, chunks, cluster, 1, per_sm), p
    assert p["q"] * (m if mix else 1) == p["cluster"] <= 16
    nb, sp = -(-7000 // 32), p["splits"]
    assert p["scratch"] == (sp - 1) * m * 7000 * d + (
        sp * nb * p["cluster"] * m + (sp - 1) * 7000 * m if mix else 0)


# the lse kernel's tiles (gram_lse.cuh): 128 rows for NT-Xent; ragged n2,
# n2 under one tile, d not a multiple of 4 (scalar loads) or of 8, 1,000 of
# 3,500 pairs valid, d = 1,800 in one pass
@pytest.mark.parametrize("m,b,d,n_valid", [(1, 50, 20, 50), (2, 97, 50, 80),
                                           (6, 130, 300, 130),
                                           (1, 3500, 300, 1000),
                                           (2, 300, 1800, 290),
                                           (3, 20, 37, 20)])
def test_ntxent_lse_kernel_matches_twin(dev, m, b, d, n_valid):
    z, v, _ = _ntxent_inputs(dev, m, b, d, n_valid, seed=b)
    lse = nx.streaming_lse_cuda(z, v, 0.1)
    again = nx.streaming_lse_cuda(z, v, 0.1)
    torch.cuda.synchronize()
    want = nx.streaming_lse_twin(z, v, 0.1)
    assert torch.isfinite(lse).all()
    torch.testing.assert_close(lse, want, rtol=1e-5, atol=1e-5)
    assert torch.equal(lse, again)


def test_lse_plans(dev):
    """One block per unordered pair of tiles: 55 tiles of 128 rows (NT-Xent)
    and 73 of 96 (mixture) at n2 = 7,000; scratch is channels x tiles x
    n2."""
    p = nx.lse_plan(4, 7000, 300, dev)
    assert (p["tile"], p["pairs"], p["scratch"]) == (128, 1540, 4 * 55 * 7000)
    q = sl.lse_plan(4, 7000, 300, dev)
    assert (q["tile"], q["pairs"], q["scratch"]) == (96, 2701, 6 * 73 * 7000)
    assert p["blocks_per_sm"] >= 1 and q["blocks_per_sm"] >= 1


def _mixture_inputs(dev, m, b, d, n_valid, seed):
    """Unit rows with near-copy positives, one all-zero modality row, unit
    mixture coefficients, coefficients zero on invalid rows."""
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(m, 2 * b, d)).astype(np.float32)
    z[:, b:] = z[:, :b] + 0.5 * z[:, b:]
    z /= np.linalg.norm(z, axis=-1, keepdims=True)
    z[min(1, m - 1), 2] = 0.0                       # an all-zero row
    alpha = np.abs(rng.normal(size=(2 * b, m))).astype(np.float32)
    alpha /= np.linalg.norm(alpha, axis=1, keepdims=True)
    u = rng.uniform(0.2, 1.0, size=m).astype(np.float32)
    beta = u * u / np.sum(u * u)
    v = np.concatenate([np.arange(b) < n_valid] * 2).astype(np.float32)
    coef = rng.uniform(0.1, 1.0, size=(m + 2, 2 * b)).astype(np.float32) * v
    return [torch.as_tensor(a, device=dev) for a in (z, alpha, beta, v, coef)]


# the gradient kernel's tiles: 32 rows, 64 columns, n8 feature tiles in
# passes of 320 features; (6, 100, 300) splits into two groups of three.
# At M = 1 dalpha is a difference of terms ~50x its size: at d = 1,200 and
# B = 50 even exact fp32 products miss the limit (2.1e-4; 3xTF32 1.9e-4,
# tests/test_torch_tf32x3.py::rel_errors), so that case runs at B = 500
# (2.4e-5 and 2.6e-5).
@pytest.mark.parametrize("m,b,d,n_valid", [(1, 9, 8, 9), (4, 130, 48, 100),
                                           (4, 257, 300, 257),
                                           (6, 70, 300, 64), (3, 40, 30, 40),
                                           (4, 75, 37, 70), (2, 33, 340, 33),
                                           (6, 100, 300, 100),
                                           (1, 500, 1200, 500)])
def test_mixture_kernels_match_twins(dev, m, b, d, n_valid):
    z, alpha, beta, v, coef = _mixture_inputs(dev, m, b, d, n_valid, seed=b)
    lse = sl.mixture_lse_cuda(z, alpha, beta, v, 0.1)
    torch.cuda.synchronize()
    want_lse = sl.mixture_lse_twin(z, alpha, beta, v, 0.1)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-5)
    got = sl.mixture_grad_cuda(z, alpha, beta, want_lse, coef, v, 0.1)
    torch.cuda.synchronize()
    want = sl.mixture_grad_twin(z, alpha, beta, want_lse, coef, v, 0.1)
    for a, w in zip(got, want):
        assert torch.isfinite(a).all()
        assert (a - w).abs().max().item() <= 1e-4 * w.abs().max().item()
    again = sl.mixture_grad_cuda(z, alpha, beta, want_lse, coef, v, 0.1)
    for a, w in zip(got, again):
        assert torch.equal(a, w)


# the lse kernel's tiles: 96 rows for the mixtures; M = 1 and 6, the edge
# cases of the NT-Xent lse cases above
@pytest.mark.parametrize("m,b,d,n_valid", [(1, 50, 20, 50), (6, 97, 50, 80),
                                           (6, 100, 300, 100),
                                           (4, 3500, 300, 1000),
                                           (6, 40, 1800, 40),
                                           (1, 33, 37, 33)])
def test_mixture_lse_kernel_matches_twin(dev, m, b, d, n_valid):
    z, alpha, beta, v, _ = _mixture_inputs(dev, m, b, d, n_valid, seed=b)
    lse = sl.mixture_lse_cuda(z, alpha, beta, v, 0.1)
    again = sl.mixture_lse_cuda(z, alpha, beta, v, 0.1)
    torch.cuda.synchronize()
    want = sl.mixture_lse_twin(z, alpha, beta, v, 0.1)
    assert torch.isfinite(lse).all()
    torch.testing.assert_close(lse, want, rtol=1e-5, atol=1e-5)
    assert torch.equal(lse, again)


def test_mixture_wrappers_refuse_what_the_kernels_do_not_take(dev):
    z, alpha, beta, v, coef = _mixture_inputs(dev, 4, 20, 16, 20, seed=0)
    with pytest.raises(ValueError, match="modalities"):
        sl.mixture_lse_cuda(torch.zeros(7, 40, 16, device=dev),
                            torch.zeros(40, 7, device=dev),
                            torch.zeros(7, device=dev), v, 0.1)
    with pytest.raises(TypeError):
        sl.mixture_lse_cuda(z.double(), alpha, beta, v, 0.1)


def _mixture_grad_against_twin(dev, m, b, d, **kw):
    """The f32 gradient kernel against its twin on CPU copies, max |err| <=
    1e-4 x max |twin| for dz, dalpha and dbeta; returns its plan."""
    z, alpha, beta, v, coef = _mixture_inputs(dev, m, b, d, b, seed=d)
    lse = sl.mixture_lse_twin(*(t.cpu() for t in (z, alpha, beta, v)),
                              0.1).to(dev)
    got = sl.mixture_grad_cuda(z, alpha, beta, lse, coef, v, 0.1)
    torch.cuda.synchronize()
    want = on_cpu(sl.mixture_grad_twin, z, alpha, beta, lse, coef, v, 0.1)
    for a, w in zip(got, want):
        assert torch.isfinite(a).all()
        assert (a - w).abs().max().item() <= 1e-4 * w.abs().max().item()
    return sl.grad_plan(m, 2 * b, d, dev)


def test_mixture_grad_takes_any_width(dev):
    """Past one modality's fit in the f32 kernel's shared accumulator (at
    least 1,486 columns) the wide body takes the gradient: M = 4 at d =
    4,000, one cluster of every modality's chunks, and M = 1 at the cap
    (the main-path body) and just past it (B = 500 at M = 1, where dalpha
    is a difference of terms ~50x its size and a small batch misses the
    limit with exact fp32 products: test_mixture_kernels_match_twins)."""
    cap = sl._grad_cap(sl._library(), dev)
    assert cap >= 1486
    p = _mixture_grad_against_twin(dev, 4, 40, 4000)
    assert (p["wide"], p["groups"], p["cluster"]) == (1, 1, 4 * p["q"]), p
    p = _mixture_grad_against_twin(dev, 1, 500, cap)
    assert (p["wide"], p["chunks"]) == (0, 1), p
    p = _mixture_grad_against_twin(dev, 1, 500, cap + 1)
    assert p["wide"] == 1 and p["chunks"] >= 2, p


# The f32 NT-Xent gradient at MEAformer's joint loss (1, 3500, 1200) and
# the unfused GMI at d = 1,200 (M = 2), which keep the main-path body, and
# the wide body (csrc/gram_grad.cuh gram_grad_wide) at the shapes past the
# main-path body's accumulator: GMI6 (M = 2, d = 1,800), d = 2,000 and
# 4,000, the cap and just past it; and the mixture at M = 4, d = 1,600
# (SNAG with modalities 1,600 wide) and 4,000, M = 1 at d = 1,512 and
# 4,000, M = 6 at d = 1,600 (a cluster of 12); against their twins on the
# card within the limits above, with bitwise repeats and the launch counted
# apart.
def _main_path_cap():
    """The widest d that the main-path body's accumulator holds at one
    modality a block (1,504 on the H100)."""
    return sl._grad_cap(sl._library(), torch.device("cuda"))


@pytest.mark.parametrize("m,b,d", [(1, 3500, 1200), (2, 3500, 1200),
                                   (2, 3500, 1800), (1, 300, 4000),
                                   (1, 500, "cap"), (1, 500, "cap + 1"),
                                   (3, 70, 2000)])
def test_ntxent_grad_wide_matches_twin(dev, m, b, d):
    if isinstance(d, str):
        d = _main_path_cap() + (d == "cap + 1")
    z, v, coef = _ntxent_inputs(dev, m, b, d, b, seed=d)
    lse = nx.streaming_lse_twin(z, v, 0.1)
    plan = nx.grad_plan(m, 2 * b, d, dev)
    assert plan["wide"] == int(d > _main_path_cap()), plan
    before = (nx.STATS_GRAD.launches, nx.STATS_GRAD_WIDE.launches)
    dz = nx.ntxent_grad_cuda(z, lse, coef, v, 0.1)
    again = nx.ntxent_grad_cuda(z, lse, coef, v, 0.1)
    torch.cuda.synchronize()
    want = nx.ntxent_grad_twin(z, lse, coef, v, 0.1)
    assert torch.isfinite(dz).all()
    assert (dz - want).abs().max().item() <= 1e-4 * want.abs().max().item()
    assert torch.equal(dz, again)
    wide = 2 * plan["wide"]
    assert (nx.STATS_GRAD.launches, nx.STATS_GRAD_WIDE.launches) == \
        (before[0] + 2 - wide, before[1] + wide)


@pytest.mark.parametrize("m,b,d", [(4, 3500, 1600), (1, 3500, 1512),
                                   (4, 40, 4000), (1, 500, 4000),
                                   (6, 100, 1600), (2, 130, 2000)])
def test_mixture_grad_wide_matches_twin(dev, m, b, d):
    z, alpha, beta, v, coef = _mixture_inputs(dev, m, b, d, b, seed=d)
    lse = sl.mixture_lse_twin(z, alpha, beta, v, 0.1)
    plan = sl.grad_plan(m, 2 * b, d, dev)
    assert plan["wide"] == 1 and plan["cluster"] == m * plan["q"], plan
    before = sl.STATS_GRAD_WIDE.launches
    got = sl.mixture_grad_cuda(z, alpha, beta, lse, coef, v, 0.1)
    again = sl.mixture_grad_cuda(z, alpha, beta, lse, coef, v, 0.1)
    torch.cuda.synchronize()
    want = sl.mixture_grad_twin(z, alpha, beta, lse, coef, v, 0.1)
    for a, a2, w in zip(got, again, want):
        assert torch.isfinite(a).all()
        assert (a - w).abs().max().item() <= 1e-4 * w.abs().max().item()
        assert torch.equal(a, a2)
    assert sl.STATS_GRAD_WIDE.launches == before + 2


def test_main_path_gradients_keep_their_body(dev):
    """At d = 300 (IIR, ECIA, MCLEA's modality loss; the mixture at M = 4
    and 6) and NT-Xent's d = 1,200 (MEAformer's joint loss, GMI) both
    gradients keep the main-path body: its plan, and no wide launch."""
    for d in (300, 1200):
        assert nx.grad_plan(1, 7000, d, dev)["wide"] == 0
    for m in (4, 6):
        p = sl.grad_plan(m, 7000, 300, dev)
        assert (p["wide"], p["chunks"]) == (0, 1), p
    z, v, coef = _ntxent_inputs(dev, 4, 130, 300, 130, seed=1)
    before = nx.STATS_GRAD_WIDE.launches
    nx.ntxent_grad_cuda(z, nx.streaming_lse_twin(z, v, 0.1), coef, v, 0.1)
    assert nx.STATS_GRAD_WIDE.launches == before


def _segment_inputs(dev, c, h, seed=0, n=300):
    g, x, _, _ = _gat_inputs(dev, n=n, c=c, h=1, seed=seed)
    rng = np.random.default_rng(seed)
    e = torch.as_tensor(rng.uniform(0.1, 2.0, size=(g.n_edges, h)).astype(
        np.float32), device=dev)
    return g, x, e


# a warp per row, lane l owning slices l + 32 g of a column chunk: C = 300
# one chunk of float4 slices; 1,200 three chunks; 4,096 eight (1,024
# float4 slices, the widest row of the block-per-row kernel before); 1,023
# eight chunks of single floats; H = 5 and 8 a full head group and a tail,
# two full groups
SEGMENT_WIDTHS = [(48, 1), (30, 2), (300, 1), (64, 5), (1200, 1), (4096, 1),
                  (1023, 2), (300, 8)]


@pytest.mark.parametrize("c,h", SEGMENT_WIDTHS)
def test_weighted_segment_sum_matches_twin(dev, c, h):
    g, x, e = _segment_inputs(dev, c, h, seed=c)
    agg, rs = ts.weighted_segment_sum_cuda(x, e, g)
    torch.cuda.synchronize()
    want_agg, want_rs = on_cpu(ts.weighted_segment_sum_twin, x, e, g)
    torch.testing.assert_close(agg, want_agg, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(rs, want_rs, rtol=1e-5, atol=1e-5)


def test_weighted_segment_sum_plan_is_the_kernels(dev):
    """The built library launches the plan ``launch_plan`` computes."""
    for c in (30, 64, 300, 319, 1023, 1200, 4096, 8192):
        for h in (1, 2, 4, 5, 8):
            for vec in ((4, 1) if c % 4 == 0 else (1,)):
                assert ts.kernel_plan(c, h, vec) == ts.launch_plan(c, h, vec)


@pytest.mark.parametrize("n", [301, 302, 303])
def test_weighted_segment_sum_partial_last_block(dev, n):
    """A row count that leaves the last block of 4 rows part empty."""
    g, x, e = _segment_inputs(dev, 300, 2, seed=n, n=n)
    agg, rs = ts.weighted_segment_sum_cuda(x, e, g)
    torch.cuda.synchronize()
    want_agg, want_rs = on_cpu(ts.weighted_segment_sum_twin, x, e, g)
    torch.testing.assert_close(agg, want_agg, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(rs, want_rs, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("c,h", [(300, 1), (1023, 2)])
def test_weighted_segment_sum_empty_and_hub_rows(dev, c, h):
    """Rows with no edge (first and last among them) give zeros; a row of
    70 edges is walked 32 at a time; every row's edges are summed in CSR
    order, so the kernel repeats bit for bit."""
    lengths = np.array([0, 3, 0, 70, 1, 0, 33, 64, 65, 2, 0])
    n = len(lengths)
    rng = np.random.default_rng(c)
    row = np.repeat(np.arange(n), lengths)
    col = rng.integers(n, size=len(row)).astype(np.int32)
    row_ptr = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    g = DeviceGraph(n, len(row), torch.as_tensor(row_ptr, device=dev),
                    torch.as_tensor(row, device=dev),
                    torch.as_tensor(col, device=dev),
                    torch.ones(len(row), device=dev), None)
    x = torch.as_tensor(rng.normal(size=(n, c)).astype(np.float32),
                        device=dev)
    e = torch.as_tensor(rng.uniform(0.1, 2.0, size=(len(row), h)).astype(
        np.float32), device=dev)
    agg, rs = ts.weighted_segment_sum_cuda(x, e, g)
    again = ts.weighted_segment_sum_cuda(x, e, g)
    torch.cuda.synchronize()
    want_agg, want_rs = on_cpu(ts.weighted_segment_sum_twin, x, e, g)
    torch.testing.assert_close(agg, want_agg, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(rs, want_rs, rtol=1e-5, atol=1e-5)
    empty = torch.as_tensor(lengths == 0, device=dev)
    assert (agg[empty] == 0).all() and (rs[empty] == 0).all()
    assert torch.equal(agg, again[0]) and torch.equal(rs, again[1])


@pytest.mark.parametrize("c,h", [(300, 1), (1023, 2), (4096, 1), (64, 5)])
def test_weighted_segment_sum_repeats_bitwise(dev, c, h):
    g, x, e = _segment_inputs(dev, c, h, seed=c + 1)
    first = ts.weighted_segment_sum_cuda(x, e, g)
    again = ts.weighted_segment_sum_cuda(x, e, g)
    torch.cuda.synchronize()
    for a, b in zip(first, again):
        assert torch.equal(a, b)


def test_gcn_backward_takes_the_cached_reverse_weights(dev):
    """The GCN's e is the graph's adjacency: its backward launch runs on
    ``w_rev`` and gives the plain column reduction's d_x."""
    g, x, _ = _segment_inputs(dev, 300, 1, seed=5)
    e = g.w[:, None]
    assert reverse_weights(e, g).data_ptr() == g.w_rev.data_ptr()
    xg = x.clone().requires_grad_()
    agg, _ = gat_aggregate(xg, e, g)
    g_agg = torch.randn_like(agg)
    (agg * g_agg).sum().backward()
    torch.cuda.synchronize()
    want = torch.zeros_like(x).cpu().index_add_(
        0, g.col.long().cpu(), (e * g_agg[g.row, 0]).cpu()).to(dev)
    torch.testing.assert_close(xg.grad, want, rtol=1e-5, atol=1e-5)


# bf16 slices of 4 (8-byte loads) at C = 300 and 64; single bf16 at the odd
# C = 30 and 319; H = 1-5, a full head group and a tail at 5
SEGMENT_BF16_WIDTHS = [(300, 1), (30, 1), (319, 2), (64, 3), (300, 4),
                       (64, 5)]


def _segment_bf16_inputs(dev, c, h, seed):
    g, x, e = _segment_inputs(dev, c, h, seed=seed)
    g_agg = torch.randn(g.n_nodes, c, device=dev,
                        generator=torch.Generator(dev).manual_seed(seed))
    return (g, x.to(torch.bfloat16), e.to(torch.bfloat16),
            e[g.rev].to(torch.bfloat16), g_agg.to(torch.bfloat16))


@pytest.mark.parametrize("c,h", SEGMENT_BF16_WIDTHS)
def test_weighted_segment_sum_bf16_matches_twin(dev, c, h):
    """The bf16 entry, forward and the backward's reverse-edge launch with
    each term rounded to bf16, against the twin on CPU copies: the f32
    outputs of exact (or identically rounded) terms added in another order,
    rtol = atol = 1e-5, which is well inside 4e-3 x max |twin|; two runs
    give the same bits."""
    g, x, e, e_rev, g_agg = _segment_bf16_inputs(dev, c, h, seed=c + h)
    before = (ts.STATS_BF16.launches, ts.STATS.launches)
    for args, kw in (((x, e, g), {}),
                     ((g_agg, e_rev, g), {"round_term": True})):
        got = ts.weighted_segment_sum_cuda(*args, **kw)
        again = ts.weighted_segment_sum_cuda(*args, **kw)
        torch.cuda.synchronize()
        want = on_cpu(lambda *a: ts.weighted_segment_sum_twin(*a, **kw),
                      *args)
        for a, w, b in zip(got, want, again):
            assert a.dtype == torch.float32
            torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-5)
            assert torch.equal(a, b)
    assert (ts.STATS_BF16.launches, ts.STATS.launches) == (before[0] + 4,
                                                           before[1])


def test_weighted_segment_sum_bf16_plan_is_the_kernels(dev):
    """The built library launches the bf16 plan ``launch_plan(...,
    bf16=True)`` computes: a row on 16 lanes where it fits, ROWS rows a
    lane group, DEPTH edges in flight."""
    for c in (1, 7, 30, 33, 64, 75, 81, 300, 319, 320, 321, 1023, 1200,
              4096):
        for h in (1, 2, 4, 5, 8):
            for vec in ((4, 1) if c % 4 == 0 else (1,)):
                assert ts.kernel_plan(c, h, vec, bf16=True) == \
                    ts.launch_plan(c, h, vec, bf16=True)


def _bf16_dx_checks(g, g_agg, e_rev):
    """The backward's launch with a bf16 d_x against the twin on CPU
    copies (the f32 sums of identically rounded terms in CSR order, rtol =
    atol = 1e-5), against the f32-output launch cast to bf16 (bit for
    bit), and against itself (bitwise repeats); returns d_x."""
    got, rs = ts.weighted_segment_sum_cuda(g_agg, e_rev, g, round_term=True,
                                           out_bf16=True)
    again, _ = ts.weighted_segment_sum_cuda(g_agg, e_rev, g, round_term=True,
                                            out_bf16=True)
    agg, _ = ts.weighted_segment_sum_cuda(g_agg, e_rev, g, round_term=True)
    torch.cuda.synchronize()
    want = on_cpu(lambda *a: ts.weighted_segment_sum_twin(
        *a, round_term=True, out_bf16=True)[:1], g_agg, e_rev, g)[0]
    assert rs is None
    assert got.dtype == torch.bfloat16 and got.shape == agg.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-5,
                               atol=1e-5)
    assert torch.equal(got, agg.to(torch.bfloat16))
    assert torch.equal(got, again)
    return got


@pytest.mark.parametrize("c,h", SEGMENT_BF16_WIDTHS)
def test_weighted_segment_sum_bf16_dx_matches_twin(dev, c, h):
    g, _, _, e_rev, g_agg = _segment_bf16_inputs(dev, c, h, seed=c + h + 7)
    before = ts.STATS_BF16.launches
    _bf16_dx_checks(g, g_agg, e_rev)
    assert ts.STATS_BF16.launches == before + 3


@pytest.mark.parametrize("n", [301, 302, 303, 305])
def test_weighted_segment_sum_bf16_partial_last_block(dev, n):
    """Row counts that leave the last block part empty and the last lane
    group's walk of rows part full: the forward and both backward
    launches."""
    g, x, e, e_rev, g_agg = _segment_bf16_inputs(dev, 300, 1, seed=n)
    for args, kw in (((x, e, g), {}),
                     ((g_agg, e_rev, g), {"round_term": True})):
        got = ts.weighted_segment_sum_cuda(*args, **kw)
        torch.cuda.synchronize()
        want = on_cpu(lambda *a: ts.weighted_segment_sum_twin(*a, **kw),
                      *args)
        for a, w in zip(got, want):
            torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-5)
    _bf16_dx_checks(g, g_agg, e_rev)


@pytest.mark.parametrize("c,h", [(300, 1), (319, 2), (64, 5)])
def test_weighted_segment_sum_bf16_empty_and_hub_rows(dev, c, h):
    """Rows with no edge give zeros, runs of them too; rows of 33-70 edges
    cross the 16- or 32-edge chunks of a lane group's walk; a short walk
    shares its warp with a long one; the forward and both backward
    launches against the twin, bitwise repeats."""
    lengths = np.array([0, 3, 0, 70, 1, 0, 33, 64, 65, 2, 0, 17, 16, 0,
                        0, 0, 5, 0, 0, 0, 0, 9])
    n = len(lengths)
    rng = np.random.default_rng(c + h)
    row = np.repeat(np.arange(n), lengths)
    col = rng.integers(n, size=len(row)).astype(np.int32)
    row_ptr = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    g = DeviceGraph(n, len(row), torch.as_tensor(row_ptr, device=dev),
                    torch.as_tensor(row, device=dev),
                    torch.as_tensor(col, device=dev),
                    torch.ones(len(row), device=dev), None)
    bf = torch.bfloat16
    x = torch.as_tensor(rng.normal(size=(n, c)).astype(np.float32),
                        device=dev).to(bf)
    e = torch.as_tensor(rng.uniform(0.1, 2.0, size=(len(row), h)).astype(
        np.float32), device=dev).to(bf)
    empty = torch.as_tensor(lengths == 0, device=dev)
    for kw in ({}, {"round_term": True}):
        got = ts.weighted_segment_sum_cuda(x, e, g, **kw)
        again = ts.weighted_segment_sum_cuda(x, e, g, **kw)
        torch.cuda.synchronize()
        want = on_cpu(lambda *a: ts.weighted_segment_sum_twin(*a, **kw),
                      x, e, g)
        for a, w, b in zip(got, want, again):
            torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-5)
            assert (a[empty] == 0).all() and torch.equal(a, b)
    d_x = _bf16_dx_checks(g, x, e)
    assert (d_x[empty] == 0).all()


def test_weighted_segment_sum_bf16_rounds_each_term(dev):
    """``round_term`` changes the sum by the terms' roundings: without it
    the launch gives the twin's unrounded sum, and the two differ."""
    g, _, _, e_rev, g_agg = _segment_bf16_inputs(dev, 300, 1, seed=3)
    rounded, _ = ts.weighted_segment_sum_cuda(g_agg, e_rev, g,
                                              round_term=True)
    exact, _ = ts.weighted_segment_sum_cuda(g_agg, e_rev, g)
    want, _ = on_cpu(ts.weighted_segment_sum_twin, g_agg, e_rev, g)
    torch.testing.assert_close(exact, want, rtol=1e-5, atol=1e-5)
    assert (rounded - exact).abs().max().item() > 1e-4


def test_gcn_bf16_autograd_on_the_card(dev):
    """``gat_aggregate`` on bf16 operands (the bf16 GCN's): the forward and
    the bf16 d_x from ``w_rev_bf16`` against the twins on CPU copies."""
    g, x, _, _, _ = _segment_bf16_inputs(dev, 300, 1, seed=11)
    e = g.w_bf16[:, None]
    assert reverse_weights(e, g).data_ptr() == g.w_rev_bf16.data_ptr()
    xg = x.clone().requires_grad_()
    agg, rs = gat_aggregate(xg, e, g)
    g_agg = torch.randn_like(agg)
    (agg * g_agg).sum().backward()
    torch.cuda.synchronize()
    want = on_cpu(ts.weighted_segment_sum_twin, x, e, g)
    torch.testing.assert_close(agg, want[0], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(rs, want[1], rtol=1e-5, atol=1e-5)
    d_x, _ = on_cpu(lambda *a: ts.weighted_segment_sum_twin(
        *a, round_term=True), g_agg[:, 0].to(torch.bfloat16),
        g.w_rev_bf16[:, None], g)
    assert xg.grad.dtype == torch.bfloat16
    assert_bf16_close([xg.grad], [d_x[:, 0].to(torch.bfloat16)])


def test_gat_aggregate_backward_launches_the_kernel(dev):
    g, x, e = _segment_inputs(dev, 48, 2, seed=3)
    before = ts.STATS.launches
    xg = x.clone().requires_grad_()
    agg, _ = gat_aggregate(xg, e, g)
    g_agg = torch.randn_like(agg)
    (agg * g_agg).sum().backward()
    torch.cuda.synchronize()
    # one forward launch, one backward launch per head
    assert ts.STATS.launches == before + 3
    want = torch.zeros_like(x).cpu().index_add_(
        0, g.col.long().cpu(),
        (e[:, :, None] * g_agg[g.row]).sum(dim=1).cpu()).to(dev)
    torch.testing.assert_close(xg.grad, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("c,h", [(48, 2), (300, 2)])
def test_dropout_gat_on_the_card(dev, c, h):
    """``gat_dropout_aggregate`` (a GAT layer under attention dropout in
    training): output and the gradients of h, s_src and s_dst from the
    weighted segment sum kernel, against the same function on CPU copies
    (the twins); two runs give the same bits; 2 (H + 1) launches a run
    and no twin on the card."""
    g, _, s_src, s_dst = _gat_inputs(dev, c=c, h=h, seed=21)
    rng = torch.Generator(device=dev).manual_seed(5)
    hh = torch.randn(g.n_nodes, h, c, generator=rng, device=dev)
    go = torch.randn(g.n_nodes, h, c, generator=rng, device=dev)
    keep = torch.rand(g.n_edges, h, generator=rng, device=dev) >= 0.3

    def run(graph, device):
        leaves = [t.to(device).clone().requires_grad_()
                  for t in (hh, s_src, s_dst)]
        out = gat_dropout_aggregate(*leaves, keep.to(device), 0.3, graph)
        (out * go.to(device)).sum().backward()
        return [out.detach()] + [t.grad for t in leaves]

    launches, twins = ts.STATS.launches, ts.STATS.twin_calls
    first, second = run(g, dev), run(g, dev)
    torch.cuda.synchronize()
    assert ts.STATS.launches == launches + 2 * 2 * (h + 1)
    assert ts.STATS.twin_calls == twins
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    want = run(DeviceGraph(*(t.cpu() if isinstance(t, torch.Tensor) else t
                             for t in g)), "cpu")
    torch.testing.assert_close(first[0], want[0].to(dev), rtol=1e-5,
                               atol=1e-5)
    for got, w in zip(first[1:], want[1:]):
        torch.testing.assert_close(got, w.to(dev), rtol=1e-4, atol=1e-4)


def _embs(dev, n, d, seed, noise=0.5):
    rng = np.random.default_rng(seed)
    l = rng.normal(size=(n, d)).astype(np.float32)
    r = l + noise * rng.normal(size=(n, d)).astype(np.float32)
    l /= np.linalg.norm(l, axis=1, keepdims=True)
    r /= np.linalg.norm(r, axis=1, keepdims=True)
    return torch.as_tensor(l, device=dev), torch.as_tensor(r, device=dev)


# the last: MCLEA's 300-wide joint at the bench's 10,500 test pairs
@pytest.mark.parametrize("n,d,use_csls,k", [(150, 32, False, 3),
                                             (301, 64, True, 3),
                                             (77, 20, True, 10),
                                             (10500, 300, True, 3)])
def test_rank_kernels_match_twin(dev, n, d, use_csls, k):
    x, y = _embs(dev, n, d, seed=n)
    got = rk.streaming_rank_eval(x, y, k, use_csls, True)
    torch.cuda.synchronize()
    want = rk.eval_core(x, y, k, use_csls, True)
    for a, b in zip(got, want):
        assert (a.long() == b).float().mean().item() >= 0.99


def test_rank_kernel_tie_rules(dev):
    x, y = _embs(dev, 120, 16, seed=11)
    x[9], y[9] = x[5], y[5]      # query 9 == query 5, column 9 == column 5
    for use_csls in (False, True):
        ranks, _, top3 = rk.streaming_rank_eval(x, y, 3, use_csls, True)
        # rows 5 and 9 see the same distances; for query 9 the equal
        # column 5 comes first, so its gold sits one place further back
        assert ranks[9].item() == ranks[5].item() + 1
        row = top3[9].tolist()
        if 9 in row:
            assert 5 in row and row.index(5) < row.index(9)


# the sweeps' tiles (rank_tile.cuh): 96 rows, 256 columns, depth slices of
# 16.  Every n is ragged in rows and columns; d = 19 (d % 4 != 0) and 20,
# 36 (not multiples of 16) end in a partial slice; n = 3,000 takes 4
# splits on the H100, n = 300 two.  Bits must not depend on the splits.
@pytest.mark.parametrize("n,d", [(300, 19), (1000, 20), (600, 300),
                                 (777, 1200), (3000, 36)])
@pytest.mark.parametrize("k", [1, 3, 10])
def test_rank_sweeps_bitwise_across_splits_and_repeats(dev, n, d, k):
    """Every split and every repeat gives the same bits, and a launch's
    column direction gives the bits of the row direction of the launch on
    (y, x)."""
    x, y = _embs(dev, n, d, seed=n + d)
    xn, yn = torch.sum(x * x, dim=1), torch.sum(y * y, dim=1)
    col_tiles = rk.device_plan(dev, n, d, 0, k)["col_tiles"]
    operands = rk.kernel_operands(x, y)
    mean, diag, mean_cols = rk.topk_mean_both_cuda(x, y, xn, yn, k,
                                                   operands=operands)
    torch.cuda.synchronize()
    want = rk.topk_mean_both_twin(x, y, xn, yn, k)
    for got_, want_ in zip((mean, diag, mean_cols), want):
        torch.testing.assert_close(got_, want_, rtol=1e-5, atol=1e-5)
    for splits in (None, 1, col_tiles):
        again = rk.topk_mean_both_cuda(x, y, xn, yn, k, splits=splits)
        assert all(torch.equal(a, b)
                   for a, b in zip(again, (mean, diag, mean_cols)))
    rr, diag_rl = rk.topk_mean_cuda(y, x, yn, xn, k)
    assert torch.equal(mean_cols, rr) and torch.equal(diag_rl, diag)
    assert torch.equal(rk.topk_mean_cuda(x, y, xn, yn, k)[0], mean)
    for rl_, rr_ in ((mean, rr), (None, None)):
        c_l, t_l, c_r = rk.rank_counts_both_cuda(x, y, xn, yn, rl_, rr_, diag,
                                                 True, operands=operands)
        want_r = rk.rank_counts_both_twin(x, y, xn, yn, rl_, rr_, diag,
                                          True)[2]
        agree = (c_r.sum(dim=1) == want_r.sum(dim=1)).float().mean()
        assert agree.item() >= 0.99
        assert torch.equal(c_l, rk.rank_counts_cuda(x, y, xn, yn, rl_, rr_,
                                                    diag, True)[0])
        assert torch.equal(t_l, rk.rank_counts_cuda(x, y, xn, yn, rl_, rr_,
                                                    diag, True)[1])
        assert torch.equal(c_r, rk.rank_counts_cuda(y, x, yn, xn, rr_, rl_,
                                                    diag_rl, False)[0])
    for rl_, rr_ in ((mean, rr), (None, None)):
        for top3 in (True, False):
            counts, t3 = rk.rank_counts_cuda(x, y, xn, yn, rl_, rr_, diag,
                                             top3)
            torch.cuda.synchronize()
            want, want_t3 = rk.rank_counts_twin(x, y, xn, yn, rl_, rr_, diag,
                                                top3)
            agree = (counts.sum(dim=1) == want.sum(dim=1)).float().mean()
            assert agree.item() >= 0.99
            for splits in (None, 1, col_tiles):
                c2, t2 = rk.rank_counts_cuda(x, y, xn, yn, rl_, rr_, diag,
                                             top3, splits=splits)
                assert torch.equal(c2, counts)
                assert (t2 is None) == (not top3)
                if top3:
                    assert torch.equal(t2, t3)
                    assert (t3 == want_t3).all(dim=1).float().mean() >= 0.99


def test_rank_plan_on_the_card(dev):
    """The plan from the card's SM count and the kernels' occupancy: one
    or two blocks per SM, whole column tiles per split, a full last wave
    at the bench shape."""
    for sweep, key in ((0, 1), (0, 3), (0, 10), (1, 0), (1, 3)):
        p = rk.device_plan(dev, 10500, 1200, sweep, key)
        assert p["blocks_per_sm"] >= 1 and p["last_wave"] >= 0.9, p
        assert p["blocks"] == 110 * p["splits"]
    with pytest.raises(ValueError, match="column tiles"):
        rk.device_plan(dev, 300, 8, 0, 3, splits=3)


# ------------------------------------------------------------ bf16 entries

# C = 1,280 is the widest row of 4-element slices, C = 319 the widest of
# single elements; 1,200 and 300 the bench widths of the joint and the GAT
BF16_GAT_WIDTHS = [(48, 2), (30, 1), (300, 2), (64, 4), (1200, 2),
                   (1280, 2), (319, 1)]


@pytest.mark.parametrize("c,h", BF16_GAT_WIDTHS)
def test_gat_bf16_kernels_match_twins(dev, c, h):
    g, x, s_src, s_dst, g_agg, g_rs = _gat_grads_inputs(dev, 300, c, h, c)
    xb, gb16 = x.to(torch.bfloat16), g_agg.to(torch.bfloat16)
    before = (ga.STATS.launches, gb.STATS.launches,
              ga.STATS_BF16.launches, gb.STATS_BF16.launches)
    fwd = ga.gat_attention_cuda(xb, s_src, s_dst, g)
    bwd = gb.gat_backward_cuda(xb, s_src, s_dst, gb16, g_rs, g)
    again = (ga.gat_attention_cuda(xb, s_src, s_dst, g),
             gb.gat_backward_cuda(xb, s_src, s_dst, gb16, g_rs, g))
    torch.cuda.synchronize()
    assert (ga.STATS.launches, gb.STATS.launches, ga.STATS_BF16.launches,
            gb.STATS_BF16.launches) == (before[0], before[1],
                                        before[2] + 2, before[3] + 2)
    assert [t.dtype for t in bwd] == [torch.bfloat16, torch.float32,
                                      torch.float32]
    assert_bf16_close(fwd, on_cpu(ga.gat_attention_twin, xb, s_src, s_dst, g))
    assert_bf16_close(bwd, on_cpu(gb.gat_backward_twin, xb, s_src, s_dst,
                                  gb16, g_rs, g))
    for a, b in zip((*fwd, *bwd), (*again[0], *again[1])):
        assert torch.equal(a, b)


# the bf16 backward's first pass keeps G and the d_x term packed and sums
# each edge's H x G lane partials by one reduce-scatter: C = 30 and
# 301 take one bf16 a slice (1 and 10 groups), 300 four (3 groups)
@pytest.mark.parametrize("c", [30, 300, 301])
@pytest.mark.parametrize("h", [1, 2, 3, 4])
def test_gat_bwd_bf16_matches_twin_across_widths_and_heads(dev, c, h):
    g, x, s_src, s_dst, g_agg, g_rs = _gat_grads_inputs(dev, 300, c, h,
                                                        c + h)
    xb, gb16 = x.to(torch.bfloat16), g_agg.to(torch.bfloat16)
    got = gb.gat_backward_cuda(xb, s_src, s_dst, gb16, g_rs, g)
    again = gb.gat_backward_cuda(xb, s_src, s_dst, gb16, g_rs, g)
    torch.cuda.synchronize()
    assert_bf16_close(got, on_cpu(gb.gat_backward_twin, xb, s_src, s_dst,
                                  gb16, g_rs, g))
    for a, b in zip(got, again):
        assert torch.equal(a, b)


def test_gat_bwd_bf16_hub_row_zero_weights_and_a_lone_self_loop(dev):
    """A hub row of 10^4 edges (313 chunks of 32 on one warp), edges whose
    weight underflows to 0 (as a masked edge's does), and a node whose row
    is its self-loop alone; two runs give the same bits."""
    n, hub, lone = 10_100, 0, 10_099
    rng = np.random.default_rng(7)
    tri = [(hub, 0, t) for t in range(1, 10_001)]
    tri += [(int(rng.integers(1, lone)), 0, int(rng.integers(1, lone)))
            for _ in range(20_000)]
    g = build_graph(n, tri).to_torch(dev)
    deg = (g.row_ptr[1:] - g.row_ptr[:-1]).cpu()
    assert deg[hub] == 10_001 and deg[lone] == 1
    c, h = 300, 2

    def t(*shape):
        return torch.as_tensor(rng.normal(size=shape).astype(np.float32),
                               device=dev)
    x, s_src, s_dst, g_agg, g_rs = (t(n, c), t(n, h), t(n, h), t(n, h, c),
                                    t(n, h))
    s_src[::7] = 1e4              # every edge out of these rows: e = 0
    xb, gb16 = x.to(torch.bfloat16), g_agg.to(torch.bfloat16)
    got = gb.gat_backward_cuda(xb, s_src, s_dst, gb16, g_rs, g)
    again = gb.gat_backward_cuda(xb, s_src, s_dst, gb16, g_rs, g)
    torch.cuda.synchronize()
    assert_bf16_close(got, on_cpu(gb.gat_backward_twin, xb, s_src, s_dst,
                                  gb16, g_rs, g))
    for a, b in zip(got, again):
        assert torch.equal(a, b)


# sha256 of (d_x, d_s_src, d_s_dst) of the f32 backward on
# _gat_grads_inputs(dev, 300, c, h, c), recorded from the kernel before
# the bf16 first pass became a body of its own: the f32 body's bits
F32_BWD_DIGESTS = {
    (300, 2): "8c6e4aab7cad71128139eb5f906e047e38911638250fb784621e7ea4bdb1ef63",
    (30, 1): "1804742868754664d90f954c575dd45b0fd9124ae880e275dcb169ab2f59275e"}


@pytest.mark.parametrize("c,h", sorted(F32_BWD_DIGESTS))
def test_gat_bwd_f32_bits_unchanged(dev, c, h):
    import hashlib
    g, x, s_src, s_dst, g_agg, g_rs = _gat_grads_inputs(dev, 300, c, h, c)
    got = gb.gat_backward_cuda(x, s_src, s_dst, g_agg, g_rs, g)
    torch.cuda.synchronize()
    digest = hashlib.sha256()
    for t in got:
        digest.update(t.cpu().numpy().tobytes())
    assert digest.hexdigest() == F32_BWD_DIGESTS[(c, h)]


def test_gat_bf16_autograd_and_refusals(dev):
    g, x, s_src, s_dst = _gat_inputs(dev, n=301, c=300)
    xs = [x.to(torch.bfloat16).requires_grad_(),
          s_src.clone().requires_grad_(), s_dst.clone().requires_grad_()]
    agg, rs = gat_attention(*xs, g)
    (agg.sum() + rs.sum()).backward()
    torch.cuda.synchronize()
    want = on_cpu(gb.gat_backward_twin, xs[0].detach(), s_src, s_dst,
                  torch.ones_like(agg).to(torch.bfloat16),
                  torch.ones_like(rs), g)
    assert_bf16_close([t.grad for t in xs], want)
    # bf16 scores, or a G whose dtype differs from x's, are refused
    with pytest.raises(TypeError):
        ga.gat_attention_cuda(xs[0].detach(), s_src.to(torch.bfloat16),
                              s_dst, g)
    with pytest.raises(TypeError):
        gb.gat_backward_cuda(xs[0].detach(), s_src, s_dst,
                             torch.ones_like(agg), torch.ones_like(rs), g)
    # a mix of bf16 and f32 operands is refused
    with pytest.raises(TypeError, match="both float32 or both bfloat16"):
        ts.weighted_segment_sum(x.to(torch.bfloat16), g.w[:, None], g)


# the bf16 gradient's tiles (gram_grad_bf16.cuh): 128 rows a block, 64
# columns a tile, 38 n8 feature tiles a chunk (304 features), K slabs of
# 128 features where the rows stream.  2B = 194, 200, 66: neither a multiple
# of the row nor of the column tile, 2B = 128 one row block; d = 304 the
# widest resident run, 296 an odd number of feature tiles, 305 the first
# of two chunks, 1,200 and 1,800 four and eight chunks in a cluster that
# splits K's rows, 2,440 nine chunks that stream their rows; z padded to
# 16-byte rows where d % 8 != 0 (d = 37, 300, 305, 1,204); every case has
# an all-zero row
@pytest.mark.parametrize("m,b,d,n_valid", [(2, 9, 8, 9), (3, 130, 48, 100),
                                           (4, 257, 300, 257),
                                           (1, 70, 1200, 64),
                                           (2, 300, 1800, 290),
                                           (4, 75, 37, 70),
                                           (1, 3500, 1200, 3500),
                                           (2, 97, 304, 97),
                                           (3, 64, 296, 60),
                                           (1, 100, 305, 100),
                                           (2, 33, 1204, 33),
                                           (1, 40, 2440, 40),
                                           (1, 3500, 300, 1000)])
def test_ntxent_bf16_kernels_match_twins(dev, m, b, d, n_valid):
    z, v, coef = _ntxent_inputs(dev, m, b, d, n_valid, seed=b)
    z = z.to(torch.bfloat16)
    coef = coef / n_valid
    lse = nx.streaming_lse_cuda(z, v, 0.1)
    dz = nx.ntxent_grad_cuda(z, lse, coef, v, 0.1)
    again = (nx.streaming_lse_cuda(z, v, 0.1),
             nx.ntxent_grad_cuda(z, lse, coef, v, 0.1))
    torch.cuda.synchronize()
    assert_bf16_close([lse], on_cpu(lambda *a: [nx.streaming_lse_twin(*a)],
                                     z, v, 0.1))
    assert_bf16_close([dz], on_cpu(lambda *a: [nx.ntxent_grad_twin(*a)],
                                   z, lse, coef, v, 0.1))
    assert torch.equal(lse, again[0]) and torch.equal(dz, again[1])


def test_ntxent_bf16_grad_plan(dev):
    """128 rows a block; one chunk with the rows resident up to d = 304;
    past it 2, 4 or 8 balanced chunks of at most 38 feature tiles whose
    blocks form a cluster that splits K's rows, past 8 x 304 features
    chunks that stream their rows; at the IIR shape 220 blocks of one an
    SM, three splits (five full waves on 132 SMs)."""
    bf = torch.bfloat16
    iir = nx.grad_plan(4, 7000, 300, dev, bf)
    assert (iir["chunks"], iir["rows"], iir["resident"], iir["cluster"],
            iir["blocks_per_sm"]) == (1, 128, 1, 1, 1), iir
    if torch.cuda.get_device_properties(dev).multi_processor_count == 132:
        assert iir["splits"] == 3, iir
    # the splits' partials, then z padded to rows of 304 (d % 8 != 0)
    assert iir["scratch"] == (iir["splits"] - 1) * 4 * 7000 * 300 \
        + 4 * 7000 * 304 // 2
    for d, chunks, cluster in ((8, 1, 1), (304, 1, 1), (305, 2, 2),
                               (608, 2, 2), (609, 4, 4), (1200, 4, 4),
                               (1800, 8, 8), (2440, 9, 1)):
        p = nx.grad_plan(2, 7000, d, dev, bf)
        assert (p["chunks"], p["resident"], p["cluster"]) == (
            chunks, int(chunks == 1), cluster), p
        assert p["depth"] >= 2 and p["rows"] == 128


@pytest.mark.parametrize("m,b,d,n_valid", [(1, 9, 8, 9), (4, 130, 48, 100),
                                           (4, 257, 300, 257),
                                           (6, 70, 300, 64), (4, 75, 37, 70),
                                           (6, 100, 300, 100),
                                           (4, 64, 304, 64),
                                           (3, 97, 305, 90),
                                           (1, 500, 1200, 500),
                                           (2, 40, 1800, 40),
                                           (6, 33, 1204, 33)])
def test_mixture_bf16_kernels_match_twins(dev, m, b, d, n_valid):
    z, alpha, beta, v, coef = _mixture_inputs(dev, m, b, d, n_valid, seed=b)
    z = z.to(torch.bfloat16)
    coef = coef / n_valid
    before = (sl.STATS_LSE.launches, sl.STATS_GRAD.launches)
    lse = sl.mixture_lse_cuda(z, alpha, beta, v, 0.1)
    got = sl.mixture_grad_cuda(z, alpha, beta, lse, coef, v, 0.1)
    again = sl.mixture_grad_cuda(z, alpha, beta, lse, coef, v, 0.1)
    torch.cuda.synchronize()
    assert (sl.STATS_LSE.launches, sl.STATS_GRAD.launches) == before
    assert_bf16_close([lse], on_cpu(lambda *a: [sl.mixture_lse_twin(*a)],
                                    z, alpha, beta, v, 0.1))
    assert_bf16_close(got, on_cpu(sl.mixture_grad_twin, z, alpha, beta, lse,
                                  coef, v, 0.1))
    for a, w in zip(got, again):
        assert torch.equal(a, w)


# the bf16 lse kernel (gram_lse_bf16.cuh): persistent blocks over pairs of
# 128-row tiles, 64-feature ring slots, z padded to 16-byte rows where
# d % 8 != 0 (d = 30, 300, 301; 1,200 runs unpadded in 19 slots); n2
# ragged (not a multiple of 128), under one tile, or a multiple (B = 64);
# invalid columns; every case has an all-zero row
BF16_LSE_CASES = [(1, 50, 30, 50), (2, 97, 300, 80), (3, 130, 301, 130),
                  (1, 70, 1200, 64), (4, 3500, 300, 1000), (6, 33, 30, 33),
                  (5, 64, 301, 60), (1, 3500, 1200, 3500)]


@pytest.mark.parametrize("m,b,d,n_valid", BF16_LSE_CASES)
def test_ntxent_lse_bf16_matches_twin(dev, m, b, d, n_valid):
    z, v, _ = _ntxent_inputs(dev, m, b, d, n_valid, seed=b)
    z = z.to(torch.bfloat16)
    lse = nx.streaming_lse_cuda(z, v, 0.1)
    again = nx.streaming_lse_cuda(z, v, 0.1)
    torch.cuda.synchronize()
    assert_bf16_close([lse], on_cpu(lambda *a: [nx.streaming_lse_twin(*a)],
                                    z, v, 0.1))
    assert torch.equal(lse, again)


# the same edge cases for the mixture, M = 1 to 6
@pytest.mark.parametrize("m,b,d,n_valid", [(1, 50, 30, 50), (2, 97, 300, 80),
                                           (3, 130, 301, 130),
                                           (4, 70, 1200, 64),
                                           (4, 3500, 300, 1000),
                                           (6, 33, 30, 33), (5, 64, 301, 60),
                                           (6, 200, 300, 190)])
def test_mixture_lse_bf16_matches_twin(dev, m, b, d, n_valid):
    z, alpha, beta, v, _ = _mixture_inputs(dev, m, b, d, n_valid, seed=b)
    z = z.to(torch.bfloat16)
    lse = sl.mixture_lse_cuda(z, alpha, beta, v, 0.1)
    again = sl.mixture_lse_cuda(z, alpha, beta, v, 0.1)
    torch.cuda.synchronize()
    assert_bf16_close([lse], on_cpu(lambda *a: [sl.mixture_lse_twin(*a)],
                                    z, alpha, beta, v, 0.1))
    assert torch.equal(lse, again)


def test_lse_bf16_plans(dev):
    """128-row tiles, 1,540 pairs at n2 = 7,000; persistent blocks that
    fill the SMs once (NT-Xent two 8-warp blocks an SM over the pairs of
    every batch, the mixture one 16-warp block); 64 features a ring slot;
    scratch: the partials, then z padded to 304-feature rows (d = 300)."""
    bf = torch.bfloat16
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    pad = (4 * 7000 * 304 + 1) // 2
    for plan, channels, warps, per_sm in (
            (nx.lse_plan(4, 7000, 300, dev, bf), 4, 8, 2),
            (sl.lse_plan(4, 7000, 300, dev, bf), 6, 16, 1)):
        assert (plan["tile"], plan["pairs"], plan["slab"], plan["warps"],
                plan["blocks_per_sm"]) == (128, 1540, 64, warps, per_sm), plan
        assert plan["blocks"] == min(sms * per_sm, 1540 * (4 if warps == 8
                                                           else 1)), plan
        part = channels * 55 * 7000
        assert plan["scratch"] == -(-part // 4) * 4 + pad, plan
    # d % 8 == 0: no padded copy; a batch smaller than the SMs' blocks
    small = nx.lse_plan(1, 40, 64, dev, bf)
    assert (small["pairs"], small["blocks"], small["scratch"]) == (1, 1, 40)


# fault C6's seeds (scripts/torch_c6_seeds.py): a positive pair's K whose
# f32 sum sat on a bf16 boundary rounded apart in the kernel (3439), in the
# twin (3449), or in both (3566), before both read the exact dot rounded
# once (snag_loss.positive_k); and a positive pair's W_tot whose f32 value
# sat 8e-6 ulp from a bf16 boundary (3593), before both read it rounded
# once from f64 (snag_loss.positive_w); chip_smoke's M4 inputs at the seed
@pytest.mark.parametrize("seed", [3439, 3449, 3566, 3593])
def test_mixture_bf16_grad_at_c6_seeds(dev, seed):
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke as cs
    z, alpha, beta, v, coef = cs._mixture_inputs(4, 3500, 300, 3500, seed)
    z = z.to(torch.bfloat16)
    lse = sl.mixture_lse_cuda(z, alpha, beta, v, 0.1)
    got = sl.mixture_grad_cuda(z, alpha, beta, lse, coef, v, 0.1)
    torch.cuda.synchronize()
    assert_bf16_close(got, sl.mixture_grad_twin(z, alpha, beta, lse, coef,
                                                v, 0.1))


def test_mixture_bf16_grad_has_no_cap(dev):
    """The fp32 gradient's main-path body holds (modalities per block) x a
    chunk's columns within its shared accumulator's cap, its wide body
    takes what lies past it (test_mixture_grad_takes_any_width); the bf16
    one keeps one modality's dz in registers, in
    feature chunks, so it takes every M and d: past the fp32 cap at M = 1,
    and M = 6 at d = 1,800 in one group.  Its rows stay resident in one
    chunk, as NT-Xent's do (the cluster shares each modality's K)."""
    bf = torch.bfloat16
    p = sl.grad_plan_bf16(4, 7000, 300, dev)
    assert (p["chunks"], p["rows"], p["resident"], p["cluster"]) == (
        1, 128, 1, 4), p
    assert sl.grad_plan_bf16(6, 7000, 1800, dev)["chunks"] == 6
    cap = sl._grad_cap(sl._library(), dev)
    d = cap + 8
    assert sl.grad_plan_bf16(1, 40, d, dev)["chunks"] == -(-d // 304)
    z, alpha, beta, v, coef = _mixture_inputs(dev, 1, 20, d, 20, seed=3)
    z = z.to(bf)
    coef = coef / 20
    lse = sl.mixture_lse_cuda(z, alpha, beta, v, 0.1)
    got = sl.mixture_grad_cuda(z, alpha, beta, lse, coef, v, 0.1)
    torch.cuda.synchronize()
    assert_bf16_close(got, on_cpu(sl.mixture_grad_twin, z, alpha, beta, lse,
                                  coef, v, 0.1))
    # the f32 kernel at the same width, on its wide body (B = 500, as in
    # test_mixture_grad_takes_any_width; the main-path body took 2 chunks)
    assert _mixture_grad_against_twin(dev, 1, 500, d)["wide"] == 1


# ------------------------------------------- any head count, width and k

# past the warp's 4 heads and MAX_GROUPS slices a lane: the wide kernels
# (gat_attention.wide): H = 6 at C = 1,300 (float4 slices, past 1,280) and
# 330 (single floats, past 320; the backward's 8-byte slices), H = 8 at a
# narrow C, H = 5 at C = 30, H = 2 at C = 1,284 and C = 2,600 (three and
# five column chunks of the forward; four and seven warps a row of the
# backward), H = 8 at C = 300 (``--heads 8,8``: one warp a row, two head
# groups), H = 2 at C = 330 (8-byte slices, two warps a row) and H = 3 at
# C = 1,601 (single floats past 16 warps' columns: two passes)
GAT_WIDE = [(6, 1300), (6, 330), (8, 64), (5, 30), (2, 1284), (2, 2600),
            (8, 300), (2, 330), (3, 1601)]


@pytest.mark.parametrize("h,c", GAT_WIDE)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gat_wide_kernels_match_twins(dev, h, c, dtype):
    g, x, s_src, s_dst, g_agg, g_rs = _gat_grads_inputs(dev, 300, c, h, c + h)
    x, g_agg = x.to(dtype), g_agg.to(dtype)
    assert ga.wide(c, h, ga.slice_width(c, x, g_agg))
    vec, is_wide = gb.backward_slice_width(c, h, x, g_agg)
    assert is_wide and vec == (4 if c % 4 == 0 else 2 if c % 2 == 0 else 1)
    fwd = ga.gat_attention_cuda(x, s_src, s_dst, g)
    bwd = gb.gat_backward_cuda(x, s_src, s_dst, g_agg, g_rs, g)
    again = (ga.gat_attention_cuda(x, s_src, s_dst, g),
             gb.gat_backward_cuda(x, s_src, s_dst, g_agg, g_rs, g))
    torch.cuda.synchronize()
    want_fwd = on_cpu(ga.gat_attention_twin, x, s_src, s_dst, g)
    want_bwd = on_cpu(gb.gat_backward_twin, x, s_src, s_dst, g_agg, g_rs, g)
    if dtype == torch.bfloat16:
        assert_bf16_close(fwd, want_fwd)
        assert_bf16_close(bwd, want_bwd)
    else:
        for a, b in zip(fwd, want_fwd):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
        for a, b in zip(bwd, want_bwd):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    for a, b in zip((*fwd, *bwd), (*again[0], *again[1])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gat_wide_kernels_give_the_narrow_kernels_bits(dev, dtype):
    """Each output element of the wide path is the arithmetic of the main
    path's kernels: the forward at H = 8, C = 1,300 equals the narrow
    forward on heads 0-3 and 4-7 and on columns :1,280 and 1,280:; the
    backward's d_s_src and d_s_dst at H = 8 equal the narrow backward's on
    each half of the heads, and its d_x at H = 2, C = 1,300 the narrow
    one's on columns :1,280."""
    g, x, s_src, s_dst, g_agg, g_rs = _gat_grads_inputs(dev, 300, 1300, 8, 5)
    x, g_agg = x.to(dtype), g_agg.to(dtype)
    agg, rs = ga.gat_attention_cuda(x, s_src, s_dst, g)
    for heads in (slice(0, 4), slice(4, 8)):
        for cols in (slice(0, 1280), slice(1280, 1300)):
            n_agg, n_rs = ga.gat_attention_cuda(
                x[:, cols].contiguous(), s_src[:, heads].contiguous(),
                s_dst[:, heads].contiguous(), g)
            assert torch.equal(agg[:, heads, cols], n_agg)
            assert torch.equal(rs[:, heads], n_rs)
    xs, gs = x[:, :300].contiguous(), g_agg[:, :, :300].contiguous()
    _, d_src, d_dst = gb.gat_backward_cuda(xs, s_src, s_dst, gs, g_rs, g)
    for heads in (slice(0, 4), slice(4, 8)):
        _, n_src, n_dst = gb.gat_backward_cuda(
            xs, s_src[:, heads].contiguous(), s_dst[:, heads].contiguous(),
            gs[:, heads].contiguous(), g_rs[:, heads].contiguous(), g)
        assert torch.equal(d_src[:, heads], n_src)
        assert torch.equal(d_dst[:, heads], n_dst)
    two = slice(0, 2)
    args = (s_src[:, two].contiguous(), s_dst[:, two].contiguous())
    d_x = gb.gat_backward_cuda(x, *args, g_agg[:, two].contiguous(),
                               g_rs[:, two].contiguous(), g)[0]
    n_dx = gb.gat_backward_cuda(x[:, :1280].contiguous(), *args,
                                g_agg[:, two, :1280].contiguous(),
                                g_rs[:, two].contiguous(), g)[0]
    torch.cuda.synchronize()
    assert torch.equal(d_x[:, :1280], n_dx)


# n = 300 and 1,000 at each list's edges, then one row tile or less (n <
# 96), k = n (every column in each row's list) and k just past a list
LONG_LIST_CASES = ([(n, d, k) for n, d in [(300, 19), (1000, 36)]
                    for k in [11, 20, 32, 33, 64, 128]]
                   + [(11, 24, 11), (40, 24, 20), (95, 24, 33), (95, 24, 95),
                      (96, 24, 64), (128, 24, 128), (200, 24, 128)])


@pytest.mark.parametrize("n,d,k", LONG_LIST_CASES)
def test_rank_sweep_a_long_lists(dev, n, d, k):
    """Sweep A at k above 10 (lists of 32 and 128 in shared memory, both
    directions from one pass) against its plain version (rtol = atol =
    1e-5), the same bits for every split and repeat, its column means the
    bits of the row means on (y, x); then the whole evaluation against the
    dense twin (ranks on >= 99 % of queries)."""
    x, y = _embs(dev, n, d, seed=n + k)
    xn, yn = torch.sum(x * x, dim=1), torch.sum(y * y, dim=1)
    got = rk.topk_mean_both_cuda(x, y, xn, yn, k)
    torch.cuda.synchronize()
    for a, b in zip(got, rk.topk_mean_both_twin(x, y, xn, yn, k)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    col_tiles = rk.device_plan(dev, n, d, 0, k)["col_tiles"]
    for splits in (None, None, 1, col_tiles):
        again = rk.topk_mean_both_cuda(x, y, xn, yn, k, splits=splits)
        assert all(torch.equal(a, b) for a, b in zip(again, got))
    rr, diag_rl = rk.topk_mean_cuda(y, x, yn, xn, k)
    assert torch.equal(got[2], rr) and torch.equal(got[1], diag_rl)
    ranks = rk.streaming_rank_eval(x, y, k, True, True)
    torch.cuda.synchronize()
    want = rk.eval_core(x, y, k, True, True)
    for a, b in zip(ranks, want):
        assert (a.long() == b).float().mean().item() >= 0.99


def test_rank_sweep_a_refuses_k_above_128(dev):
    x, y = _embs(dev, 300, 16, seed=1)
    xn, yn = torch.sum(x * x, dim=1), torch.sum(y * y, dim=1)
    with pytest.raises(ValueError, match="1..128"):
        rk.topk_mean_both_cuda(x, y, xn, yn, 129)
    for k in (32, 128):
        p = rk.device_plan(dev, 10500, 1200, 0, k)
        assert p["blocks_per_sm"] >= 1 and p["smem_bytes"] > 93184, p
