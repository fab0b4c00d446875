"""The f32 loss gradients' wide body (``csrc/gram_grad.cuh``
``gram_grad_wide``), its order of sums emulated on the CPU.

Past what the main-path body's accumulator holds (d > 1,504 at one
modality a block on the H100, NT-Xent and the mixture alike) a row tile's
blocks form a thread-block cluster of cm x q blocks: each
computes its own modality's K partial over one of q depth slices of d,
each k8 step of 3xTF32 products from zero and added in fp32; K is the sum
of the q partials in rank order; the weights W (and the mixtures, W_tot,
dalpha's and dbeta's terms) follow from that K in fp32; W z runs a column
tile at a time, its eight k8 steps in one chain, the tile's sum added to
the accumulator in column order, and column splits' partials added in
split order.  dalpha: each of a row's 64 column lanes sums its terms over
the split's tiles (fmaf), then a warp's butterfly over 32 lanes, then the
two warps in order; dbeta: each thread over its elements, a butterfly,
the warps in order, then the blocks' partials in the reduce kernel's
tree.  This file emulates that order with ``rna_tf32``
(``test_torch_tf32x3.py``) at small shapes (M = 1, 2 and 4; d of several
depth slices and a ragged last one; a padded batch; ragged row blocks and
column tiles; two column splits) and holds it against an f64 evaluation
and against the twins within the card's limit, max |err| <= 1e-4 x max
|ref| for dz, dalpha and dbeta.  It also checks that the main path's
shapes keep the main-path body (``snag_loss.modality_group``), whose K
order the wide schedule gives with one depth slice.  The wide body's plan
is the library's (``csrc/gram_grad.cuh`` ``wide_plan``), checked on the
card in ``test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from snag_tpu_torch.ops.cuda import ntxent as tnx
from snag_tpu_torch.ops.cuda import snag_loss as tsl
from test_torch_tf32x3 import rna_tf32
from torch_port_common import single_thread

single_thread()
LIMIT = 1e-4
TAU = 0.1
# csrc/gram_grad.cuh: K steps of KD features, column tiles of COLS, row
# blocks of ROWS
KD, COLS, ROWS = 32, 64, 32
F32 = torch.float32


def mm3(a, b):
    """a b in 3xTF32 with fp32 sums, the small terms first."""
    a_hi, b_hi = rna_tf32(a), rna_tf32(b)
    a_lo, b_lo = rna_tf32(a - a_hi), rna_tf32(b - b_hi)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def fma(a, b, c):
    """fmaf: one rounding of a b + c (f64 holds the product exactly)."""
    return (a.double() * b.double() + c.double()).to(F32)


def k_wide(z, q):
    """K = z z^T (M, n2, n2) as the wide body adds it: depth slice r of q
    covers K steps [ks r / q, ks (r + 1) / q) of KD features, each k8 step
    from zero and added in fp32; the q partials added in rank order."""
    d = z.shape[2]
    ks = -(-d // KD)
    zp = torch.nn.functional.pad(z, (0, 8 * -(-d // 8) - d))
    parts = []
    for r in range(q):
        acc = torch.zeros(z.shape[0], z.shape[1], z.shape[1], dtype=F32)
        for f in range(KD * (ks * r // q), min(KD * (ks * (r + 1) // q), d),
                       8):
            zs = zp[:, :, f:f + 8]
            acc = acc + mm3(zs, zs.transpose(1, 2))
        parts.append(acc)
    k = parts[0]
    for p in parts[1:]:
        k = k + p
    return k


def w_channel(k, lse, coef, v, inv_tau):
    """The kernels' ``w_channel`` on a channel's K (n2, n2), fp32."""
    n2 = k.shape[0]
    rows = torch.arange(n2)
    pos = torch.where(rows < n2 // 2, rows + n2 // 2, rows - n2 // 2)
    neq = rows[:, None] != rows[None, :]
    oh = rows[None, :] == pos[:, None]
    s = k * inv_tau
    p_row = torch.exp(torch.clamp(s - lse[:, None], max=0.0))
    p_col = torch.exp(torch.clamp(s - lse[None, :], max=0.0))
    c_r, c_c = coef[:, None], coef[None, :]
    w = torch.where(neq, c_r * p_row * v[None, :] + p_col * c_c * v[:, None],
                    torch.zeros((), dtype=F32))
    w = torch.where(oh, w - (c_r + c_c), w)
    return w * inv_tau


def split_tiles(n2, splits):
    """Each column split's tiles of COLS, in order."""
    n_ct = -(-n2 // COLS)
    return [range(n_ct * s // splits, n_ct * (s + 1) // splits)
            for s in range(splits)]


def wz(w, zm, splits):
    """W z as the wide body adds it: a tile's eight k8 steps in one chain,
    the tile's sums into the accumulator in column order, the splits'
    partials in split order."""
    outs = []
    for tiles in split_tiles(w.shape[0], splits):
        acc = torch.zeros(w.shape[0], zm.shape[1], dtype=F32)
        for ct in tiles:
            part = torch.zeros_like(acc)
            for c in range(COLS * ct, min(COLS * (ct + 1), w.shape[0]), 8):
                part = part + mm3(w[:, c:c + 8], zm[c:c + 8])
            acc = acc + part
        outs.append(acc)
    dz = outs[0]
    for o in outs[1:]:
        dz = dz + o
    return dz


def butterfly(x):
    """A warp's ``__shfl_xor_sync`` sum over its last axis of 32 lanes, as
    lane 0 holds it."""
    for o in (16, 8, 4, 2, 1):
        x = x + x[..., torch.arange(32) ^ o]
    return x[..., 0]


def tree(x):
    """The dbeta kernel's sum of its blocks' partials: thread i adds blocks
    i, i + 256, ... in order, then halving strides."""
    red = torch.zeros(256, dtype=F32)
    for b0 in range(0, x.shape[0], 256):
        part = x[b0:b0 + 256]
        red[:part.shape[0]] = red[:part.shape[0]] + part
    off = 128
    while off:
        red[:off] = red[:off] + red[off:2 * off]
        off //= 2
    return red[0]


def ntxent_wide(z, lse, coef, v, tau, q, splits=2):
    inv_tau = torch.tensor(1.0 / tau, dtype=F32)
    k = k_wide(z, q)
    return torch.stack([wz(w_channel(k[i], lse[i], coef[i], v, inv_tau),
                           z[i], splits) for i in range(z.shape[0])])


def mixture_wide(z, alpha, beta, lse, coef, v, tau, q, splits=2):
    """dz, dalpha and dbeta of the mixture's wide body: a cluster of m x q
    blocks, block (i, r) at rank i q + r owning the weights of rows
    [ceil(32 s / S), ceil(32 (s + 1) / S)) of each row tile."""
    m, n2, _ = z.shape
    inv_tau = torch.tensor(1.0 / tau, dtype=F32)
    k = k_wide(z, q)
    zero = torch.zeros(n2, n2, dtype=F32)
    mix_a, mix_f = zero, zero
    aa = [alpha[:, i][:, None] * alpha[:, i][None, :] for i in range(m)]
    for i in range(m):                      # in increasing m, by fmaf
        mix_a = fma(aa[i], k[i], mix_a)
        mix_f = fma(beta[i].expand(n2, n2), k[i], mix_f)
    w_a = w_channel(mix_a, lse[m], coef[m], v, inv_tau)
    w_f = w_channel(mix_f, lse[m + 1], coef[m + 1], v, inv_tau)
    dz = []
    for i in range(m):
        w_tot = w_channel(k[i], lse[i], coef[i], v, inv_tau) \
            + (w_a * aa[i] + w_f * beta[i])
        dz.append(wz(w_tot, z[i], splits))
    # dalpha: a row's column lanes over their split's tiles, then two
    # butterflies, then the splits in order
    dalpha = []
    for tiles in split_tiles(n2, splits):
        lanes = torch.zeros(m, n2, COLS, dtype=F32)
        for ct in tiles:
            c = torch.arange(COLS * ct, COLS * (ct + 1))
            ok = c < n2
            cc = c.clamp(max=n2 - 1)
            for i in range(m):
                term = torch.where(ok, w_a[:, cc] * k[i][:, cc],
                                   torch.zeros((), dtype=F32))
                lanes[i] = fma(term, torch.where(ok, alpha[cc, i], 0.0)
                               .expand(n2, COLS), lanes[i])
        dalpha.append((butterfly(lanes[..., :32]) + butterfly(lanes[..., 32:]))
                      .T)
    da = dalpha[0]
    for p in dalpha[1:]:
        da = da + p
    # dbeta: each block's threads over (tile, element), a butterfly, the
    # warps in order; the blocks (split, row block, rank) in the tree
    S = m * q
    partials = [[] for _ in range(m)]
    for tiles in split_tiles(n2, splits):
        for row0 in range(0, n2, ROWS):
            for s in range(S):
                r_lo = (ROWS * s + S - 1) // S
                r_hi = (ROWS * (s + 1) + S - 1) // S
                thr = torch.zeros(m, 256, dtype=F32)
                n_el = (r_hi - r_lo) * COLS
                for ct in tiles:
                    for e0 in range(0, n_el, 256):
                        e = torch.arange(e0, min(e0 + 256, n_el))
                        r = row0 + r_lo + e // COLS
                        c = COLS * ct + e % COLS
                        ok = (r < n2) & (c < n2)
                        rr, cc = r.clamp(max=n2 - 1), c.clamp(max=n2 - 1)
                        for i in range(m):
                            t = torch.where(ok, w_f[rr, cc],
                                            torch.zeros((), dtype=F32))
                            kv = torch.where(ok, k[i][rr, cc],
                                             torch.zeros((), dtype=F32))
                            thr[i, e - e0] = fma(t, kv, thr[i, e - e0])
                warps = butterfly(thr.reshape(m, 8, 32))
                for i in range(m):
                    acc = warps[i, 0]
                    for wv in warps[i, 1:]:
                        acc = acc + wv
                    partials[i].append(acc)
    dbeta = torch.stack([0.5 * tree(torch.stack(p)) for p in partials])
    return torch.stack(dz), da, dbeta


def _ntxent_inputs(m, b, d, n_valid, seed):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(m, 2 * b, d)).astype(np.float32)
    z[:, b:] = z[:, :b] + 0.5 * z[:, b:]
    z /= np.linalg.norm(z, axis=-1, keepdims=True)
    v = np.concatenate([np.arange(b) < n_valid] * 2).astype(np.float32)
    coef = rng.uniform(0.1, 1.0, size=(m, 2 * b)).astype(np.float32) * v
    coef /= max(n_valid, 1)
    return [torch.from_numpy(a) for a in (z, v, coef)]


def _mixture_inputs(m, b, d, n_valid, seed):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(m, 2 * b, d)).astype(np.float32)
    z[:, b:] = z[:, :b] + 0.5 * z[:, b:]
    z /= np.linalg.norm(z, axis=-1, keepdims=True)
    z[min(1, m - 1), 5] = 0.0                       # an all-zero row
    alpha = np.abs(rng.normal(size=(2 * b, m))).astype(np.float32)
    alpha /= np.linalg.norm(alpha, axis=1, keepdims=True)
    u = rng.uniform(0.2, 1.0, size=m).astype(np.float32)
    beta = u * u / np.sum(u * u)
    v = np.concatenate([np.arange(b) < n_valid] * 2).astype(np.float32)
    coef = rng.uniform(0.1, 1.0, size=(m + 2, 2 * b)).astype(np.float32) * v
    coef /= max(n_valid, 1)
    return [torch.from_numpy(a) for a in (z, alpha, beta, v, coef)]


def _within(got, want):
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        err = (g.double() - w.double()).abs().max().item()
        assert err <= LIMIT * w.abs().max().item(), (err, w.abs().max())


# (M, B, d, valid pairs, depth slices): d = 100 in 2 and 3 slices (4 K
# steps of 32: the last slice ragged, 4 features past d), d = 200 in 4 and
# 5 (7 steps), d = 150 in 4 (slices of 1, 1, 2 and 1 steps, 2 features
# past d), d = 64 in 2 whole steps;
# B = 200: row blocks of 32 and a last one of 16, column tiles of 64 and a
# last one of 16.  At B = 40 the f32 twin itself misses the limit against
# f64 (3.4e-7 of 2.0e-7 at M = 1, d = 100), so no f32 order could be held
# to it there.
@pytest.mark.parametrize("m,b,d,n_valid,q", [(1, 200, 100, 200, 2),
                                             (1, 200, 100, 151, 3),
                                             (2, 200, 200, 200, 4),
                                             (4, 200, 100, 175, 3),
                                             (1, 200, 150, 200, 4),
                                             (2, 200, 100, 120, 2),
                                             (1, 200, 64, 200, 2),
                                             (4, 200, 200, 200, 5)])
def test_ntxent_wide_schedule_within_the_limit(m, b, d, n_valid, q):
    z, v, coef = _ntxent_inputs(m, b, d, n_valid, seed=d + q)
    lse64 = tnx.streaming_lse_twin(z.double(), v.double(), TAU)
    ref = tnx.ntxent_grad_twin(z.double(), lse64, coef.double(), v.double(),
                               TAU)
    lse = lse64.to(F32)
    got = ntxent_wide(z, lse, coef, v, TAU, q)
    _within([got], [ref])
    _within([got], [tnx.ntxent_grad_twin(z, lse, coef, v, TAU)])


# B = 200 as above; at M = 1 dalpha is also a difference of terms ~50x
# its size, which a small batch puts past the limit even with exact fp32
# products (test_torch_cuda.py::test_mixture_kernels_match_twins).  M = 6,
# the most modalities, in clusters of 12; M = 3 of 9
@pytest.mark.parametrize("m,b,d,n_valid,q", [(1, 200, 100, 200, 2),
                                             (2, 200, 100, 200, 3),
                                             (4, 200, 200, 165, 4),
                                             (4, 200, 100, 200, 2),
                                             (6, 200, 100, 200, 2),
                                             (3, 200, 100, 190, 3),
                                             (1, 200, 150, 160, 4)])
def test_mixture_wide_schedule_within_the_limit(m, b, d, n_valid, q):
    z, alpha, beta, v, coef = _mixture_inputs(m, b, d, n_valid, seed=d + q)
    f64 = [t.double() for t in (z, alpha, beta, v)]
    lse64 = tsl.mixture_lse_twin(*f64, TAU)
    ref = tsl.mixture_grad_twin(f64[0], f64[1], f64[2], lse64,
                                coef.double(), f64[3], TAU)
    lse = lse64.to(F32)
    got = mixture_wide(z, alpha, beta, lse, coef, v, TAU, q)
    _within(got, ref)
    _within(got, tsl.mixture_grad_twin(z, alpha, beta, lse, coef, v, TAU))


def test_one_depth_slice_is_the_parents_k():
    """With one depth slice the wide body's K is the main-path body's:
    every k8 step from zero, added in fp32 in feature order; more slices
    move K by rounding only."""
    z, _, _ = _ntxent_inputs(2, 40, 100, 40, seed=1)
    zp = torch.nn.functional.pad(z, (0, 4))
    parent = torch.zeros(2, 80, 80)
    for f in range(0, 100, 8):
        parent = parent + mm3(zp[:, :, f:f + 8],
                              zp[:, :, f:f + 8].transpose(1, 2))
    assert torch.equal(k_wide(z, 1), parent)
    assert (k_wide(z, 3) - parent).abs().max().item() <= 1e-6


def test_the_main_path_keeps_the_parents_body():
    """The gradients leave the main-path body only past one modality's fit
    in its accumulator (1,504 columns on the H100): IIR, ECIA, an MCLEA
    modality and MEAformer's joint loss (NT-Xent, one modality a block, d
    = 300 and 1,200) and the mixture's M = 4 and 6 at d = 300 fit."""
    assert tsl.modality_group(1, 300, 1504) == (1, False)
    assert tsl.modality_group(1, 1200, 1504) == (1, False)
    assert tsl.modality_group(4, 300, 1504) == (4, False)
    assert tsl.modality_group(6, 300, 1504) == (3, False)
    assert tsl.modality_group(1, 1504, 1504) == (1, False)
    assert tsl.modality_group(1, 1512, 1504) == (1, True)
    assert tsl.modality_group(4, 1600, 1504) == (1, True)
