"""The bf16 gradient kernels' order of adds (``csrc/gram_grad_bf16.cuh``,
the kernel of ``ntxent_grad_bf16`` and ``mixture_grad_bf16``), emulated on
the CPU and held against f64 products of the same bf16 operands.

K = z z^T: one k16 slice at a time, each an m16n8k16 product from zero
whose 16-term sum the tensor cores truncate to f32, the slices added in f32
in increasing k.  The order is the same whether a block's rows stay
resident or stream in K slabs (a slab is a run of slices).

W z: per column tile of ``WZ_COLS`` = 64, the tile's four k16 slices in one
accumulator from zero (truncating at every slice), the tile's sum added in
f32 to the warp's registers, tiles in increasing column order.  A launch
with S column splits gives split s the tiles [n_ct s / S, n_ct (s + 1) / S);
split 0 writes dz, the others partials that a second kernel adds in split
order (``add_partials``: dz + part_1 + ... + part_{S-1}).  The mixture's
W_tot z runs the same schedule.

Each is held within 1e-5 x max |f64| at the shapes of
``tests/test_torch_bf16.py::test_bf16_mma_schedule_is_far_inside_the_card_limit``
and at a 2,000-column batch, for every split count the plan can choose
(1-4, at most one per column tile): 400x inside the card's 4e-3 x max
limit, so that the card check measures the kernels' rounding points, not
their accumulation.
"""

import numpy as np
import pytest
import torch

from snag_tpu_torch.ops.cuda import ntxent as tnx

TAU = 0.1
SHAPES = [(4, 48, 300), (6, 40, 64), (2, 100, 1800), (1, 1000, 300)]
# (M, B, d, column splits): grad16::plan takes 1-4 splits, at most one per
# column tile
CASES = [(m, b, d, s) for m, b, d in SHAPES for s in (1, 2, 3, 4)
         if s <= -(-2 * b // tnx.WZ_COLS)]


def _round_to_zero_f32(x64):
    """f64 values to f32 rounded toward zero: the tensor cores truncate
    when they accumulate a product's terms."""
    r = x64.astype(np.float32)
    over = np.abs(r.astype(np.float64)) > np.abs(x64)
    return np.where(over, np.nextafter(r, np.float32(0)), r)


def _round_bf16(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
        torch.bfloat16).to(torch.float32).numpy()


def k_schedule(z):
    """K (M, n2, n2) of bf16 values z (M, n2, d), the kernel's way."""
    ks = tnx.KSLICE
    zt = z.transpose(0, 2, 1)
    out = np.zeros((z.shape[0], z.shape[1], z.shape[1]), np.float32)
    for k0 in range(0, z.shape[2], ks):
        part = np.matmul(z[:, :, k0:k0 + ks].astype(np.float64),
                         zt[:, k0:k0 + ks, :].astype(np.float64))
        out = (out + _round_to_zero_f32(part)).astype(np.float32)
    return out


def wz_schedule(w, z, splits):
    """W z (M, n2, d) of bf16 values, the kernel's way with ``splits``
    column splits."""
    cols, ks = tnx.WZ_COLS, tnx.KSLICE
    n2 = z.shape[1]
    n_ct = -(-n2 // cols)
    dz = None
    for s in range(splits):
        acc = np.zeros((w.shape[0], w.shape[1], z.shape[2]), np.float32)
        for ct in range(n_ct * s // splits, n_ct * (s + 1) // splits):
            part = np.zeros(acc.shape, np.float32)
            for k0 in range(ct * cols, min((ct + 1) * cols, n2), ks):
                part = _round_to_zero_f32(
                    part.astype(np.float64)
                    + np.matmul(w[:, :, k0:k0 + ks].astype(np.float64),
                                z[:, k0:k0 + ks, :].astype(np.float64)))
            acc = (acc + part).astype(np.float32)
        dz = acc if dz is None else (dz + acc).astype(np.float32)
    return dz


def _inputs(m, b, d):
    """bf16 unit rows with near-copy positives and an all-zero row, and the
    NT-Xent weight W rounded to bf16 as the kernel rounds it, from f64 S."""
    rng = np.random.default_rng(m * b + d)
    z = rng.normal(size=(m, 2 * b, d)).astype(np.float32)
    z[:, b:] = z[:, :b] + 0.5 * z[:, b:]
    z = _round_bf16(z / np.linalg.norm(z, axis=-1, keepdims=True))
    z[min(1, m - 1), 5] = 0.0
    n2 = 2 * b
    v = np.concatenate([np.arange(b) < b - 3] * 2).astype(np.float32)
    coef = (rng.uniform(0.1, 1.0, size=(m, n2)) * v / b).astype(np.float32)
    lse = tnx.streaming_lse_twin(torch.from_numpy(z).to(torch.bfloat16),
                                 torch.from_numpy(v), TAU)
    lse = lse.numpy().astype(np.float64)
    s = np.matmul(z.astype(np.float64),
                  z.transpose(0, 2, 1).astype(np.float64)) / TAU
    rows = np.arange(n2)
    pos = np.where(rows < b, rows + b, rows - b)
    p_row = np.exp(np.minimum(s - lse[:, :, None], 0.0))
    p_col = np.exp(np.minimum(s - lse[:, None, :], 0.0))
    w = ((rows[:, None] != rows[None, :])[None]
         * (coef[:, :, None] * p_row * v[None, None, :]
            + p_col * coef[:, None, :] * v[None, :, None])
         - (rows[None, :] == pos[:, None])[None]
         * (coef[:, :, None] + coef[:, None, :])) / TAU
    return z, _round_bf16(w)


@pytest.mark.parametrize("m,b,d", SHAPES)
def test_k_schedule_is_far_inside_the_card_limit(m, b, d):
    z, _ = _inputs(m, b, d)
    k64 = np.matmul(z.astype(np.float64), z.transpose(0, 2, 1).astype(
        np.float64))
    assert np.abs(k_schedule(z) - k64).max() <= 1e-5 * np.abs(k64).max()


@pytest.mark.parametrize("m,b,d,splits", CASES)
def test_wz_schedule_is_far_inside_the_card_limit(m, b, d, splits):
    z, wb = _inputs(m, b, d)
    p64 = np.matmul(wb.astype(np.float64), z.astype(np.float64))
    got = wz_schedule(wb, z, splits)
    assert np.abs(got - p64).max() <= 1e-5 * np.abs(p64).max()


def test_one_split_is_the_column_tile_schedule():
    """With one split the schedule is test_torch_bf16.py's ``mm_wz``: the
    64-column, four-k16 run and nothing else."""
    z, wb = _inputs(2, 100, 64)
    cols, ks = tnx.WZ_COLS, tnx.KSLICE
    want = np.zeros((2, 200, 64), np.float32)
    for c0 in range(0, 200, cols):
        part = np.zeros(want.shape, np.float32)
        for k0 in range(c0, min(c0 + cols, 200), ks):
            part = _round_to_zero_f32(part.astype(np.float64) + np.matmul(
                wb[:, :, k0:k0 + ks].astype(np.float64),
                z[:, k0:k0 + ks].astype(np.float64)))
        want = (want + part).astype(np.float32)
    assert np.array_equal(wz_schedule(wb, z, 1), want)
