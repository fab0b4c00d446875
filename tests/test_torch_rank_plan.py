"""The rank sweeps' launch plan and the plain model of their column splits.

``rank_plan`` is the port's own arithmetic (no card needed): block tile,
column splits, blocks and waves.  ``topk_mean_split`` / ``rank_counts_split``
model what the CUDA sweeps compute per split and how the merge kernels
combine the splits; here they must give EXACTLY the outputs of the dense
twins and the ranks and top-3 of the Pallas sweeps in interpret mode, for
any number of splits, with exact ties that fall on both sides of a split
boundary.  The model runs with 16-column tiles so that a small N has
many splits; the kernels' tile width does not enter the model's values.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import snag_tpu.ops.pallas.rank_eval as prk
from snag_tpu_torch.ops.cuda import rank_eval as trk
from torch_port_common import single_thread

single_thread()

H100_SMS = 132
TILE = 16           # the model's column tile
N = 120             # 8 model tiles


def _embs(n, d, seed):
    rng = np.random.default_rng(seed)
    l = rng.normal(size=(n, d)).astype(np.float32)
    r = l + 0.3 * rng.normal(size=(n, d)).astype(np.float32)
    l /= np.linalg.norm(l, axis=1, keepdims=True)
    r /= np.linalg.norm(r, axis=1, keepdims=True)
    return l, r


def _tied_embs(n=N, d=16, seed=11):
    """Duplicated rows on both sides.  With 16-column tiles, column pairs
    (9, 40), (3, 17) and (12, 77) are equal across split boundaries, and
    (5, 9), (60, 61) inside one split."""
    l, r = _embs(n, d, seed)
    for a, b in ((5, 9), (9, 40), (17, 3), (60, 61)):
        r[b] = r[a]
        l[b] = l[a]
    r[77] = r[12]
    return l, r


def _inputs(tied):
    l, r = _tied_embs() if tied else _embs(N, 24, seed=4)
    x, y = torch.from_numpy(l), torch.from_numpy(r)
    return l, r, x, y, torch.sum(x * x, dim=1), torch.sum(y * y, dim=1)


# ------------------------------------------------------------------ plan

@pytest.mark.parametrize("blocks_per_sm,splits,waves", [(1, 6, 5),
                                                         (2, 7, 3)])
def test_plan_at_the_bench_shape(blocks_per_sm, splits, waves):
    """10,500 rows: 110 row tiles of 96 and 42 column tiles of 256; at one
    block per SM, 6 splits of 7 tiles make 5 whole waves (660 blocks on
    132 slots)."""
    p = trk.rank_plan(10500, 1200, H100_SMS, blocks_per_sm)
    assert (p["tile_rows"], p["tile_cols"]) == (96, 256)
    assert (p["row_tiles"], p["col_tiles"]) == (110, 42)
    assert p["splits"] == splits
    assert p["blocks"] == 110 * splits and p["waves"] == waves
    assert p["last_wave"] >= 0.9
    assert p["executed_flops"] == 2 * (110 * 96) * (42 * 256) * 1200


@pytest.mark.parametrize("n", [3000, 7000, 15000])
@pytest.mark.parametrize("blocks_per_sm", [1, 2])
def test_plan_fills_the_last_wave(n, blocks_per_sm):
    p = trk.rank_plan(n, 300, H100_SMS, blocks_per_sm)
    assert p["last_wave"] >= 0.9, p
    assert p["blocks"] == p["row_tiles"] * p["splits"]
    assert 1 <= p["splits"] <= p["col_tiles"]
    slots = H100_SMS * blocks_per_sm
    assert (p["waves"] - 1) * slots < p["blocks"] <= p["waves"] * slots


@pytest.mark.parametrize("n,row_tiles,col_tiles", [(1, 1, 1), (95, 1, 1),
                                                   (96, 1, 1), (97, 2, 1),
                                                   (257, 3, 2), (301, 4, 2),
                                                   (1000, 11, 4)])
def test_plan_ragged_and_one_wave(n, row_tiles, col_tiles):
    """A grid whose every tile fits in one wave gives each column tile its
    own split; n under one tile is one block."""
    p = trk.rank_plan(n, 19, H100_SMS, 1)
    assert (p["row_tiles"], p["col_tiles"]) == (row_tiles, col_tiles)
    assert p["splits"] == col_tiles and p["waves"] == 1
    assert p["blocks"] == row_tiles * col_tiles
    assert p["executed_flops"] == 2 * row_tiles * 96 * col_tiles * 256 * 32


def test_plan_takes_and_checks_forced_splits():
    assert trk.rank_plan(10500, 1200, H100_SMS, 1, splits=1)["blocks"] == 110
    assert trk.rank_plan(10500, 1200, H100_SMS, 1, splits=42)["splits"] == 42
    with pytest.raises(ValueError, match="column tiles"):
        trk.rank_plan(10500, 1200, H100_SMS, 1, splits=43)
    with pytest.raises(ValueError, match="column tiles"):
        trk.rank_plan(300, 8, H100_SMS, 1, splits=0)


@pytest.mark.parametrize("n,splits", [(10500, 4), (10500, 42), (120, 3),
                                      (5, 1), (257, 2)])
def test_column_splits_cover_whole_tiles(n, splits):
    ranges = trk.column_splits(n, splits)
    assert ranges[0][0] == 0 and ranges[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(c0 % 256 == 0 for c0, _ in ranges)
    tiles = [-(-(c1 - c0) // 256) for c0, c1 in ranges]
    assert max(tiles) - min(tiles) <= 1


# ------------------------------------------------------------------ model

# 1 split; 2; 4, the plan's at the bench shape; 8, every model tile its own
SPLITS = [1, 2, 4, 8]


@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("k", [1, 3, 10])
@pytest.mark.parametrize("tied", [False, True])
def test_split_topk_mean_equals_twin(splits, k, tied):
    _, _, x, y, xn, yn = _inputs(tied)
    mean, diag = trk.topk_mean_split(x, y, xn, yn, k, splits, TILE)
    want_mean, want_diag = trk.topk_mean_twin(x, y, xn, yn, k)
    assert torch.equal(mean, want_mean)
    assert torch.equal(diag, want_diag)


@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("use_csls", [False, True])
@pytest.mark.parametrize("tied", [False, True])
def test_split_rank_counts_equal_twin(splits, use_csls, tied):
    _, _, x, y, xn, yn = _inputs(tied)
    rl, diag = trk.topk_mean_twin(x, y, xn, yn, 3)
    rr, _ = trk.topk_mean_twin(y, x, yn, xn, 3)
    if not use_csls:
        rl = rr = None
    counts, top3 = trk.rank_counts_split(x, y, xn, yn, rl, rr, diag, True,
                                         splits, TILE)
    want_counts, want_top3 = trk.rank_counts_twin(x, y, xn, yn, rl, rr, diag,
                                                  True)
    assert torch.equal(counts, want_counts)
    assert torch.equal(top3, want_top3)
    counts_only, none = trk.rank_counts_split(x, y, xn, yn, rl, rr, diag,
                                              False, splits, TILE)
    assert none is None and torch.equal(counts_only, want_counts)


@pytest.fixture
def force_interpret(monkeypatch):
    monkeypatch.setattr(prk, "FORCE_INTERPRET", True)


@functools.lru_cache(maxsize=None)
def _pallas(tied, k, use_csls):
    """The Pallas sweeps' outputs (call under ``force_interpret``)."""
    l, r, *_ = _inputs(tied)
    out = prk.streaming_rank_eval(jnp.asarray(l), jnp.asarray(r), k,
                                  use_csls, True)
    return [np.asarray(t) for t in out]


@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("k,use_csls,tied", [(3, True, True),
                                             (3, False, True),
                                             (10, True, False),
                                             (1, True, False)])
def test_split_sweeps_match_streaming_interpret(force_interpret, splits, k,
                                                use_csls, tied):
    """Both directions through ``two_sweeps`` with the split model in place
    of the kernels: the Pallas sweeps' ranks and top-3, exactly."""
    _, _, x, y, _, _ = _inputs(tied)
    got = trk.two_sweeps(
        x, y, k, use_csls, True,
        sweep_a=functools.partial(trk.topk_mean_split, splits=splits,
                                  tile_cols=TILE),
        sweep_b=functools.partial(trk.rank_counts_split, splits=splits,
                                  tile_cols=TILE))
    for a, b, name in zip(got, _pallas(tied, k, use_csls),
                          ("ranks_l2r", "ranks_r2l", "top3")):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)


def test_ties_fall_across_split_boundaries():
    """The tied columns of ``_tied_embs`` lie in different splits of the
    model's 16-column tiles (else the tie tests above test nothing of the
    merge)."""
    def split_of(col, splits):
        return next(i for i, (c0, c1) in enumerate(
            trk.column_splits(N, splits, TILE)) if c0 <= col < c1)
    assert split_of(9, 4) != split_of(40, 4)
    assert split_of(3, 8) != split_of(17, 8)
    assert split_of(12, 2) != split_of(77, 2)


# ------------------------------------------------------- both directions

@pytest.mark.parametrize("k,use_csls,tied", [(3, True, True),
                                             (3, False, True),
                                             (10, True, False),
                                             (1, True, False)])
def test_both_direction_twins_match_streaming_interpret(force_interpret, k,
                                                        use_csls, tied):
    """``both_sweeps`` (each launch both directions over one x y^T) with
    the twins in place of the kernels: the Pallas sweeps' ranks and top-3,
    exactly, as the four one-direction sweeps give them."""
    _, _, x, y, _, _ = _inputs(tied)
    got = trk.both_sweeps(x, y, k, use_csls, True,
                          sweep_a=trk.topk_mean_both_twin,
                          sweep_b=trk.rank_counts_both_twin)
    four = trk.two_sweeps(x, y, k, use_csls, True,
                          sweep_a=trk.topk_mean_twin,
                          sweep_b=trk.rank_counts_twin)
    for a, b, c, name in zip(got, four, _pallas(tied, k, use_csls),
                             ("ranks_l2r", "ranks_r2l", "top3")):
        np.testing.assert_array_equal(a.numpy(), c, err_msg=name)
        assert torch.equal(a, b), name


@pytest.mark.parametrize("k", [1, 3, 10])
@pytest.mark.parametrize("tied", [False, True])
def test_column_direction_split_model(k, tied):
    """The column direction of a both-direction sweep A is sweep A of the
    transposed problem, its partials taken over row tiles: the split model
    over the rows (tiles of 16 rows, every grouping) gives the twin's
    column means."""
    _, _, x, y, xn, yn = _inputs(tied)
    mean_rows, diag, mean_cols = trk.topk_mean_both_twin(x, y, xn, yn, k)
    want_rows, want_diag = trk.topk_mean_twin(x, y, xn, yn, k)
    assert torch.equal(mean_rows, want_rows) and torch.equal(diag, want_diag)
    for splits in SPLITS:
        cols, _ = trk.topk_mean_split(y, x, yn, xn, k, splits, TILE)
        assert torch.equal(cols, mean_cols)


# ------------------------------------------------------- kernel operands

@pytest.mark.parametrize("n,d", [(120, 24), (77, 19), (3, 5)])
def test_kernel_operands_layout(n, d):
    """x and y transposed to (d, ld), ld = n rounded up to 4, zeros past
    n: the k-major layout that both sweeps' kernels read."""
    l, r = _embs(n, d, seed=n)
    x, y = torch.from_numpy(l), torch.from_numpy(r)
    xt, yt, ld = trk.kernel_operands(x, y)
    assert ld == -(-n // 4) * 4 and ld % 4 == 0 and ld >= n
    for t, src in ((xt, x), (yt, y)):
        assert t.shape == (d, ld) and t.is_contiguous()
        assert torch.equal(t[:, :n], src.T)
        assert not t[:, n:].any()
    assert trk._operands(x, y, (xt, yt, ld)) == (xt, yt, ld)


def test_kernel_operands_are_checked():
    """Operands given to a launch must be those of ``kernel_operands``."""
    x, y = (torch.from_numpy(a) for a in _embs(10, 6, seed=1))
    xt, yt, ld = trk.kernel_operands(x, y)
    with pytest.raises(ValueError, match="shape"):
        trk._operands(x, y, (xt[:, :10], yt, ld))
    with pytest.raises(ValueError, match="ld"):
        trk._operands(x, y, (xt[:, :10].contiguous(),
                             yt[:, :10].contiguous(), 10))
    with pytest.raises(ValueError, match="contiguous"):
        trk._operands(x, y, (xt.T.contiguous().T, yt, ld))
