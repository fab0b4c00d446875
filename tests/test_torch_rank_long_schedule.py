"""A CPU model of sweep A's long lists (``csrc/rank_eval.cu``, CSLS k > 10).

The kernels cannot run here, so this file replays their schedule in
numpy on a similarity matrix and holds the result to the dense twin:

* ``offer``: a list's upkeep.  Each list keeps K values (descending), K
  slots of candidates, their count and the list's last entry (the
  threshold).  Offered values above the threshold are appended in lane
  order (a scan of the lanes' counts places them); a full buffer is merged
  by ``merge_candidates``, and what no longer beats the new threshold is
  dropped.  In the sweep a half-warp keeps a row, and the two halves of a
  warp (rows ``ty * 4 + r`` and ``(ty ^ 1) * 4 + r``) merge together when
  either is full;
* ``merge_candidates``: the candidates padded with -inf and sorted
  ascending by a bitonic network, the larger of list[i] and buf[i] (the K
  largest of both), and a bitonic merge to descending, step for step as
  ``bitonic_step`` runs them;
* ``sweep_model``: the sweep over (row tile, column split) blocks, each row
  offered a column tile at a time and flushed at the split's end; each
  block's column slots, the similarities of its rows to a column as they
  are (-inf past n); then ``long_topk_merge_kernel``'s two merges, a row's
  splits' lists and a column's row tiles, each on a warp's list.

Tiles are smaller than the card's (``tile_rows`` a multiple of 32, the
merge's lanes; ``tile_cols`` a multiple of 16, a row's lanes), so that a
small n has ragged row and column tiles and several splits.  A lane holds
the columns ``lane + 16 c`` of a tile here (the card: ``tile_col``); the
order of offers changes no kept value.  The top-K multiset of values is
unique and the mean adds it in descending order, so the model's lists must
give the twin's means bit for bit, at every k and split count.
"""

import numpy as np
import pytest
import torch

from snag_tpu_torch.ops.cuda import rank_eval as trk

KS = [11, 20, 32, 33, 64, 128]
SPLITS = [1, 3, 7]


def bitonic_step(v, s, up):
    """``rank_eval.cu::bitonic_step`` on each row of v (R, N): value i
    meets value i ^ s, the pair ascending where (i & up) == 0 (up = 0:
    every pair descending)."""
    i = np.arange(v.shape[1])
    o = v[:, i ^ s]
    asc = ((i & up) == 0) if up else np.zeros_like(i, dtype=bool)
    keep_min = ((i & s) == 0) == asc
    return np.where(keep_min, np.minimum(v, o), np.maximum(v, o))


def merge_candidates(lists, bufs, counts):
    """``rank_eval.cu::merge_candidates`` on each row: the new lists."""
    k = lists.shape[1]
    b = np.where(np.arange(k)[None, :] < counts[:, None], bufs, -np.inf)
    b = b.astype(np.float32)
    up = 2
    while up <= k:
        s = up // 2
        while s >= 1:
            b = bitonic_step(b, s, up)
            s //= 2
        up *= 2
    out = np.maximum(lists, b)
    s = k // 2
    while s >= 1:
        out = bitonic_step(out, s, 0)
        s //= 2
    return out


class Lists:
    """R lists of K with their candidates, counts and thresholds;
    ``partner[i]``: the list that merges with list i (itself for a warp's
    list, the other half's for a half-warp's)."""

    def __init__(self, r, k, partner=None):
        self.k = k
        self.list = np.full((r, k), -np.inf, np.float32)
        self.buf = np.zeros((r, k), np.float32)
        self.count = np.zeros(r, np.int64)
        self.thr = np.full(r, -np.inf, np.float32)
        self.partner = np.arange(r) if partner is None else partner
        self.merges = 0

    def merge(self, which):
        if which.any():
            self.list[which] = merge_candidates(self.list[which],
                                                self.buf[which],
                                                self.count[which])
            self.thr[which] = self.list[which, -1]
            self.count[which] = 0
            self.merges += int(which.sum())

    def offer(self, vals):
        """``rank_eval.cu::offer``: vals (R, M), each row's values in lane
        order (a lane's values in turn, lane 0 first); NaN and -inf never
        pass the threshold."""
        k = self.k
        rows = np.arange(len(vals))[:, None]
        with np.errstate(invalid="ignore"):
            pend = vals > self.thr[:, None]
        while pend.any():
            at = self.count[:, None] + np.cumsum(pend, axis=1) - 1
            put = pend & (at < k)
            self.buf[np.broadcast_to(rows, at.shape)[put], at[put]] = vals[put]
            self.count = np.minimum(self.count + pend.sum(axis=1), k)
            pend &= ~put
            full = self.count == k
            which = full | full[self.partner]
            self.merge(which)
            with np.errstate(invalid="ignore"):
                pend[which] &= vals[which] > self.thr[which, None]

    def flush(self):
        busy = self.count > 0
        self.merge(busy | busy[self.partner])
        return self.list


def _lanes(v, lanes):
    """v (R, W) in lane order: lane h holds columns h + lanes * c."""
    r, w = v.shape
    return v.reshape(r, w // lanes, lanes).transpose(0, 2, 1).reshape(r, w)


def sweep_model(s, k, splits, tile_rows=32, tile_cols=32):
    """Sweep A's long lists on the similarity matrix s (n, n) f32: the
    rows' and the columns' top-K lists (K = ``list_len(k)``), descending,
    as the sweep and its two merges leave them; and the merges' count."""
    n = s.shape[0]
    big = trk.list_len(k)
    row_tiles = -(-n // tile_rows)
    pad = np.full((row_tiles * tile_rows, -(-n // tile_cols) * tile_cols),
                  -np.inf, np.float32)
    pad[:n, :n] = s
    part = np.zeros((splits, n, big), np.float32)
    col_part = np.zeros((row_tiles, n, tile_rows), np.float32)
    ty = np.arange(tile_rows) // 4
    partner = (ty ^ 1) * 4 + np.arange(tile_rows) % 4
    merges = 0
    for rt in range(row_tiles):
        rows = slice(rt * tile_rows, (rt + 1) * tile_rows)
        for sp, (c0, c1) in enumerate(trk.column_splits(n, splits,
                                                        tile_cols)):
            lists = Lists(tile_rows, big, partner)
            for t0 in range(c0, c1, tile_cols):
                tile = pad[rows, t0:t0 + tile_cols]
                col_part[rt, t0:min(t0 + tile_cols, n)] = \
                    tile[:, :min(tile_cols, n - t0)].T
                lists.offer(_lanes(tile, 16))
            out = lists.flush()
            merges += lists.merges
            keep = min(tile_rows, n - rt * tile_rows)
            part[sp, rt * tile_rows:rt * tile_rows + keep] = out[:keep]

    def merge(chunks):
        parts, _, chunk = chunks.shape
        warp = Lists(n, big)
        for p in range(parts):
            warp.offer(_lanes(chunks[p], 32))
        out = warp.flush()
        return out, warp.merges

    rows_out, m_rows = merge(part)
    cols_out, m_cols = merge(col_part)
    return rows_out, cols_out, merges + m_rows + m_cols


def _top(v, big):
    """The K largest values of each row of v that are not NaN, descending,
    -inf past them."""
    v = np.where(np.isnan(v), -np.inf, v)
    out = -np.sort(-v, axis=1)[:, :big]
    return np.pad(out, ((0, 0), (0, max(0, big - out.shape[1]))),
                  constant_values=-np.inf)


def _tied_pair(n, d, seed):
    """x, y whose rows repeat and whose entries are small integers: many
    exact ties among the distances."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-2, 3, size=(n, d)).astype(np.float32) / 4
    y = rng.integers(-2, 3, size=(n, d)).astype(np.float32) / 4
    y[::5] = x[::5]
    x[1::7] = x[0]
    return torch.from_numpy(x), torch.from_numpy(y)


@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("k", KS)
def test_model_gives_the_twins_means_bitwise(k, splits):
    """Ragged tiles (n = 200 over 32-row and 32-column tiles), exact ties:
    the model's lists give ``topk_mean_both_twin``'s three outputs bit for
    bit."""
    x, y = _tied_pair(200, 12, seed=k + splits)
    xn, yn = (x * x).sum(1), (y * y).sum(1)
    mean, diag, mean_cols = trk.topk_mean_both_twin(x, y, xn, yn, k)
    d = trk._dense_distances(x, y, xn, yn)
    s = (1 - d).numpy()
    rows, cols, merges = sweep_model(s, k, splits)
    assert merges > 0
    got = torch.mean(torch.from_numpy(rows[:, :k]), dim=1)
    got_cols = torch.mean(torch.from_numpy(cols[:, :k]), dim=1)
    assert torch.equal(got, mean) and torch.equal(got_cols, mean_cols)
    assert torch.equal(torch.diagonal(d), diag)
    big = trk.list_len(k)
    np.testing.assert_array_equal(rows, _top(s, big))
    np.testing.assert_array_equal(cols, _top(s.T, big))


@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("k", KS)
def test_model_skips_nan_and_keeps_minus_inf_pads(k, splits):
    """NaN offers never enter a list, -inf offers only pad it, ties at
    the threshold keep their multiset: rows of s with few finite values end
    in -inf, as the twin's lists of those values do."""
    rng = np.random.default_rng(100 * k + splits)
    n = 150
    s = np.round(rng.normal(size=(n, n)), 1).astype(np.float32)  # ties
    s[rng.random(size=(n, n)) < 0.05] = np.nan
    s[rng.random(size=(n, n)) < 0.05] = -np.inf
    s[:3, 20:] = -np.inf         # rows with fewer than k finite values
    s[20:, 5] = np.nan           # a column of mostly NaN
    big = trk.list_len(k)
    rows, cols, _ = sweep_model(s, k, splits)
    np.testing.assert_array_equal(rows, _top(s, big))
    np.testing.assert_array_equal(cols, _top(s.T, big))


@pytest.mark.parametrize("k", [32, 128])
def test_merge_candidates_keeps_the_k_largest_of_list_and_buffer(k):
    """One network merge: any count of candidates (0 .. K, the rest of the
    buffer stale) and a list sorted descending give the K largest of both,
    sorted descending."""
    rng = np.random.default_rng(k)
    lists = -np.sort(-np.round(rng.normal(size=(64, k)), 1), axis=1)
    lists[::9, k // 2:] = -np.inf
    bufs = np.round(rng.normal(size=(64, k)), 1)
    counts = rng.integers(0, k + 1, size=64)
    counts[:2] = (0, k)
    got = merge_candidates(lists.astype(np.float32), bufs.astype(np.float32),
                           counts)
    for i in range(64):
        both = np.concatenate([lists[i], bufs[i, :counts[i]]])
        np.testing.assert_array_equal(got[i], -np.sort(-both)[:k]
                                      .astype(np.float32))
