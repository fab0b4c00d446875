"""Streaming full-rank evaluation: CUDA kernels and their dense twin.

Kernels: ``csrc/rank_eval.cu`` over the tile product ``csrc/rank_tile.cuh``,
replacing ``snag_tpu/ops/pallas/rank_eval.py::_run_topk_mean`` (sweep A:
per-row CSLS neighbourhood mean, k <= ``MAX_LONG_K``, and diagonal) and
``::_run_ranks`` (sweep B: gold rank counts and top-3 retrieval).
Neither sweep writes the (N, N) matrix.  A sweep runs as blocks of (row tile, column split); each split
leaves a partial per row and a second kernel merges them in split order
(``rank_plan`` chooses the splits).  Every launch does both directions
over one pass of x y^T (``topk_mean_both_cuda``, ``rank_counts_both_cuda``);
``topk_mean_cuda`` and ``rank_counts_cuda`` return its row direction.
``streaming_rank_eval`` runs two launches (``both_sweeps``).

Twins: ``topk_mean_twin`` and ``rank_counts_twin``, the plain versions of
the two sweeps (same signatures, dense matrices), and their ``*_both_twin``
forms; ``topk_mean_split`` and ``rank_counts_split``, the plain model of
the split sweeps and their merge; and ``eval_core``, the dense port of
``snag_tpu/eval/ranking.py::_eval_core`` (``pairwise_distances``,
``csls_sim``, ``_ranks``, ``topk_rowwise``), which CPU tensors run.  It
keeps the JAX package's op order, so CSLS ties resolve the same way.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Optional, Tuple

import torch

from snag_tpu_torch.ops.cuda._lib import (KernelStats, check, load_library,
                                          ptr, require, stream_of)

STATS_TOPK = KernelStats("rank_topk_mean")
# sweep A at k above MAX_K (the lists in shared memory), counted apart
STATS_TOPK_LONG = KernelStats("rank_topk_mean_long")
STATS_RANKS = KernelStats("rank_counts")
MAX_K = 10          # sweep A's longest list kept in registers
# sweep A's longest list (csrc/rank_eval.cu, long_topk_mean_kernel: lists
# in shared memory, kept by a threshold, candidates and a bitonic merge):
# the JAX kernel's running top-k is a (rows, 128) scratch, so k <= 128
# there too
MAX_LONG_K = 128
# the sweeps' block tile (csrc/rank_tile.cuh: BM, BN, BK) and the ints of
# one sweep-B partial (csrc/rank_eval.cu: PART_B)
TILE_ROWS, TILE_COLS, TILE_DEPTH = 96, 256, 16
PART_B = 8
# a block's cost beyond its column tiles, in tiles: filling the ring,
# merging its lanes, writing its partial
SPLIT_OVERHEAD = 0.1


# ---------------------------------------------------------------- twin

def pairwise_distances(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Squared-L2 distances via norms + matmul, clamped >= 0
    (src/utils.py:202-218)."""
    x_norm = torch.sum(x ** 2, dim=1)[:, None]
    y_norm = torch.sum(y ** 2, dim=1)[None, :]
    d = x_norm + y_norm - 2.0 * (x @ y.T)
    return torch.clamp(d, min=0.0)


def topk_rowwise(x: torch.Tensor, k: int):
    """Row-wise top-k (values, indices) by k argmax passes: ties go to the
    first (lowest) column, like ``jax.lax.top_k``'s stable order."""
    cols = torch.arange(x.shape[1], device=x.device)[None, :]
    vals, idxs = [], []
    for _ in range(k):
        i = torch.argmax(x, dim=1)
        vals.append(torch.gather(x, 1, i[:, None])[:, 0])
        idxs.append(i)
        x = torch.where(cols == i[:, None], float("-inf"), x)
    return torch.stack(vals, dim=1), torch.stack(idxs, dim=1)


def csls_sim(sim_mat: torch.Tensor, k: int) -> torch.Tensor:
    """CSLS re-ranking 2*sim - r_left - r_right, in the op order of
    ``snag_tpu/eval/ranking.py::csls_sim`` (src/utils.py:417-435)."""
    nearest1 = torch.mean(topk_rowwise(sim_mat, k)[0], dim=1)
    nearest2 = torch.mean(topk_rowwise(sim_mat.T, k)[0], dim=1)
    out = 2 * sim_mat.T - nearest1[None, :]
    out = out.T - nearest2[None, :]
    return out


def _ranks(distance: torch.Tensor) -> torch.Tensor:
    """rank[i] = position of column i in a stable ascending sort of row i;
    the gold column is excluded from the strict comparison."""
    n = distance.shape[0]
    d_true = torch.diagonal(distance)[:, None]
    cols = torch.arange(distance.shape[1], device=distance.device)[None, :]
    rows = torch.arange(n, device=distance.device)[:, None]
    smaller = ((distance < d_true) & (cols != rows)).sum(dim=1)
    tied_before = ((distance == d_true) & (cols < rows)).sum(dim=1)
    return smaller + tied_before


def eval_core(emb_l: torch.Tensor, emb_r: torch.Tensor, csls_k: int,
              use_csls: bool, with_top3: bool, *,
              distances=pairwise_distances):
    """Dense twin: (ranks_l2r, ranks_r2l, top3 or None).  ``distances``:
    the distance matrix of the two sides (``eval.ranking.l1_distances``
    for ``--distance 1``, which the JAX package's ``_eval_core`` ranks
    alike)."""
    distance = distances(emb_l, emb_r)
    if use_csls:
        distance = 1 - csls_sim(1 - distance, csls_k)
    ranks_l2r = _ranks(distance)
    ranks_r2l = _ranks(distance.T)
    top3 = topk_rowwise(-distance, 3)[1] if with_top3 else None
    return ranks_l2r, ranks_r2l, top3


def _dense_distances(x, y, xn, yn):
    return torch.clamp(xn[:, None] + yn[None, :] - 2.0 * (x @ y.T), min=0.0)


def _csls_dist(dist, r_row, r_col):
    """1 - ((2s - r_row) - r_col) with s = 1 - dist: csls_sim's op order."""
    return 1 - ((2 * (1 - dist) - r_row) - r_col)


def topk_mean_twin(x, y, xn, yn, k: int):
    """Plain version of sweep A: (mean of each row's top-k similarities,
    raw diagonal distance)."""
    d = _dense_distances(x, y, xn, yn)
    return torch.mean(topk_rowwise(1 - d, k)[0], dim=1), torch.diagonal(d)


def _gold_counts(dist, d_true):
    """[#{dist < d_true, col != row}, #{dist == d_true, col < row}] (N, 2)."""
    n = dist.shape[0]
    cols = torch.arange(n, device=dist.device)[None, :]
    rows = torch.arange(n, device=dist.device)[:, None]
    smaller = ((dist < d_true) & (cols != rows)).sum(dim=1)
    tied = ((dist == d_true) & (cols < rows)).sum(dim=1)
    return torch.stack([smaller, tied], dim=1).to(torch.int32)


def rank_counts_twin(x, y, xn, yn, rl, rr, diag, with_top3: bool):
    """Plain version of sweep B: (counts (N, 2) int32 = [smaller,
    tied-before], top3 (N, 3) int32 or None); CSLS when rl and rr are
    given."""
    d = _dense_distances(x, y, xn, yn)
    if rl is None:
        dist, d_true = d, diag[:, None]
    else:
        dist = _csls_dist(d, rl[:, None], rr[None, :])
        d_true = _csls_dist(diag, rl, rr)[:, None]
    top3 = (topk_rowwise(-dist, 3)[1].to(torch.int32) if with_top3 else None)
    return _gold_counts(dist, d_true), top3


def topk_mean_both_twin(x, y, xn, yn, k: int):
    """Plain version of sweep A in both directions from one distance
    matrix: (row means, diagonal, column means), the column means being
    sweep A's on (y, x)."""
    d = _dense_distances(x, y, xn, yn)
    return (torch.mean(topk_rowwise(1 - d, k)[0], dim=1), torch.diagonal(d),
            torch.mean(topk_rowwise((1 - d).T, k)[0], dim=1))


def rank_counts_both_twin(x, y, xn, yn, rl, rr, diag, with_top3: bool):
    """Plain version of sweep B in both directions from one distance
    matrix: (row counts, top3 or None, column counts), the column counts
    being sweep B's on (y, x) with the CSLS terms swapped."""
    d = _dense_distances(x, y, xn, yn)
    if rl is None:
        dist, d_true = d, diag[:, None]
        dist_t, d_true_t = d.T, diag[:, None]
    else:
        dist = _csls_dist(d, rl[:, None], rr[None, :])
        d_true = _csls_dist(diag, rl, rr)[:, None]
        dist_t = _csls_dist(d.T, rr[:, None], rl[None, :])
        d_true_t = _csls_dist(diag, rr, rl)[:, None]
    top3 = (topk_rowwise(-dist, 3)[1].to(torch.int32) if with_top3 else None)
    return _gold_counts(dist, d_true), top3, _gold_counts(dist_t, d_true_t)


# ---------------------------------------------------------------- splits

def column_splits(n: int, splits: int, tile_cols: int = TILE_COLS
                  ) -> List[Tuple[int, int]]:
    """The column ranges [c0, c1) of the ``splits`` splits: whole column
    tiles, as evenly as they divide (``rank_tile.cuh::split_tiles``)."""
    ct = -(-n // tile_cols)
    bounds = [s * ct // splits for s in range(splits + 1)]
    return [(bounds[s] * tile_cols, min(bounds[s + 1] * tile_cols, n))
            for s in range(splits)]


def _top_values(v: torch.Tensor, k: int) -> torch.Tensor:
    """The k largest values of each row, descending; -inf past its end."""
    if v.shape[1] < k:
        v = torch.cat([v, torch.full((v.shape[0], k - v.shape[1]),
                                     float("-inf"), dtype=v.dtype)], dim=1)
    return torch.topk(v, k, dim=1).values


def _best3(v: torch.Tensor, i: torch.Tensor):
    """The best 3 (value, id) of each row: larger value first, among equal
    values the lower id (``rank_eval.cu::better``)."""
    by_id = torch.sort(i, dim=1, stable=True).indices
    v, i = torch.gather(v, 1, by_id), torch.gather(i, 1, by_id)
    order = torch.sort(v, dim=1, descending=True, stable=True).indices[:, :3]
    return torch.gather(v, 1, order), torch.gather(i, 1, order)


def topk_mean_split(x, y, xn, yn, k: int, splits: int,
                    tile_cols: int = TILE_COLS):
    """Plain model of sweep A's kernels: each column split keeps the top-k
    similarities of every row; merged in split order they are the row's
    top-k, whose mean (and the diagonal, from the split that holds it) is
    what ``topk_mean_twin`` returns."""
    d = _dense_distances(x, y, xn, yn)
    s = 1 - d
    top = torch.full((x.shape[0], k), float("-inf"), dtype=s.dtype)
    for c0, c1 in column_splits(x.shape[0], splits, tile_cols):
        top = _top_values(torch.cat([top, _top_values(s[:, c0:c1], k)], 1), k)
    return torch.mean(top, dim=1), torch.diagonal(d)


def rank_counts_split(x, y, xn, yn, rl, rr, diag, with_top3: bool,
                      splits: int, tile_cols: int = TILE_COLS):
    """Plain model of sweep B's kernels: each column split counts its
    closer and tied columns and keeps its best 3 (value, id); merged in
    split order (counts added, best 3 of the union) they are
    ``rank_counts_twin``'s outputs."""
    d = _dense_distances(x, y, xn, yn)
    if rl is None:
        dist, d_true = d, diag[:, None]
    else:
        dist = _csls_dist(d, rl[:, None], rr[None, :])
        d_true = _csls_dist(diag, rl, rr)[:, None]
    n = d.shape[0]
    rows = torch.arange(n)[:, None]
    counts = torch.zeros(n, 2, dtype=torch.int32)
    best_v = torch.full((n, 3), float("-inf"), dtype=dist.dtype)
    best_i = torch.full((n, 3), torch.iinfo(torch.int32).max)
    for c0, c1 in column_splits(n, splits, tile_cols):
        part, cols = dist[:, c0:c1], torch.arange(c0, c1)[None, :]
        counts += torch.stack(
            [((part < d_true) & (cols != rows)).sum(dim=1),
             ((part == d_true) & (cols < rows)).sum(dim=1)], dim=1).to(
                 torch.int32)
        if with_top3:
            best_v, best_i = _best3(torch.cat([best_v, -part], dim=1),
                                    torch.cat([best_i, cols.expand(n, -1)],
                                              dim=1))
    return counts, (best_i.to(torch.int32) if with_top3 else None)


def choose_splits(row_tiles: int, col_tiles: int, slots: int) -> int:
    """Column splits for a grid of ``row_tiles`` x splits blocks over
    ``slots`` resident blocks: when every (row, column) tile fits in one
    wave, one tile a block; else the fewest splits of least modelled time,
    waves x (the longest split's tiles + SPLIT_OVERHEAD), among those whose
    last wave is at least 90 % full, if any is."""
    if row_tiles * col_tiles <= slots:
        return col_tiles

    def waves(s):
        return -(-row_tiles * s // slots)

    def fill(s):
        return (row_tiles * s - (waves(s) - 1) * slots) / slots

    def cost(s):
        return waves(s) * (-(-col_tiles // s) + SPLIT_OVERHEAD)

    every = range(1, col_tiles + 1)
    full = [s for s in every if fill(s) >= 0.9]
    return min(full or every, key=lambda s: (cost(s), s))


def rank_plan(n: int, d: int, sms: int, blocks_per_sm: int,
              splits: Optional[int] = None) -> Dict[str, float]:
    """How a sweep runs at (n, d) on ``sms`` SMs that hold
    ``blocks_per_sm`` of its blocks: its block tile, column splits (chosen
    by ``choose_splits`` unless given), blocks, waves, the share of the
    last wave's slots that hold a block, and the flops it executes
    (padded to whole tiles)."""
    row_tiles, col_tiles = -(-n // TILE_ROWS), -(-n // TILE_COLS)
    slots = sms * blocks_per_sm
    if splits is None:
        splits = choose_splits(row_tiles, col_tiles, slots)
    if not 1 <= splits <= col_tiles:
        raise ValueError(f"{splits} splits; n = {n} has {col_tiles} column "
                         "tiles")
    blocks = row_tiles * splits
    waves = -(-blocks // slots)
    return {"tile_rows": TILE_ROWS, "tile_cols": TILE_COLS,
            "row_tiles": row_tiles, "col_tiles": col_tiles,
            "splits": splits, "blocks": blocks,
            "blocks_per_sm": blocks_per_sm, "waves": waves,
            "last_wave": (blocks - (waves - 1) * slots) / slots,
            "executed_flops": 2 * row_tiles * TILE_ROWS * col_tiles
            * TILE_COLS * -(-d // TILE_DEPTH) * TILE_DEPTH}


def list_len(k: int) -> int:
    """Length of sweep A's per-row list for k (``rank_eval.cu::list_len``):
    1, 3 or ``MAX_K`` in registers, 32 or ``MAX_LONG_K`` in shared memory
    (``long_topk_mean_kernel``, whose column direction goes through
    ``col_scratch_floats``)."""
    if not 1 <= k <= MAX_LONG_K:
        raise ValueError(f"CSLS k = {k}: sweep A takes 1..{MAX_LONG_K}, as "
                         "the JAX package's streaming kernel does")
    for size in (1, 3, MAX_K, 32):
        if k <= size:
            return size
    return MAX_LONG_K


def col_scratch_floats(n: int, k: int) -> int:
    """Floats of sweep A's column scratch at (n, k): per row tile, each
    column's top ``list_len(k)`` (lists in registers) or, for a long list,
    each column's ``TILE_ROWS`` similarities to the tile's rows as they are
    (0.44 GB at n = 10,500, 2.5 GB at 25,000), which the column merge
    reduces."""
    size = list_len(k)
    return -(-n // TILE_ROWS) * n * (size if size <= MAX_K else TILE_ROWS)


# ---------------------------------------------------------------- kernels

_BLOCKS_PER_SM: Dict[Tuple[int, int, int], int] = {}


def _library():
    built = load_library("rank_eval")
    lib = built.lib
    if lib.rank_counts.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.rank_topk_mean.argtypes = [vp] * 9 + [ci] * 5 + [vp]
        lib.rank_topk_mean.restype = ci
        lib.rank_counts.argtypes = [vp] * 12 + [ci] * 6 + [vp]
        lib.rank_counts.restype = ci
        lib.rank_blocks_per_sm.argtypes = [ci, ci]
        lib.rank_blocks_per_sm.restype = ci
        lib.rank_smem_bytes.argtypes = [ci, ci]
        lib.rank_smem_bytes.restype = ci
    return built


def device_plan(device: torch.device, n: int, d: int, sweep: int, key: int,
                splits: Optional[int] = None) -> Dict[str, float]:
    """``rank_plan`` of a sweep kernel on ``device``, and its block's
    dynamic shared memory (``smem_bytes``): sweep 0 is A at k = ``key``,
    sweep 1 is B with ``key`` = use_csls + 2 with_top3."""
    built = _library()
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    cache = (index, sweep, list_len(key) if sweep == 0 else key)
    if cache not in _BLOCKS_PER_SM:
        with torch.cuda.device(device):
            blocks = built.lib.rank_blocks_per_sm(sweep, key)
        if blocks < 0:
            check(built, -blocks, "rank_blocks_per_sm")
        if blocks == 0:
            raise RuntimeError("a rank sweep's block does not fit on an SM")
        _BLOCKS_PER_SM[cache] = blocks
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return {**rank_plan(n, d, sms, _BLOCKS_PER_SM[cache], splits),
            "smem_bytes": built.lib.rank_smem_bytes(sweep, key)}


def _check_pair(x, y, xn, yn):
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"rank-eval kernels need CUDA tensors, got {dev}")
    n, d = x.shape
    require(x, "x", torch.float32, (n, d), dev)
    require(y, "y", torch.float32, (n, d), dev)
    require(xn, "xn", torch.float32, (n,), dev)
    require(yn, "yn", torch.float32, (n,), dev)
    return n, d, dev


Operands = Tuple[torch.Tensor, torch.Tensor, int]


def _transposed(x: torch.Tensor) -> torch.Tensor:
    """x^T as (d, ld) with ld = n rounded up to 4 and zeros past n: the
    k-major operand layout of ``rank_tile.cuh``."""
    n, d = x.shape
    t = torch.empty(d, -(-n // 4) * 4, dtype=x.dtype, device=x.device)
    t[:, :n].copy_(x.T)
    t[:, n:].zero_()
    return t


def kernel_operands(x: torch.Tensor, y: torch.Tensor) -> Operands:
    """(xt, yt, ld): x and y as both sweeps' kernels read them, made once
    for any number of launches on the same pair."""
    xt = _transposed(x)
    return xt, _transposed(y), xt.shape[1]


def _operands(x, y, operands: Optional[Operands]) -> Operands:
    if operands is None:
        return kernel_operands(x, y)
    xt, yt, ld = operands
    n, d = x.shape
    for name, t in (("xt", xt), ("yt", yt)):
        require(t, name, torch.float32, (d, ld), x.device)
    if ld < n or ld % 4:
        raise ValueError(f"ld = {ld} for n = {n}; see kernel_operands")
    return operands


def _sweep_a(x, y, xn, yn, k, splits, operands):
    n, d, dev = _check_pair(x, y, xn, yn)
    size = list_len(k)
    if k > n:
        raise ValueError(f"k = {k} > {n} candidates")
    built = _library()
    plan = device_plan(dev, n, d, 0, k, splits)
    xt, yt, ld = _operands(x, y, operands)
    mean = torch.empty(n, dtype=torch.float32, device=dev)
    diag = torch.empty(n, dtype=torch.float32, device=dev)
    mean_cols = torch.empty(n, dtype=torch.float32, device=dev)
    part = torch.empty(plan["splits"] * n * size, dtype=torch.float32,
                       device=dev)
    col_part = torch.empty(col_scratch_floats(n, k), dtype=torch.float32,
                           device=dev)
    with torch.cuda.device(dev):
        err = built.lib.rank_topk_mean(
            ptr(xt), ptr(yt), ptr(xn), ptr(yn), ptr(part), ptr(mean),
            ptr(diag), ptr(col_part), ptr(mean_cols), n, d, ld, k,
            plan["splits"], stream_of(x))
    check(built, err, "rank_topk_mean")
    (STATS_TOPK if size <= MAX_K else STATS_TOPK_LONG).launches += 1
    return mean, diag, mean_cols


def topk_mean_cuda(x: torch.Tensor, y: torch.Tensor, xn: torch.Tensor,
                   yn: torch.Tensor, k: int, *, splits: Optional[int] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sweep A: (mean of each row's top-k similarities, raw diagonal
    distance), both (N,) f32: the row direction of ``topk_mean_both_cuda``.
    ``splits`` overrides the plan's column splits (the outputs are the same
    bits for any)."""
    return _sweep_a(x, y, xn, yn, k, splits, None)[:2]


def topk_mean_both_cuda(x: torch.Tensor, y: torch.Tensor, xn: torch.Tensor,
                        yn: torch.Tensor, k: int, *,
                        splits: Optional[int] = None,
                        operands: Optional[Operands] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sweep A in both directions from one pass over x y^T: (row means,
    diagonal, column means), the column means being the bits of the row
    means on (y, x).  ``operands``: ``kernel_operands(x, y)``, made here
    when not given."""
    return _sweep_a(x, y, xn, yn, k, splits, operands)


def _sweep_b(x, y, xn, yn, rl, rr, diag, with_top3, splits, operands):
    n, d, dev = _check_pair(x, y, xn, yn)
    use_csls = rl is not None
    if use_csls != (rr is not None):
        raise ValueError("give both CSLS terms rl and rr, or neither")
    if use_csls:
        require(rl, "rl", torch.float32, (n,), dev)
        require(rr, "rr", torch.float32, (n,), dev)
    require(diag, "diag", torch.float32, (n,), dev)
    if with_top3 and n < 3:
        raise ValueError("top-3 needs at least 3 candidates")
    built = _library()
    key = int(use_csls) + 2 * int(with_top3)
    plan = device_plan(dev, n, d, 1, key, splits)
    xt, yt, ld = _operands(x, y, operands)
    counts = torch.empty(n, 2, dtype=torch.int32, device=dev)
    counts_cols = torch.empty(n, 2, dtype=torch.int32, device=dev)
    top3 = (torch.empty(n, 3, dtype=torch.int32, device=dev)
            if with_top3 else None)
    part = torch.empty(plan["splits"] * n * PART_B, dtype=torch.int32,
                       device=dev)
    col_part = torch.empty(plan["row_tiles"] * n * 2, dtype=torch.int32,
                           device=dev)
    with torch.cuda.device(dev):
        err = built.lib.rank_counts(
            ptr(xt), ptr(yt), ptr(xn), ptr(yn), ptr(rl), ptr(rr), ptr(diag),
            ptr(part), ptr(counts), ptr(top3), ptr(col_part),
            ptr(counts_cols), n, d, ld, int(use_csls), int(with_top3),
            plan["splits"], stream_of(x))
    check(built, err, "rank_counts")
    STATS_RANKS.launches += 1
    return counts, top3, counts_cols


def rank_counts_cuda(x: torch.Tensor, y: torch.Tensor, xn: torch.Tensor,
                     yn: torch.Tensor, rl: Optional[torch.Tensor],
                     rr: Optional[torch.Tensor], diag: torch.Tensor,
                     with_top3: bool, *, splits: Optional[int] = None
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Sweep B: (counts (N, 2) int32 = [smaller, tied-before], top3 (N, 3)
    int32 or None).  CSLS applies when ``rl`` and ``rr`` are given.  The
    row direction of ``rank_counts_both_cuda``; ``splits`` overrides the
    plan's column splits."""
    return _sweep_b(x, y, xn, yn, rl, rr, diag, with_top3, splits, None)[:2]


def rank_counts_both_cuda(x: torch.Tensor, y: torch.Tensor,
                          xn: torch.Tensor, yn: torch.Tensor,
                          rl: Optional[torch.Tensor],
                          rr: Optional[torch.Tensor], diag: torch.Tensor,
                          with_top3: bool, *, splits: Optional[int] = None,
                          operands: Optional[Operands] = None):
    """Sweep B in both directions from one pass over x y^T: (row counts,
    top3 or None, column counts), the column counts being the bits of the
    row counts on (y, x, rr, rl) with the same diagonal.  ``operands``:
    ``kernel_operands(x, y)``, made here when not given."""
    return _sweep_b(x, y, xn, yn, rl, rr, diag, with_top3, splits, operands)


def two_sweeps(emb_l, emb_r, csls_k, use_csls, with_top3,
               sweep_a=topk_mean_cuda, sweep_b=rank_counts_cuda):
    """Both directions from four sweeps, one a direction and kind: the
    kernels by default, or their twins (same signatures) to check this
    composition on the CPU."""
    x, y = emb_l, emb_r
    xn = torch.sum(x * x, dim=1)
    yn = torch.sum(y * y, dim=1)
    # sweep A also yields the diagonal that sweep B ranks against, so it
    # runs without CSLS too (k = 1, mean unused)
    k = csls_k if use_csls else 1
    rl, diag_lr = sweep_a(x, y, xn, yn, k)
    rr, diag_rl = sweep_a(y, x, yn, xn, k)
    if not use_csls:
        rl = rr = None
    counts_l, top3 = sweep_b(x, y, xn, yn, rl, rr, diag_lr, with_top3)
    counts_r, _ = sweep_b(y, x, yn, xn, rr, rl, diag_rl, False)
    return counts_l.sum(dim=1), counts_r.sum(dim=1), top3


def both_sweeps(emb_l, emb_r, csls_k, use_csls, with_top3, sweep_a=None,
                sweep_b=None):
    """``two_sweeps``'s result from two launches that each do both
    directions over one pass of emb_l emb_r^T (the reverse direction's
    products and distances are the same bits): the kernels, on operands
    transposed once for both, unless twins are given."""
    x, y = emb_l, emb_r
    if sweep_a is None:
        operands = kernel_operands(x, y)
        sweep_a = functools.partial(topk_mean_both_cuda, operands=operands)
        sweep_b = functools.partial(rank_counts_both_cuda, operands=operands)
    xn = torch.sum(x * x, dim=1)
    yn = torch.sum(y * y, dim=1)
    k = csls_k if use_csls else 1
    rl, diag, rr = sweep_a(x, y, xn, yn, k)
    if not use_csls:
        rl = rr = None
    counts_l, top3, counts_r = sweep_b(x, y, xn, yn, rl, rr, diag, with_top3)
    return counts_l.sum(dim=1), counts_r.sum(dim=1), top3


def streaming_rank_eval(emb_l: torch.Tensor, emb_r: torch.Tensor,
                        csls_k: int, use_csls: bool, with_top3: bool):
    """Bidirectional gold ranks (+ l2r top-3), the protocol of
    ``snag_tpu/ops/pallas/rank_eval.py::streaming_rank_eval``: squared-L2
    distances, optional CSLS with k-neighbourhood means, stable-sort tie
    counting with the gold column excluded from the strict comparison.

    CUDA tensors run both sweeps, each over both directions
    (``both_sweeps``); CPU tensors run the dense twin
    (``eval.ranking.full_rank_eval`` sends it at most ``FULL_MATRIX_MAX``
    pairs and takes the chunked evaluator above).  Takes f32 alone,
    as the Pallas path casts the embeddings to f32 (rank_eval.py:247-248):
    a bf16 embedding raises."""
    if emb_l.dtype == torch.bfloat16 or emb_r.dtype == torch.bfloat16:
        raise TypeError("the rank sweeps have no bf16 variant: cast the "
                        "embeddings to float32 first")
    if emb_l.shape != emb_r.shape:
        raise ValueError(f"sides differ: {tuple(emb_l.shape)} vs "
                         f"{tuple(emb_r.shape)}")
    if emb_l.device.type == "cuda":
        return both_sweeps(emb_l, emb_r, csls_k, use_csls, with_top3)
    if emb_l.device.type != "cpu":
        raise ValueError(f"no rank-eval path for device {emb_l.device}")
    STATS_TOPK.twin_calls += 1
    STATS_RANKS.twin_calls += 1
    return eval_core(emb_l, emb_r, csls_k, use_csls, with_top3)
