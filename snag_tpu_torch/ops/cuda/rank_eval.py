"""Streaming full-rank evaluation: CUDA kernels and their dense twin.

Kernels: ``csrc/rank_eval.cu``, replacing
``snag_tpu/ops/pallas/rank_eval.py::_run_topk_mean`` (sweep A: per-row
CSLS neighbourhood mean and diagonal) and ``::_run_ranks`` (sweep B: gold
rank counts and top-3 retrieval).  Neither sweep writes the (N, N) matrix.

Twins: ``topk_mean_twin`` and ``rank_counts_twin``, the plain versions of
the two sweeps (same signatures, dense matrices); and ``eval_core``, the
dense port of ``snag_tpu/eval/ranking.py::_eval_core`` (``pairwise_distances``,
``csls_sim``, ``_ranks``, ``topk_rowwise``), which CPU tensors run.  It
keeps the JAX package's op order, so CSLS ties resolve the same way.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from snag_tpu_torch.ops.cuda._lib import (KernelStats, check, load_library,
                                          ptr, require, stream_of)

STATS_TOPK = KernelStats("rank_topk_mean")
STATS_RANKS = KernelStats("rank_counts")
MAX_K = 10
# above this many test pairs the dense twin's (N, N) matrices are too big;
# the JAX package switches to its chunked evaluator there
FULL_MATRIX_MAX = 25000


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
              use_csls: bool, with_top3: bool):
    """Dense twin: (ranks_l2r, ranks_r2l, top3 or None)."""
    distance = pairwise_distances(emb_l, emb_r)
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
    n = d.shape[0]
    cols = torch.arange(n, device=d.device)[None, :]
    rows = torch.arange(n, device=d.device)[:, None]
    smaller = ((dist < d_true) & (cols != rows)).sum(dim=1)
    tied = ((dist == d_true) & (cols < rows)).sum(dim=1)
    counts = torch.stack([smaller, tied], dim=1).to(torch.int32)
    top3 = (topk_rowwise(-dist, 3)[1].to(torch.int32) if with_top3 else None)
    return counts, top3


# ---------------------------------------------------------------- kernels

def _library():
    built = load_library("rank_eval")
    lib = built.lib
    if lib.rank_counts.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.rank_topk_mean.argtypes = [vp] * 6 + [ci] * 3 + [vp]
        lib.rank_topk_mean.restype = ci
        lib.rank_counts.argtypes = [vp] * 9 + [ci] * 4 + [vp]
        lib.rank_counts.restype = ci
    return built


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


def topk_mean_cuda(x: torch.Tensor, y: torch.Tensor, xn: torch.Tensor,
                   yn: torch.Tensor, k: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sweep A: (mean of each row's top-k similarities, raw diagonal
    distance), both (N,) f32."""
    n, d, dev = _check_pair(x, y, xn, yn)
    if not 1 <= k <= min(MAX_K, n):
        raise ValueError(f"k = {k}; sweep A takes 1..{min(MAX_K, n)}")
    mean = torch.empty(n, dtype=torch.float32, device=dev)
    diag = torch.empty(n, dtype=torch.float32, device=dev)
    built = _library()
    with torch.cuda.device(dev):
        err = built.lib.rank_topk_mean(ptr(x), ptr(y), ptr(xn), ptr(yn),
                                       ptr(mean), ptr(diag), n, d, k,
                                       stream_of(x))
    check(built, err, "rank_topk_mean")
    STATS_TOPK.launches += 1
    return mean, diag


def rank_counts_cuda(x: torch.Tensor, y: torch.Tensor, xn: torch.Tensor,
                     yn: torch.Tensor, rl: Optional[torch.Tensor],
                     rr: Optional[torch.Tensor], diag: torch.Tensor,
                     with_top3: bool
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Sweep B: (counts (N, 2) int32 = [smaller, tied-before], top3 (N, 3)
    int32 or None).  CSLS applies when ``rl`` and ``rr`` are given."""
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
    counts = torch.empty(n, 2, dtype=torch.int32, device=dev)
    top3 = (torch.empty(n, 3, dtype=torch.int32, device=dev)
            if with_top3 else None)
    built = _library()
    with torch.cuda.device(dev):
        err = built.lib.rank_counts(ptr(x), ptr(y), ptr(xn), ptr(yn),
                                    ptr(rl), ptr(rr), ptr(diag), ptr(counts),
                                    ptr(top3), n, d, int(use_csls),
                                    int(with_top3), stream_of(x))
    check(built, err, "rank_counts")
    STATS_RANKS.launches += 1
    return counts, top3


def two_sweeps(emb_l, emb_r, csls_k, use_csls, with_top3,
               sweep_a=topk_mean_cuda, sweep_b=rank_counts_cuda):
    """Both directions from the two sweeps: the kernels by default, or
    their twins (same signatures) to check this composition on the CPU."""
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


def streaming_rank_eval(emb_l: torch.Tensor, emb_r: torch.Tensor,
                        csls_k: int, use_csls: bool, with_top3: bool):
    """Bidirectional gold ranks (+ l2r top-3), the protocol of
    ``snag_tpu/ops/pallas/rank_eval.py::streaming_rank_eval``: squared-L2
    distances, optional CSLS with k-neighbourhood means, stable-sort tie
    counting with the gold column excluded from the strict comparison.

    CUDA tensors run the two sweeps; CPU tensors run the dense twin."""
    if emb_l.shape != emb_r.shape:
        raise ValueError(f"sides differ: {tuple(emb_l.shape)} vs "
                         f"{tuple(emb_r.shape)}")
    if emb_l.device.type == "cuda":
        return two_sweeps(emb_l, emb_r, csls_k, use_csls, with_top3)
    if emb_l.device.type != "cpu":
        raise ValueError(f"no rank-eval path for device {emb_l.device}")
    if emb_l.shape[0] > FULL_MATRIX_MAX:
        raise NotImplementedError(
            f"{emb_l.shape[0]} test pairs on the CPU: the chunked evaluator "
            "is not ported yet")
    STATS_TOPK.twin_calls += 1
    STATS_RANKS.twin_calls += 1
    return eval_core(emb_l, emb_r, csls_k, use_csls, with_top3)
