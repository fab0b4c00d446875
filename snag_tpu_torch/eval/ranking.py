"""Full-rank alignment evaluation.

Port of ``snag_tpu/eval/ranking.py`` (``full_rank_eval`` :224-256,
``l1_distances`` :66, the chunked evaluator ``_knn_means`` :158,
``_chunk_ranks`` :179 and ``_chunked_ranks_one_direction`` :195,
``result_from_ranks`` :280-297, ``RankResult``).  Ranks use stable-sort tie
semantics (strictly smaller distances plus equal distances at an earlier
column), with optional CSLS re-ranking (src/utils.py:417-435) and the
top-3 retrieval list (main.py:395-420).

Dispatch, as the JAX package's ``full_rank_eval``:

* squared-L2 with sides of equal size: the streaming CUDA sweeps for CUDA
  tensors (any N); for CPU tensors the dense twin up to
  ``FULL_MATRIX_MAX`` pairs and the chunked evaluator above;
* otherwise (``--distance 1``, sides of unequal size) torch ops on either
  device, as JAX runs XLA there: the dense evaluation up to
  ``FULL_MATRIX_MAX`` pairs (L1: ``L1_FULL_MAX``), the chunked evaluator
  above.  Sides of unequal size always take the chunked evaluator: the
  JAX package's dense path cannot broadcast them (its ``_ranks`` raises a
  TypeError), and its chunked path ranks them, the gold of query i being
  candidate i (clamped to the last candidate where i runs past them, as a
  JAX gather clamps its index).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from snag_tpu_torch.ops.cuda.rank_eval import (eval_core, pairwise_distances,
                                               streaming_rank_eval,
                                               topk_rowwise)

# above this many test pairs the dense (N, N) matrices are too big and the
# chunked evaluator runs (snag_tpu/eval/ranking.py:144)
FULL_MATRIX_MAX = 25000
# L1 chunks much earlier: each of its distances is a scan over feature
# slices with an (B, N, L1_SLICE) transient (:148)
L1_FULL_MAX = 1024
L1_SLICE = 64
L1_BLOCK = 1 << 28      # elements of that transient at most (1 GiB in f32)
KNN_CHUNK = 4096        # query rows a CSLS neighbourhood block (:158)
RANK_CHUNK = 4096       # query rows a rank block (:195)
L1_RANK_CHUNK = 512     # the same under L1 (:199-201)

Distances = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


@dataclass
class RankResult:
    acc_l2r: np.ndarray     # hits at top_k, fractions
    acc_r2l: np.ndarray
    mr_l2r: float
    mr_r2l: float
    mrr_l2r: float
    mrr_r2l: float
    top3_l2r: Optional[np.ndarray] = None   # (N, 3) retrieved col indices
    ranks_l2r: Optional[np.ndarray] = None  # (N,)


def l1_distances(q: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(B, N) cityblock distances (main.py:388-390, ``--distance 1``) in the
    JAX package's order: d zero-padded to a multiple of ``L1_SLICE``, each
    slice's sum of |q - c| added to the running total in turn, from 0.
    Query rows go in blocks whose (rows, N, L1_SLICE) transient holds at
    most ``L1_BLOCK`` elements."""
    pad = (-q.shape[1]) % L1_SLICE
    if pad:
        # |0 - 0| adds nothing to a distance
        q, c = F.pad(q, (0, pad)), F.pad(c, (0, pad))
    rows = max(1, L1_BLOCK // (c.shape[0] * L1_SLICE))
    out = []
    for i in range(0, q.shape[0], rows):
        qb = q[i:i + rows]
        acc = torch.zeros(qb.shape[0], c.shape[0], dtype=q.dtype,
                          device=q.device)
        for s in range(0, q.shape[1], L1_SLICE):
            qs, cs = qb[:, s:s + L1_SLICE], c[:, s:s + L1_SLICE]
            acc = acc + (qs[:, None, :] - cs[None, :, :]).abs_().sum(dim=-1)
        out.append(acc)
    return torch.cat(out)


def _distances(kind: int) -> Distances:
    if kind not in (1, 2):
        raise ValueError(f"distance kind {kind}: 1 (L1) or 2 (squared L2)")
    return pairwise_distances if kind == 2 else l1_distances


def knn_means(emb_q: torch.Tensor, emb_c: torch.Tensor, k: int,
              distances: Distances) -> torch.Tensor:
    """(N_q,) mean similarity of each query's top-k candidates (the CSLS
    terms), ``KNN_CHUNK`` query rows at a time: the similarity block is
    (chunk, N_c), never (N_q, N_c)."""
    chunk = KNN_CHUNK
    return torch.cat([
        torch.mean(topk_rowwise(1 - distances(emb_q[i:i + chunk], emb_c),
                                k)[0], dim=1)
        for i in range(0, emb_q.shape[0], chunk)])


def chunk_ranks(q: torch.Tensor, emb_c: torch.Tensor, gold: torch.Tensor,
                r_q: Optional[torch.Tensor], r_c: Optional[torch.Tensor],
                distances: Distances, with_top3: bool):
    """(ranks, top3 or None) of a block of queries against every
    candidate: gold ``gold[i]`` (clamped to the last candidate for its
    distance, as a JAX gather clamps), CSLS when r_q and r_c are given,
    in the op order 1 - ((2s - r_q) - r_c)."""
    d = distances(q, emb_c)
    if r_q is not None:
        d = 1 - (2 * (1 - d) - r_q[:, None] - r_c[None, :])
    rows = torch.arange(q.shape[0], device=q.device)
    d_true = d[rows, gold.clamp(max=emb_c.shape[0] - 1)][:, None]
    cols = torch.arange(emb_c.shape[0], device=q.device)[None, :]
    smaller = ((d < d_true) & (cols != gold[:, None])).sum(dim=1)
    tied = ((d == d_true) & (cols < gold[:, None])).sum(dim=1)
    top3 = topk_rowwise(-d, 3)[1] if with_top3 else None
    return smaller + tied, top3


def chunked_ranks_one_direction(emb_q: torch.Tensor, emb_c: torch.Tensor,
                                csls_k: int, use_csls: bool,
                                distance_kind: int = 2,
                                with_top3: bool = False):
    """Ranks (and top-3) of every query of ``emb_q`` against ``emb_c``,
    query i's gold being candidate i, ``RANK_CHUNK`` queries at a time
    (``L1_RANK_CHUNK`` under L1); CSLS terms from ``knn_means``."""
    distances = _distances(distance_kind)
    chunk = min(RANK_CHUNK, L1_RANK_CHUNK) if distance_kind == 1 \
        else RANK_CHUNK
    r_q = r_c = None
    if use_csls:
        r_q = knn_means(emb_q, emb_c, csls_k, distances)
        r_c = knn_means(emb_c, emb_q, csls_k, distances)
    ranks, top3s = [], []
    for i in range(0, emb_q.shape[0], chunk):
        j = min(i + chunk, emb_q.shape[0])
        gold = torch.arange(i, j, device=emb_q.device)
        rk, t3 = chunk_ranks(emb_q[i:j], emb_c, gold,
                             None if r_q is None else r_q[i:j], r_c,
                             distances, with_top3)
        ranks.append(rk)
        top3s.append(t3)
    return torch.cat(ranks), (torch.cat(top3s) if with_top3 else None)


def full_rank_eval(emb_l: torch.Tensor, emb_r: torch.Tensor,
                   top_k=(1, 10, 50), csls_k: int = 10,
                   use_csls: bool = False, distance_kind: int = 2,
                   with_top3: bool = False) -> RankResult:
    """Bidirectional Hits@K / MR / MRR (main.py:380-444); the dispatch of
    the module docstring."""
    n = emb_l.shape[0]
    distances = _distances(distance_kind)
    equal = emb_l.shape[0] == emb_r.shape[0]
    if distance_kind == 2 and equal and (emb_l.device.type == "cuda"
                                         or n <= FULL_MATRIX_MAX):
        ranks_l2r, ranks_r2l, top3 = streaming_rank_eval(
            emb_l, emb_r, csls_k, use_csls, with_top3)
    elif not equal or n > (FULL_MATRIX_MAX if distance_kind == 2
                           else L1_FULL_MAX):
        one_way = functools.partial(chunked_ranks_one_direction,
                                    csls_k=csls_k, use_csls=use_csls,
                                    distance_kind=distance_kind)
        ranks_l2r, top3 = one_way(emb_l, emb_r, with_top3=with_top3)
        ranks_r2l, _ = one_way(emb_r, emb_l)
    else:
        ranks_l2r, ranks_r2l, top3 = eval_core(emb_l, emb_r, csls_k, use_csls,
                                               with_top3, distances=distances)
    return result_from_ranks(ranks_l2r.cpu().numpy(), ranks_r2l.cpu().numpy(),
                             None if top3 is None else top3.cpu().numpy(),
                             top_k)


def result_from_ranks(ranks_l2r, ranks_r2l, top3, top_k=(1, 10, 50)):
    """Summarize rank arrays into the RankResult contract."""
    ranks_l2r = np.asarray(ranks_l2r)
    ranks_r2l = np.asarray(ranks_r2l)

    def summarize(ranks):
        acc = np.array([(ranks < k).mean() for k in top_k])
        acc = np.round(acc, 4)
        mr = float((ranks + 1).mean())
        mrr = float((1.0 / (ranks + 1)).mean())
        return acc, mr, mrr

    acc_l, mr_l, mrr_l = summarize(ranks_l2r)
    acc_r, mr_r, mrr_r = summarize(ranks_r2l)
    return RankResult(acc_l2r=acc_l, acc_r2l=acc_r, mr_l2r=mr_l, mr_r2l=mr_r,
                      mrr_l2r=mrr_l, mrr_r2l=mrr_r,
                      top3_l2r=None if top3 is None else np.asarray(top3),
                      ranks_l2r=ranks_l2r)
