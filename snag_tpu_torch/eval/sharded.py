"""Full-rank evaluation with the query rows split over a mesh's ranks.

Port of ``snag_tpu/eval/sharded.py``: each rank ranks its share of the
query rows (``Mesh.rows``) against every candidate, in plain torch ops as
the JAX package computes its block outside any Pallas kernel.  The
candidate side of CSLS is the one cross-rank quantity: each rank takes
every candidate's top-k similarities over its own queries, one all-gather
merges them, and the top-k of the union is the global top-k, so its mean
is exact.  A rank with fewer than k queries fills its lists with -inf, as
the JAX package masks its padded rows.  A second all-gather hands every
rank all the ranks (and the top-3), so every rank takes the same
early-stop and best-model decisions.

Ranks use ``eval/ranking.py``'s rule (strictly smaller plus equal at an
earlier column) and CSLS its op order 1 - ((2s - r_q) - r_c); query rows
go ``RANK_CHUNK`` at a time, so the transient is (chunk, N_c).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from snag_tpu_torch.eval.ranking import RANK_CHUNK, chunk_ranks
from snag_tpu_torch.ops.cuda.rank_eval import pairwise_distances, topk_rowwise
from snag_tpu_torch.parallel.mesh import Mesh


def _top_values(sim: torch.Tensor, k: int) -> torch.Tensor:
    """(rows, k) row-wise top-k values, -inf past the row's width."""
    if sim.shape[1] < k:
        sim = torch.cat([sim, sim.new_full((sim.shape[0], k - sim.shape[1]),
                                           float("-inf"))], dim=1)
    return topk_rowwise(sim, k)[0]


def _csls_terms(mesh: Mesh, q: torch.Tensor, emb_c: torch.Tensor, k: int):
    """(r_q of this rank's queries, r_c of every candidate)."""
    r_q, cand_top = [], None
    for i in range(0, q.shape[0], RANK_CHUNK):
        sim = 1 - pairwise_distances(q[i:i + RANK_CHUNK], emb_c)
        r_q.append(torch.mean(topk_rowwise(sim, k)[0], dim=1))
        top = _top_values(sim.T, k)
        cand_top = top if cand_top is None else _top_values(
            torch.cat([cand_top, top], dim=1), k)
    if cand_top is None:        # no query rows on this rank
        cand_top = emb_c.new_full((emb_c.shape[0], k), float("-inf"))
    # the union of every rank's top-k holds the global top-k
    every = mesh.all_gather(cand_top[None])                  # (W, N_c, k)
    union = every.permute(1, 0, 2).reshape(emb_c.shape[0], -1)
    r_c = torch.mean(topk_rowwise(union, k)[0], dim=1)
    r_q = torch.cat(r_q) if r_q else emb_c.new_zeros((0,))
    return r_q, r_c


def _one_direction(mesh: Mesh, emb_q: torch.Tensor, emb_c: torch.Tensor,
                   csls_k: int, use_csls: bool, with_top3: bool):
    n = emb_q.shape[0]
    lo, hi = mesh.rows(n)
    q = emb_q[lo:hi]
    r_q = r_c = None
    if use_csls:
        r_q, r_c = _csls_terms(mesh, q, emb_c, csls_k)
    ranks = [q.new_zeros((0,), dtype=torch.int64)]
    top3 = [q.new_zeros((0, 3), dtype=torch.int64)]
    for i in range(0, hi - lo, RANK_CHUNK):
        j = min(i + RANK_CHUNK, hi - lo)
        gold = torch.arange(lo + i, lo + j, device=q.device)
        rk, t3 = chunk_ranks(q[i:j], emb_c, gold,
                             None if r_q is None else r_q[i:j], r_c,
                             pairwise_distances, with_top3)
        ranks.append(rk.to(torch.int64))
        if with_top3:
            top3.append(t3.to(torch.int64))
    ranks = mesh.gather_shards(torch.cat(ranks), n)
    top3 = mesh.gather_shards(torch.cat(top3), n) if with_top3 else None
    return ranks, top3


def sharded_full_rank_eval(mesh: Mesh, emb_l: torch.Tensor,
                           emb_r: torch.Tensor, csls_k: int = 10,
                           use_csls: bool = False, with_top3: bool = True):
    """Bidirectional ranks and the l2r top-3 (None without ``with_top3``)
    of squared-L2 distances, query rows split over ``mesh``'s ranks;
    every rank returns all of them, as numpy arrays, the contract of
    ``eval.ranking.result_from_ranks``."""
    ranks_l2r, top3 = _one_direction(mesh, emb_l, emb_r, csls_k, use_csls,
                                     with_top3)
    ranks_r2l, _ = _one_direction(mesh, emb_r, emb_l, csls_k, use_csls,
                                  False)
    top3_np: Optional[np.ndarray] = (None if top3 is None
                                     else top3.cpu().numpy())
    return ranks_l2r.cpu().numpy(), ranks_r2l.cpu().numpy(), top3_np
