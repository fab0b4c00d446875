"""Full-rank alignment evaluation.

Port of ``snag_tpu/eval/ranking.py`` (``full_rank_eval`` :224-256,
``result_from_ranks`` :280-297, ``RankResult``), L2 distances with
equal-sized sides.  Ranks use stable-sort tie semantics (strictly smaller
distances plus equal distances at an earlier column), with optional CSLS
re-ranking (src/utils.py:417-435) and the top-3 retrieval list
(main.py:395-420).  On CUDA the streaming kernels run; on the CPU the
dense twin.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from snag_tpu_torch.ops.cuda.rank_eval import streaming_rank_eval


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


def full_rank_eval(emb_l: torch.Tensor, emb_r: torch.Tensor,
                   top_k=(1, 10, 50), csls_k: int = 10,
                   use_csls: bool = False, distance_kind: int = 2,
                   with_top3: bool = False) -> RankResult:
    """Bidirectional Hits@K / MR / MRR (main.py:380-444)."""
    if distance_kind != 2:
        raise NotImplementedError("--distance 1 (L1) is not ported yet")
    if emb_l.shape[0] != emb_r.shape[0]:
        raise NotImplementedError(
            "sides of different sizes need the chunked evaluator, which is "
            "not ported yet")
    ranks_l2r, ranks_r2l, top3 = streaming_rank_eval(
        emb_l, emb_r, csls_k, use_csls, with_top3)
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
