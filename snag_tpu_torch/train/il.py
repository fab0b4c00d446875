"""Iterative learning (semi-supervised pseudo-labelling).

Port of ``snag_tpu/train/il.py`` (reference SNAG_MMEA/model/SNAG.py:192-229
+ main.py:214-237): every ``semi_learn_step`` epochs, mutual nearest
neighbours among the not-yet-aligned entities become candidate links; a
candidate must survive consecutive mining rounds (except on "fresh" rounds)
and every ``semi_learn_step * 10`` epochs the surviving candidates are
promoted into the train set.

The non-train pools are fixed-capacity id tensors with validity masks on
the device, candidate state one (Lc,) tensor (right-entity id or -1).
Distances are taken in blocks of left candidates at every size (the JAX
package builds the whole matrix below 25,000 of them); argmin ties go to
the first index, as ``jnp.argmin``'s and ``torch.argmin``'s do.  Only the
promotion touches the host.

Under a mesh (``mine_new_links(..., mesh=)``, JAX
``_mutual_argmins_sharded``) each rank scans its contiguous share of the
left candidates with the same core (``_chunk_scan``), and one all-gather
of every rank's column minima and argmins, and one of the left argmins,
give every rank the unsharded result bit for bit: ranks hold ascending
slices and ``torch.argmin`` over the rank axis takes the lowest rank on a
tie, so the first occurrence still wins.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

from snag_tpu_torch.ops.cuda.rank_eval import pairwise_distances

INF = 1e18
# left candidates per distance block: the (Lc, Rc) matrix is never built
MINE_CHUNK = 4096


@dataclass
class ILState:
    left_cand: torch.Tensor    # (Lc,) int64 entity ids
    left_valid: torch.Tensor   # (Lc,) bool
    right_cand: torch.Tensor   # (Rc,) int64
    right_valid: torch.Tensor  # (Rc,) bool
    cand_right: torch.Tensor   # (Lc,) int64 right id in candidate set, or -1

    @staticmethod
    def init(left_non_train: List[int], right_non_train: List[int],
             device) -> "ILState":
        lc = torch.as_tensor(np.asarray(left_non_train, dtype=np.int64),
                             device=device)
        rc = torch.as_tensor(np.asarray(right_non_train, dtype=np.int64),
                             device=device)
        return ILState(left_cand=lc,
                       left_valid=torch.ones_like(lc, dtype=torch.bool),
                       right_cand=rc,
                       right_valid=torch.ones_like(rc, dtype=torch.bool),
                       cand_right=torch.full_like(lc, -1))


def _chunk_scan(emb, left_cand, left_valid, right_emb, right_valid,
                offset: int, chunk: int = MINE_CHUNK):
    """(preds_l, colmin, colarg) of a slice of the left candidates: left
    chunks in index order, carrying the running column minima (a strictly
    smaller value wins, so the first occurrence is kept across chunks);
    the argmins are offset by ``offset``, the slice's first index."""
    rc = right_emb.shape[0]
    colmin = torch.full((rc,), INF, device=emb.device)
    colarg = torch.zeros(rc, dtype=torch.int64, device=emb.device)
    preds_l = [torch.zeros(0, dtype=torch.int64, device=emb.device)]
    for s in range(0, left_cand.shape[0], chunk):
        d = pairwise_distances(emb[left_cand[s:s + chunk]], right_emb)
        preds_l.append(torch.argmin(
            torch.where(right_valid[None, :], d, INF), dim=1))
        d_r = torch.where(left_valid[s:s + chunk, None], d, INF)
        cmin, carg = d_r.amin(dim=0), torch.argmin(d_r, dim=0)
        better = cmin < colmin
        colmin = torch.where(better, cmin, colmin)
        colarg = torch.where(better, carg + s + offset, colarg)
    return torch.cat(preds_l), colmin, colarg


def _mutual_argmins(emb, left_cand, left_valid, right_cand, right_valid,
                    chunk: int = MINE_CHUNK):
    """Both argmins without the (Lc, Rc) matrix."""
    preds_l, _, preds_r = _chunk_scan(emb, left_cand, left_valid,
                                      emb[right_cand], right_valid, 0, chunk)
    return preds_l, preds_r


def _mutual_argmins_sharded(mesh, emb, left_cand, left_valid, right_cand,
                            right_valid, chunk: int = MINE_CHUNK):
    """Both argmins with the left candidates split over ``mesh``'s ranks;
    every rank gets the whole of both."""
    lc = left_cand.shape[0]
    lo, hi = mesh.rows(lc)
    pl, cmin, carg = _chunk_scan(emb, left_cand[lo:hi], left_valid[lo:hi],
                                 emb[right_cand], right_valid, lo, chunk)
    allmin = mesh.all_gather(cmin[None])                    # (W, Rc)
    allarg = mesh.all_gather(carg[None])
    best = torch.argmin(allmin, dim=0)
    preds_r = torch.gather(allarg, 0, best[None])[0]
    return mesh.gather_shards(pl, lc), preds_r


def mine_new_links(emb: torch.Tensor, left_cand, left_valid, right_cand,
                   right_valid, cand_right, fresh: bool,
                   mesh=None) -> torch.Tensor:
    """One mining round (Iter_new_links, SNAG.py:192-208) on L2-normalised
    ``emb``; ``fresh`` drops the persistence filter; ``mesh`` splits the
    left candidates over its ranks where each gets at least one.  Returns
    the new cand_right."""
    if mesh is not None and left_cand.shape[0] >= mesh.world:
        preds_l, preds_r = _mutual_argmins_sharded(
            mesh, emb, left_cand, left_valid, right_cand, right_valid)
    else:
        preds_l, preds_r = _mutual_argmins(emb, left_cand, left_valid,
                                           right_cand, right_valid)
    lc = left_cand.shape[0]
    mutual = preds_r[preds_l] == torch.arange(lc, device=emb.device)
    pair_right = right_cand[preds_l]
    keep = mutual & left_valid & right_valid[preds_l]
    selected = keep if fresh else keep & (cand_right == pair_right)
    return torch.where(selected, pair_right, torch.full_like(pair_right, -1))


def promote_candidates(il: ILState, train_ill: np.ndarray, test_ill_set,
                       logger) -> Tuple[ILState, np.ndarray, int]:
    """Host-side data refresh (data_refresh, SNAG.py:210-229): append the
    mined pairs to train_ill, invalidate them in the pools, reset the
    candidates."""
    cand = il.cand_right.cpu().numpy()
    left = il.left_cand.cpu().numpy()
    lvalid = il.left_valid.cpu().numpy()
    sel = (cand >= 0) & lvalid
    if not sel.any():
        logger.info("len(new_links) is 0")
        return il, train_ill, 0

    new_pairs = np.stack([left[sel], cand[sel]], axis=1).astype(train_ill.dtype)
    train_ill = np.vstack([train_ill, new_pairs])
    num_true = sum((int(l), int(r)) in test_ill_set for l, r in new_pairs)
    logger.info(f"#new_links_select:{len(new_pairs)}")
    logger.info(f"train_ill.shape:{train_ill.shape}")
    logger.info(f"#true_links: {num_true}")
    logger.info(f"true link ratio: {(100 * num_true / len(new_pairs)):.1f}%")

    new_lvalid = lvalid.copy()
    new_lvalid[sel] = False
    right = il.right_cand.cpu().numpy()
    rvalid = il.right_valid.cpu().numpy() & ~np.isin(right, cand[sel])
    logger.info(f"#entity not in train set: {int(new_lvalid.sum())} (left) "
                f"{int(rvalid.sum())} (right)")

    dev = il.left_cand.device
    return (ILState(left_cand=il.left_cand,
                    left_valid=torch.as_tensor(new_lvalid, device=dev),
                    right_cand=il.right_cand,
                    right_valid=torch.as_tensor(rvalid, device=dev),
                    cand_right=torch.full_like(il.cand_right, -1)),
            train_ill, len(new_pairs))
