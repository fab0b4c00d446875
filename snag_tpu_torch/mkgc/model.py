"""MKGC model: port of ``snag_tpu/mkgc/model.py``.

Multi-modal TransE-style link prediction with SNAG fusion (reference
SNAG_MKGC/readme.md; architecture from arXiv:2403.06832 and the shared
MMEA fusion code):

* entity/relation embeddings (``emb_dim``) and visual/textual feature
  projections (the features average-pooled on the host, ``use_pool``);
* ``num_proj``: 1 = one shared projection stack; 2 = separate stacks for
  the head-role (``vis_proj``, ``txt_proj``) and tail-role
  (``vis_proj2``, ``txt_proj2``) entity representations;
* ``joint_way`` fusion over the 3 modality tokens [structure, visual,
  textual]: ``Mformer_hd_mean`` (mean of the fusion transformer's output
  tokens), ``Mformer_hd_graph`` (the structure token's output),
  ``Mformer_weight`` (weights from the last layer's attention times the
  normalised input tokens), ``atten_weight`` (a per-entity gate),
  ``learnable_weight`` (global softmax weights);
* a margin ranking loss against ``neg_num`` corruptions per positive,
  which the caller samples and passes in (``forward``).

Parameter names follow the JAX tree (``ent_emb``, ``rel_emb``,
``vis_proj``..., ``fusion_{i}`` with the MMEA ``BertLayer``'s torch names
inside, ``gate``, ``modal_weight``), so
``utils/import_reference.state_dict_from_flax`` carries JAX params across.
The gathers are advanced indexing, whose backward is torch's sort-based
indexing backward: no atomic adds, so repeated rows sum in a fixed order.

Under a mesh of N > 1 ranks (``mesh``, set by ``parallel.mesh.attach``)
each rank holds its share of both feature tables (``Mesh.rows``), and a
step's rows of both, for its positives and corruptions, come from their
owners in one fetch (``parallel.mesh.take_each``).  The
all-entity fusion and ``all_joint`` fuse this rank's share of the
entities, with the dropout masks drawn at the full count
(``ops.noise.RowSlice``), and gather the joints.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from snag_tpu_torch.mkgc.config import JOINT_WAYS, MKGCConfig
from snag_tpu_torch.ops import inits
from snag_tpu_torch.ops.fusion import BertLayer, l2norm, tlinear
from snag_tpu_torch.ops.noise import row_slice
from snag_tpu_torch.parallel.mesh import Table, gather_rows, take_each


# negative-joint formulation: "auto" picks all-entity fusion + gather when
# the batch touches more joint slots than the entity table (see forward);
# "on"/"off" force the branch (the JAX package's switch, model.py:40)
ALL_ENT_FUSION = "auto"


def avg_pool_features(x: np.ndarray, out_dim: int) -> np.ndarray:
    """Host-side 1D average pooling to a uniform width (readme.md:36
    ``use_pool``)."""
    d = x.shape[1]
    if d <= out_dim:
        return x.astype(np.float32)
    win = -(-d // out_dim)
    pad = win * out_dim - d
    xp = np.pad(x, ((0, 0), (0, pad)))
    return xp.reshape(x.shape[0], out_dim, win).mean(axis=2).astype(np.float32)


class MKGCFeatures(NamedTuple):
    """Both tables, each whole or this rank's ``RowShard``."""
    visual: Table    # (E, dv)
    textual: Table   # (E, dt)


class MKGCModel(nn.Module):
    """Weights are drawn from ``generator`` on the CPU; move the module to
    its device afterwards."""

    def __init__(self, cfg: MKGCConfig, ent_num: int, rel_num: int,
                 vis_dim: int, txt_dim: int, generator: torch.Generator):
        super().__init__()
        if cfg.joint_way not in JOINT_WAYS:
            raise ValueError(f"--joint_way {cfg.joint_way}: not one of "
                             f"{JOINT_WAYS}")
        self.cfg = cfg
        self.ent_num = ent_num
        self.mesh = None
        d = cfg.emb_dim
        self.ent_emb = nn.Parameter(inits.xavier_normal((ent_num, d),
                                                        generator))
        self.rel_emb = nn.Parameter(inits.xavier_normal((rel_num, d),
                                                        generator))
        self.vis_proj = tlinear(vis_dim, d, generator)
        self.txt_proj = tlinear(txt_dim, d, generator)
        if cfg.num_proj == 2:
            self.vis_proj2 = tlinear(vis_dim, d, generator)
            self.txt_proj2 = tlinear(txt_dim, d, generator)
        self.n_layers = 0
        if cfg.joint_way.startswith("Mformer"):
            self.n_layers = cfg.num_hidden_layers
            for i in range(self.n_layers):
                self.add_module(f"fusion_{i}", BertLayer(
                    d, cfg.num_attention_heads, cfg.intermediate_size,
                    bool(cfg.use_intermediate), generator))
        elif cfg.joint_way == "atten_weight":
            self.gate = tlinear(d, 1, generator)
        else:
            self.modal_weight = nn.Parameter(torch.ones(3))

    def _rows(self, feats: MKGCFeatures, idxs):
        """The (visual, textual) rows of the entities of each of ``idxs``:
        one fetch of both tables under a mesh."""
        return take_each(self.mesh, [feats.visual, feats.textual], idxs)

    def _modal_tokens(self, idx, rows, role: int):
        """(B, 3, d) modality tokens for entities ``idx``, whose (visual,
        textual) rows are ``rows``; role selects the projection stack when
        num_proj == 2 (0 = head, 1 = tail)."""
        vis_p, txt_p = self.vis_proj, self.txt_proj
        if self.cfg.num_proj == 2 and role == 1:
            vis_p, txt_p = self.vis_proj2, self.txt_proj2
        v, t = rows
        return torch.stack([self.ent_emb[idx], vis_p(v), txt_p(t)], dim=1)

    def _modal_tokens_mixed(self, idx, head_role, rows):
        """(B, 3, d) tokens with the projection stack selected per element:
        head_role[b] True -> the head-role stack, else the tail-role one
        (both are evaluated, as in JAX)."""
        v, t = rows
        if self.cfg.num_proj == 2:
            sel = head_role[:, None]
            vis = torch.where(sel, self.vis_proj(v), self.vis_proj2(v))
            txt = torch.where(sel, self.txt_proj(t), self.txt_proj2(t))
        else:
            vis, txt = self.vis_proj(v), self.txt_proj(t)
        return torch.stack([self.ent_emb[idx], vis, txt], dim=1)

    def joint(self, idx, feats: MKGCFeatures, role: int = 0,
              dropout_gen: Optional[torch.Generator] = None,
              rows=None) -> torch.Tensor:
        """Fused (B, d) entity representation per ``joint_way``; ``rows``:
        the (visual, textual) rows of ``idx`` where fetched already."""
        if rows is None:
            rows, = self._rows(feats, [idx])
        return self._fuse(self._modal_tokens(idx, rows, role), dropout_gen)

    def joint_mixed(self, idx, head_role, feats: MKGCFeatures,
                    dropout_gen: Optional[torch.Generator] = None,
                    rows=None) -> torch.Tensor:
        if rows is None:
            rows, = self._rows(feats, [idx])
        return self._fuse(self._modal_tokens_mixed(idx, head_role, rows),
                          dropout_gen)

    def _fuse(self, tokens: torch.Tensor,
              dropout_gen: Optional[torch.Generator]) -> torch.Tensor:
        way = self.cfg.joint_way
        if way.startswith("Mformer"):
            hidden, probs = tokens, None
            for i in range(self.n_layers):
                hidden, probs = getattr(self, f"fusion_{i}")(hidden,
                                                             dropout_gen)
            if way == "Mformer_hd_mean":
                out = hidden.mean(dim=1)
            elif way == "Mformer_hd_graph":
                out = hidden[:, 0, :]
            else:
                # Mformer_weight: the last layer's attention, summed over
                # heads and queries, weighs the normalised input tokens
                attention_pro = probs.sum(dim=1).sum(dim=-2) / math.sqrt(
                    3 * self.cfg.num_attention_heads)
                w = torch.softmax(attention_pro, dim=-1)          # (B, 3)
                out = torch.einsum("bm,bmd->bd", w, l2norm(tokens))
        elif way == "atten_weight":
            w = torch.softmax(self.gate(tokens).squeeze(-1), dim=-1)
            out = torch.einsum("bm,bmd->bd", w, l2norm(tokens))
        else:
            w = torch.softmax(self.modal_weight, dim=0)
            out = torch.einsum("m,bmd->bd", w, l2norm(tokens))
        # unit-norm joints: the TransE-style margin objective degenerates
        # without an entity-norm constraint
        return l2norm(out)

    def forward(self, pos: torch.Tensor, rand_ent: torch.Tensor,
                corrupt_head: torch.Tensor, feats: MKGCFeatures,
                dropout_gen: Optional[torch.Generator] = None,
                split: Optional[Tuple[int, int, int]] = None):
        """Margin ranking loss and its (d_pos, d_neg) means.

        pos: (B, 3) triples; rand_ent: (B, K) corruption entities;
        corrupt_head: (B, K) bool, True where rand_ent replaces the head.
        Joints are computed for the positives and the K corruptions only;
        the uncorrupted side reuses the positive joint.  ``split`` = (lo,
        hi, n): these B rows are rows lo:hi of an n-row batch (a mesh
        rank's share); the branch is the n-row batch's and the dropout
        masks are drawn at its shapes."""
        b, k = rand_ent.shape
        lo, hi, n = (0, b, b) if split is None else split
        r = self.rel_emb[pos[:, 1]]
        use_all = (n * (k + 2) > 2 * self.ent_num
                   if ALL_ENT_FUSION == "auto" else ALL_ENT_FUSION == "on")
        if use_all:
            # the batch touches more joint slots than the entity table:
            # fuse every entity once per role and gather
            all_h, all_t = self._all_joints(feats, dropout_gen)
            h, t = all_h[pos[:, 0]], all_t[pos[:, 2]]
            cor = torch.where(corrupt_head[:, :, None], all_h[rand_ent],
                              all_t[rand_ent])
        else:
            gen = (dropout_gen if split is None
                   else row_slice(dropout_gen, lo, hi, n))
            ents = [pos[:, 0], pos[:, 2], rand_ent.reshape(-1)]
            rows = self._rows(feats, ents)
            h = self.joint(ents[0], feats, 0, gen, rows[0])
            t = self.joint(ents[1], feats, 1, gen, rows[1])
            if split is not None:
                gen = row_slice(dropout_gen, lo * k, hi * k, n * k)
            cor = self.joint_mixed(ents[2], corrupt_head.reshape(-1), feats,
                                   gen, rows[2]).reshape(b, k, -1)

        def dist(x, rel, y):
            return torch.linalg.vector_norm(x + rel - y, dim=-1)

        d_pos = dist(h, r, t)                                       # (B,)
        d_neg = torch.where(corrupt_head,
                            dist(cor, r[:, None, :], t[:, None, :]),
                            dist(h[:, None, :], r[:, None, :], cor))
        loss = torch.clamp(self.cfg.margin + d_pos[:, None] - d_neg,
                           min=0.0).mean()
        return loss, {"d_pos": d_pos.mean(), "d_neg": d_neg.mean()}

    def _all_joints(self, feats: MKGCFeatures,
                    dropout_gen: Optional[torch.Generator]):
        """Every entity's joint in both roles.  Under a mesh of N > 1
        ranks each rank fuses its share of the entities and one
        differentiable gather puts them in order on every rank; each
        rank's loss is over its own batch rows, so the gather's backward
        sums the ranks' gradients."""
        mesh = self.mesh
        if mesh is None or mesh.world == 1:
            idx = torch.arange(self.ent_num, device=self.ent_emb.device)
            return (self.joint(idx, feats, 0, dropout_gen),
                    self.joint(idx, feats, 1, dropout_gen))
        lo, hi = mesh.rows(self.ent_num)
        gen = row_slice(dropout_gen, lo, hi, self.ent_num)
        return tuple(gather_rows(
            mesh, [self.joint(slice(lo, hi), feats, role, gen)
                   for role in (0, 1)], self.ent_num, replicated=False))

    def all_joint(self, feats: MKGCFeatures, role: int = 0) -> torch.Tensor:
        """Every entity's joint in one role, without dropout (under a mesh
        of N > 1 ranks each fuses its share and one all-gather gives every
        rank the whole)."""
        mesh = self.mesh
        if mesh is None or mesh.world == 1:
            idx = torch.arange(self.ent_num, device=self.ent_emb.device)
            return self.joint(idx, feats, role)
        lo, hi = mesh.rows(self.ent_num)
        return mesh.gather_shards(self.joint(slice(lo, hi), feats, role),
                                  self.ent_num)
