"""MSNEA (reference: SNAG_MMEA/model/MSNEA.py, MSNEA_tools.py, MSNEA_loss.py).

Port of ``snag_tpu/models/msnea.py``.  MSNEA has no graph encoder: it
learns an entity table ``ent_embed`` and a relation table ``rel_embed``
with TransE margin losses over relation triples, in the structural space
and in an image space (``fc3`` of the image features), plus pairwise
contrastive losses on four B x B score matrices against the identity
(the fused rows, the structural rows, the attribute rows and the image
rows of ``fc1``).  The reference forward ignores its constructor margin
and uses the default-arg 2.0 in the contrastive loss (MSNEA_loss.py:9-17);
the TransE margin is ``--margin``.

Triples: ``TripleBank`` holds each KG's triples and entity ids on the
device; ``sample_triple_batch`` takes sequential positive slices (the JAX
package's, exactly) and corrupts each positive's head or tail with an
entity of the same KG drawn from a ``torch.Generator`` (``jax.random``
streams cannot be reproduced, so the negatives match the JAX package's in
distribution, not in the drawn values).

Under a mesh of N > 1 ranks (``mesh``, set by ``parallel.mesh.attach``)
the step runs whole on every rank, and its rows of the feature tables,
which each rank holds a share of, come from their owners
(``parallel.mesh.take_each``: the triples' image rows in one fetch, the
links' rows of every table in another); ``joint_emb`` fuses this rank's
share of the entities and gathers the fused rows.

Every layer is f32 whatever ``--dtype`` says, as the JAX package's plain
``nn.Dense`` layers are.  Parameter names are the port's own
(``ent_embed.weight``, ``rel_embed.weight``, ``fc1``, ``fc3``,
``attr_encoder.fc1``, ``name_fc``, ``char_fc``): the JAX package maps no
reference MSNEA checkpoint, so a ``.pkl`` of this model is the port's
format, read back by the port.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from snag_tpu_torch.config import Config
from snag_tpu_torch.data.graph import DeviceGraph
from snag_tpu_torch.models.encoder import FeaturePack
from snag_tpu_torch.ops import inits
from snag_tpu_torch.ops.fusion import l2norm, tlinear
from snag_tpu_torch.parallel.mesh import take_each

Triples = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
MARGIN = 2.0    # the contrastive loss's default-arg margin (MSNEA_loss.py:9)


class TripleBank(NamedTuple):
    """Each KG's triples (head, relation, tail) and entity ids, int64 on
    one device, with the triple counts."""
    h1: torch.Tensor
    r1: torch.Tensor
    t1: torch.Tensor
    n1: int
    h2: torch.Tensor
    r2: torch.Tensor
    t2: torch.Tensor
    n2: int
    ents1: torch.Tensor
    ents2: torch.Tensor

    @staticmethod
    def from_data(data, device) -> "TripleBank":
        a1 = np.asarray(data.kg1_triples, dtype=np.int64).reshape(-1, 3)
        a2 = np.asarray(data.kg2_triples, dtype=np.int64).reshape(-1, 3)

        def t(a):
            return torch.as_tensor(np.ascontiguousarray(a), device=device)
        return TripleBank(
            h1=t(a1[:, 0]), r1=t(a1[:, 1]), t1=t(a1[:, 2]), n1=len(a1),
            h2=t(a2[:, 0]), r2=t(a2[:, 1]), t2=t(a2[:, 2]), n2=len(a2),
            ents1=t(np.asarray(data.kg1_entities, dtype=np.int64)),
            ents2=t(np.asarray(data.kg2_entities, dtype=np.int64)))


def positive_triples(bank: TripleBank, batch_size: int, step: int
                     ) -> Tuple[Triples, Triples]:
    """Each KG's positive slice at optimizer step ``step``: sizes in
    proportion to the KGs' triple counts (MSNEA_tools.py:40-57), starting
    at (step x size) mod count and wrapping around."""
    bs1 = int(bank.n1 / (bank.n1 + bank.n2) * batch_size)
    bs2 = batch_size - bs1

    def pos_slice(h, r, t, n, bs):
        idx = ((step * bs) % n + torch.arange(bs, device=h.device)) % n
        return h[idx], r[idx], t[idx]
    return (pos_slice(bank.h1, bank.r1, bank.t1, bank.n1, bs1),
            pos_slice(bank.h2, bank.r2, bank.t2, bank.n2, bs2))


def corrupt(gen: torch.Generator, pos: Triples, ents: torch.Tensor,
            neg_num: int) -> Triples:
    """``neg_num`` negatives per positive, in place (each positive
    repeated, ``jnp.repeat``'s order): the head or, with probability 0.5
    each, the tail replaced by an entity drawn uniformly from ``ents``
    (generate_neg_triples_fast)."""
    h, r, t = (x.repeat_interleave(neg_num) for x in pos)
    n = h.shape[0]
    head = torch.rand(n, generator=gen, device=h.device) < 0.5
    rand_ent = ents[torch.randint(0, ents.shape[0], (n,), generator=gen,
                                  device=h.device)]
    return torch.where(head, rand_ent, h), r, torch.where(head, t, rand_ent)


def sample_triple_batch(gen: torch.Generator, bank: TripleBank,
                        batch_size: int, step: int, neg_num: int
                        ) -> Tuple[Triples, Triples]:
    """(positives, negatives) of one step, KG1's then KG2's
    (``snag_tpu/models/msnea.py::sample_triple_batch``)."""
    p1, p2 = positive_triples(bank, batch_size, step)
    n1 = corrupt(gen, p1, bank.ents1, neg_num)
    n2 = corrupt(gen, p2, bank.ents2, neg_num)
    return (tuple(torch.cat([a, b]) for a, b in zip(p1, p2)),
            tuple(torch.cat([a, b]) for a, b in zip(n1, n2)))


def contrastive_loss(dis: torch.Tensor, label: torch.Tensor,
                     valid: Optional[torch.Tensor] = None,
                     margin: float = MARGIN) -> torch.Tensor:
    """MSNEA_loss.py:9-17; with ``valid``, the mean over the valid rows'
    and columns' pairs."""
    elem = ((1 - label) * dis ** 2
            + label * torch.clamp(margin - dis, min=0.0) ** 2)
    if valid is None:
        return elem.mean()
    vm = valid.to(dis.dtype)
    elem = elem * vm[:, None] * vm[None, :]
    return elem.sum() / torch.clamp(valid.sum() ** 2, min=1)


def _xlinear(in_features: int, out_features: int,
             generator: torch.Generator) -> nn.Linear:
    """flax ``nn.Dense`` with a xavier-normal kernel and a zero bias."""
    lin = nn.Linear(in_features, out_features)
    with torch.no_grad():
        lin.weight.copy_(inits.xavier_normal((out_features, in_features),
                                             generator))
        lin.bias.zero_()
    return lin


def _table(rows: int, dim: int, generator: torch.Generator) -> nn.Embedding:
    emb = nn.Embedding(rows, dim)
    with torch.no_grad():
        emb.weight.copy_(inits.xavier_normal((rows, dim), generator))
    return emb


class AttrEncoder(nn.Module):
    """MSNEA_tools.py:16-35: ``fc1`` over the attribute bag (the
    reference's vision-adaptive path is commented out)."""

    def __init__(self, attr_input_dim: int, dim: int,
                 generator: torch.Generator):
        super().__init__()
        self.fc1 = _xlinear(attr_input_dim, dim, generator)

    def forward(self, att_rows: torch.Tensor) -> torch.Tensor:
        return self.fc1(att_rows)


class MSNEA(nn.Module):
    def __init__(self, cfg: Config, ent_num: int, rel_num: int,
                 img_feature_dim: int, attr_input_dim: int,
                 char_feature_dim: int, generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        self.ent_num = ent_num
        self.mesh = None
        self.ent_embed = _table(ent_num, cfg.dim, generator)
        self.rel_embed = _table(rel_num, cfg.dim, generator)
        self.fc1 = _xlinear(img_feature_dim, cfg.dim, generator)
        self.fc3 = _xlinear(img_feature_dim, cfg.dim, generator)
        self.attr_encoder = AttrEncoder(attr_input_dim, cfg.dim, generator)
        self.surface = bool(cfg.w_char and cfg.w_name)
        if self.surface:
            # torch's default init at the reference's fan-ins (_tdense)
            self.name_fc = tlinear(300, cfg.char_dim, generator, fan_in=300)
            self.char_fc = tlinear(char_feature_dim, cfg.char_dim, generator)

    @classmethod
    def from_data(cls, cfg: Config, data,
                  generator: torch.Generator) -> "MSNEA":
        return cls(cfg, ent_num=data.ent_num, rel_num=data.rel_num,
                   img_feature_dim=data.img_dim,
                   attr_input_dim=int(data.att_features.shape[1]),
                   char_feature_dim=data.char_dim, generator=generator)

    def r_rep(self, e: torch.Tensor) -> torch.Tensor:
        return l2norm(self.ent_embed.weight[e])

    def _emb_generate(self, feats: FeaturePack, *idxs):
        """The modality rows of entities ``idxs[i]`` (ids, or this rank's
        ``slice`` of every entity), one tuple an index set, every table's
        rows fetched together."""
        cfg = self.cfg
        tables = [feats.img if cfg.w_img else None,
                  feats.att if (cfg.w_attr and cfg.w_img) else None,
                  feats.name if cfg.w_name else None,
                  feats.char if cfg.w_char else None]
        out = []
        for idx, (img, att, name, char) in zip(
                idxs, take_each(self.mesh, tables, idxs)):
            out.append((
                None if img is None else l2norm(self.fc1(img)),
                self.r_rep(idx) if cfg.w_rel else None,
                None if att is None else self.attr_encoder(att),
                None if name is None else self.name_fc(name),
                None if char is None else self.char_fc(char)))
        return out

    @staticmethod
    def _fusion(embs) -> torch.Tensor:
        return l2norm(torch.cat([l2norm(e) for e in embs if e is not None],
                                dim=1))

    def _transe(self, reps, pos: Triples, neg: Triples) -> torch.Tensor:
        """``reps``: the rows of pos's heads and tails and neg's."""
        p_h, p_t, n_h, n_t = reps
        rel = self.rel_embed.weight
        pos_d = torch.sum(torch.square(p_h + l2norm(rel[pos[1]]) - p_t),
                          dim=1)
        neg_d = torch.sum(torch.square(n_h + l2norm(rel[neg[1]]) - n_t),
                          dim=1)
        pos_d = pos_d.repeat_interleave(n_h.shape[0] // p_h.shape[0])
        return torch.sum(torch.relu(self.cfg.margin + pos_d - neg_d))

    def forward(self, links: torch.Tensor, valid: Optional[torch.Tensor],
                feats: FeaturePack, graph: DeviceGraph,
                entity_noise_gen: Optional[torch.Generator] = None,
                dropout_gen: Optional[torch.Generator] = None,
                pos_triples: Optional[Triples] = None,
                neg_triples: Optional[Triples] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The training loss of a batch of links and a triple batch; MSNEA
        draws no noise and has no dropout, so both generators are unused."""
        # the triples' heads and tails; their image rows in one fetch
        ents = [pos_triples[0], pos_triples[2], neg_triples[0],
                neg_triples[2]]
        r_loss = (self._transe([self.r_rep(e) for e in ents], pos_triples,
                               neg_triples)
                  + self._transe([l2norm(self.fc3(img)) for img, in
                                  take_each(self.mesh, [feats.img], ents)],
                                 pos_triples, neg_triples))

        (i1, r1, a1, nm1, ch1), (i2, r2, a2, nm2, ch2) = self._emb_generate(
            feats, links[:, 0], links[:, 1])
        all1 = self._fusion([r1, i1, a1, nm1, ch1])
        all2 = self._fusion([r2, i2, a2, nm2, ch2])

        label = torch.eye(links.shape[0], dtype=all1.dtype,
                          device=all1.device)
        align = (contrastive_loss(all1 @ all2.T, label, valid)
                 + contrastive_loss(r1 @ r2.T, label, valid)
                 + contrastive_loss(a1 @ a2.T, label, valid)
                 + contrastive_loss(i1 @ i2.T, label, valid))
        return r_loss + align, {"kge": r_loss, "align": align}

    def joint_emb(self, feats: FeaturePack, graph: DeviceGraph):
        """Eval/IL embedding: (fused rows (N, d), None), fused in the order
        rel, img, att, name, char (MSNEA.py:joint_emb_generat); under a
        mesh of N > 1 ranks each fuses its share of the entities
        (``Mesh.rows``, its own rows of the tables) and one all-gather
        gives every rank the whole."""
        mesh = self.mesh
        if mesh is None or mesh.world == 1:
            idx = torch.arange(self.ent_num, device=feats.img.device)
        else:
            idx = slice(*mesh.rows(self.ent_num))
        (img, rel, att, name, char), = self._emb_generate(feats, idx)
        fused = self._fusion([rel, img, att, name, char])
        if isinstance(idx, slice):
            fused = mesh.gather_shards(fused, self.ent_num)
        return fused, None
