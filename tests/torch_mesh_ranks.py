"""What the ranks of ``test_torch_mesh.py`` run, and the one-rank runs
they are held against.

Each job is a function of plain arguments that returns numpy results; a
spawned rank (``run``) runs its jobs in order and pickles each result to
``<out>/<job>.rank<r>.pkl``.  This module imports torch and the port
only: a rank never imports JAX.
"""

import os
import pickle

import numpy as np
import torch

from torch_port_common import SMALL


def run(jobs, out_dir):
    """A spawned rank's entry: one intra-op thread, then every job."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    rank = dist.get_rank()
    for name, kind, kw in jobs:
        res = JOBS[kind](**kw)
        with open(os.path.join(out_dir, f"{name}.rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)


def load(out_dir, name, world):
    """Every rank's result of job ``name``."""
    out = []
    for r in range(world):
        with open(os.path.join(out_dir, f"{name}.rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def port_config(data_root, **overrides):
    from snag_tpu_torch.config import Config, finalize_config
    return finalize_config(Config(device="cpu", **{**SMALL, **overrides}),
                           data_root=data_root)


def _numpy_state(model):
    return {k: v.detach().cpu().numpy().copy()
            for k, v in model.state_dict().items()}


def runner_job(data_root, epochs, mesh_shape="", evaluate=False, mine=False,
               **overrides):
    """``epochs`` epochs of the runner (``np.random.seed(e)`` before epoch
    e, as the JAX mesh tests do), then optionally the last-epoch
    evaluation and one fresh mining round on the trained model."""
    from snag_tpu_torch.ops.fusion import l2norm
    from snag_tpu_torch.train import il as il_mod
    from snag_tpu_torch.train.runner import Runner
    from snag_tpu_torch.utils.logging import create_logger
    cfg = port_config(data_root, mesh_shape=mesh_shape, **overrides)
    runner = Runner(cfg, create_logger(name=f"mesh_{mesh_shape or 'one'}"))
    out = {"losses": [], "replay": [], "batch_size": runner.cfg.batch_size}
    for e in range(epochs):
        runner.epoch = e
        np.random.seed(e)
        out["losses"].append(runner.train_epoch())
        if runner.replay_neg is not None:
            out["replay"].append(runner.replay_neg.cpu().numpy().copy())
    out["params"] = _numpy_state(runner.model)
    if evaluate:
        res = runner.evaluate(last_epoch=True)
        out["eval"] = (res.ranks_l2r, res.mrr_l2r, res.mrr_r2l, res.top3_l2r)
    if mine:
        with torch.no_grad():
            emb = l2norm(runner._joint_emb()[0])
        il = il_mod.ILState.init(runner.data.left_non_train,
                                 runner.data.right_non_train, "cpu")
        out["mine"] = il_mod.mine_new_links(
            emb, il.left_cand, il.left_valid, il.right_cand, il.right_valid,
            il.cand_right, True, mesh=runner.mesh).numpy()
    return out


def step_job(state_path, data_root, batches, total, warmup, mesh_shape="",
             **overrides):
    """``TrainStep``s (a horizon of ``total`` steps, ``warmup`` of
    warm-up, noise and dropout off) from the state dict at
    ``state_path``, one on each (links, valid) of ``batches``."""
    from snag_tpu_torch.data.dataset import load_data
    from snag_tpu_torch.models import build_model
    from snag_tpu_torch.models.encoder import place_features
    from snag_tpu_torch.parallel import mesh as mesh_mod
    from snag_tpu_torch.train.step import TrainStep
    cfg = port_config(data_root, **overrides)
    data = load_data(cfg)
    model = build_model(cfg, data, torch.Generator().manual_seed(0))
    model.load_state_dict(torch.load(state_path, weights_only=True))
    mesh = None
    n = mesh_mod.parse_mesh_shape(mesh_shape)
    if n:
        mesh = mesh_mod.make_mesh(n, "cpu")
        mesh_mod.attach(model, mesh)
    step = TrainStep(cfg, model, cfg.lr, total, warmup, mesh)
    feats = place_features(cfg, data, "cpu")[0]
    graph = data.graph.to_torch("cpu")
    losses = [step(torch.as_tensor(links), torch.as_tensor(valid), feats,
                   graph, 0, deterministic=True)[0].item()
              for links, valid in batches]
    return {"losses": losses, "params": _numpy_state(model)}


# the feature tables' jobs: noise on, so that the statistics and the
# epoch's noisy tables are taken
TABLE_FLAGS = dict(add_noise=1, noise_ratio=0.3, mask_ratio=0.5)


def _table_record(t):
    """("shard", lo, hi, n, rows) of a ``RowShard``, ("whole", table) of a
    tensor, None of an absent table."""
    from snag_tpu_torch.parallel.mesh import RowShard
    if t is None:
        return None
    if isinstance(t, RowShard):
        return ("shard", t.lo, t.hi, t.n, t.local.numpy().copy())
    return ("whole", t.numpy().copy())


def _encode(model, feats, graph, rows, gen):
    """The encoder outputs of ``model`` (any family) over entities
    ``rows`` (None: every entity), dropout from ``gen``."""
    name = model.cfg.model_name
    if name == "MSNEA":
        # every entity: this rank's share of them, as joint_emb reads it
        return model._emb_generate(feats, slice(*model.mesh.rows(
            model.ent_num)) if rows is None else rows)[0]
    if name == "EVA":
        return model._embs(feats, graph, None, gen, rows)
    return tuple(model.multimodal_encoder(feats, graph, None, gen, rows=rows))


def tables_job(data_root, mesh_shape="", **overrides):
    """The runner's placement of the feature tables: each table (its
    share or the whole), the noise statistics, epoch 0's noisy tables,
    and, with a mesh, whether one batch's encoder outputs (and those over
    every entity, and ``joint_emb``) are bit for bit equal from this
    rank's shares and from whole tables given to the same model."""
    from snag_tpu_torch.models.encoder import batch_rows, place_features
    from snag_tpu_torch.train.runner import Runner
    from snag_tpu_torch.train.step import make_noise_fn
    from snag_tpu_torch.utils.logging import create_logger
    cfg = port_config(data_root, mesh_shape=mesh_shape,
                      **{**overrides, **TABLE_FLAGS})
    runner = Runner(cfg, create_logger(name=f"tables_{mesh_shape or 'one'}"))
    noisy = make_noise_fn(runner.cfg, runner.stats)(runner.feats, 0)
    out = {"tables": {k: _table_record(t)
                      for k, t in runner.feats._asdict().items()},
           "noisy": {k: _table_record(getattr(noisy, k))
                     for k in ("img", "rel", "att")},
           "stats": {k: (st.mean.numpy().copy(), st.std.numpy().copy())
                     for k, st in runner.stats._asdict().items()}}
    if runner.mesh is None or runner.mesh.world == 1:
        return out
    whole = place_features(runner.cfg, runner.data, runner.device)[0]
    links = torch.as_tensor(runner.train_ill[:BATCH_ROWS].astype(np.int64))
    rows = batch_rows(links)[0]
    same = {}
    model = runner.model
    with torch.no_grad():
        for label, r in (("batch", rows), ("all", None)):
            got, want = (_encode(model, f, runner.graph, r,
                                 torch.Generator().manual_seed(5))
                         for f in (runner.feats, whole))
            same[label] = [a is None and b is None or torch.equal(a, b)
                           for a, b in zip(got, want)]
        got, want = (model.joint_emb(f, runner.graph) for f in
                     (runner.feats, whole))
        same["joint_emb"] = [a is None and b is None or torch.equal(a, b)
                             for a, b in zip(got, want)]
    out["same"] = same
    return out


# a batch of the tables job: 24 links, 48 rows
BATCH_ROWS = 24
# take_rows's whole tables: 1,001 rows, so that no N of 2, 3 or 4 divides
# it and the last share is short
TAKE_N = 1001


def take_wholes():
    """Two tables of one entity count, of other dtypes and shapes: their
    rows cross in one exchange, as bytes."""
    rng = np.random.default_rng(11)
    return [rng.normal(size=(TAKE_N, 7)).astype(np.float32),
            rng.normal(size=(TAKE_N, 2, 3))]


def take_cases(rank, world):
    """Each case's ids on ``rank``: repeated ids, int32 ids, a rank that
    asks for nothing, every id on one owner (the first, and the last,
    short share), ids of two dimensions, and every rank asking for
    nothing."""
    rng = np.random.default_rng(rank)
    per = -(-TAKE_N // world)
    last = (world - 1) * per
    return {
        "repeats": rng.integers(0, TAKE_N, 300),
        "int32": np.array([5, 5, 1000, 0, 1000, 5], dtype=np.int32),
        "one_empty": (np.zeros(0, np.int64) if rank == 1
                      else rng.integers(0, TAKE_N, 40)),
        "owner_first": rng.integers(0, per, 60),
        "owner_last": rng.integers(last, TAKE_N, 60),
        "two_dims": rng.integers(0, TAKE_N, (5, 8)),
        "all_empty": np.zeros(0, np.int64),
    }


def take_job():
    """``take_rows`` of both ``take_wholes`` tables on this rank's
    ``take_cases``: each case's rows of each table and whether they were
    contiguous, one call a case, then every case in one call (under
    "each"), then whether an id out of range on rank 0 alone raised
    here."""
    from snag_tpu_torch.parallel import mesh as mesh_mod
    import torch.distributed as dist
    mesh = mesh_mod.make_mesh(dist.get_world_size(), "cpu")
    shards = [mesh_mod.shard_table(mesh, torch.from_numpy(w))
              for w in take_wholes()]
    out = {"span": (shards[0].lo, shards[0].hi, shards[0].n), "each": {}}

    def record(got):
        return [(g.numpy().copy(), g.is_contiguous()) for g in got]
    cases = take_cases(mesh.rank, mesh.world)
    for name, ids in cases.items():
        got, = mesh_mod.take_rows(mesh, shards, [torch.from_numpy(ids)])
        out[name] = record(got)
    every = mesh_mod.take_rows(mesh, shards,
                               [torch.from_numpy(i) for i in cases.values()])
    out["each"] = {name: record(got) for name, got in zip(cases, every)}
    bad = torch.tensor([TAKE_N if mesh.rank == 0 else 3])
    try:
        mesh_mod.take_rows(mesh, shards, [bad])
        out["raised"] = False
    except IndexError:
        out["raised"] = True
    return out


def eval_embs(n=601, d=48, seed=0):
    """``tests/test_sharded_eval.py::_embs``, in numpy."""
    rng = np.random.default_rng(seed)
    l = rng.normal(size=(n, d)).astype(np.float32)
    r = l + 0.6 * rng.normal(size=(n, d)).astype(np.float32)
    l /= np.linalg.norm(l, axis=1, keepdims=True)
    r /= np.linalg.norm(r, axis=1, keepdims=True)
    return l, r


def eval_job(use_csls, csls_k=3):
    """The sharded evaluation of ``eval_embs()`` over the group."""
    from snag_tpu_torch.eval.sharded import sharded_full_rank_eval
    from snag_tpu_torch.parallel import mesh as mesh_mod
    import torch.distributed as dist
    mesh = mesh_mod.make_mesh(dist.get_world_size(), "cpu")
    l, r = (torch.from_numpy(a) for a in eval_embs())
    return sharded_full_rank_eval(mesh, l, r, csls_k=csls_k,
                                  use_csls=use_csls)


def mine_inputs(n_left, n_ent=1500, n_right=500):
    """``tests/test_sharded_eval.py::test_sharded_mining_matches_chunked``'s
    inputs, in numpy."""
    rng = np.random.default_rng(3)
    emb = rng.normal(size=(n_ent, 32)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    left = rng.choice(n_ent, size=n_left, replace=False)
    right = rng.choice(n_ent, size=n_right, replace=False)
    lval = rng.random(n_left) > 0.1
    rval = rng.random(n_right) > 0.1
    return emb, left, lval, right, rval


def mine_job(n_left, chunk=128):
    """Both argmins of ``mine_inputs(n_left)``, left candidates split over
    the group."""
    from snag_tpu_torch.parallel import mesh as mesh_mod
    from snag_tpu_torch.train.il import _mutual_argmins_sharded
    import torch.distributed as dist
    mesh = mesh_mod.make_mesh(dist.get_world_size(), "cpu")
    emb, left, lval, right, rval = (torch.from_numpy(np.asarray(a))
                                    for a in mine_inputs(n_left))
    pl, pr = _mutual_argmins_sharded(mesh, emb, left, lval, right, rval,
                                     chunk)
    return pl.numpy(), pr.numpy()


MKGC_BASE = dict(data_choice="SYNTH", emb_dim=32, num_batch=8, neg_num=8,
                 margin=1.0, lr=5e-3, lrg=5e-3, epoch=2, eval_epoch=100,
                 add_noise=1, use_pool=1, pool_dim=32, num_hidden_layers=1,
                 num_attention_heads=2, synth_ents=80, synth_rels=8,
                 synth_triples=600, random_seed=7, log_every=1000,
                 joint_way="Mformer_hd_mean", device="cpu")


def mkgc_job(data_path, epochs=2, mesh_shape="", batch_size=None,
             **overrides):
    """``epochs`` MKGC epochs (``tests/test_mesh_runner.py``'s geometry),
    then the filtered valid ranks through the runner's evaluator and
    through the one-rank evaluator on the same params."""
    from snag_tpu_torch.mkgc.config import MKGCConfig
    from snag_tpu_torch.mkgc.train import (MKGCRunner, filtered_ranks,
                                           make_score_fn)
    from snag_tpu_torch.utils.logging import create_logger
    cfg = MKGCConfig(**{**MKGC_BASE, "data_path": data_path,
                        "mesh_shape": mesh_shape, **overrides})
    runner = MKGCRunner(cfg, create_logger(name="mkgc_mesh"))
    if batch_size is not None:
        runner.batch_size = batch_size
    losses = [runner.train_epoch(e) for e in range(epochs)]
    triples = runner.data.valid
    ranks = filtered_ranks(runner.model, runner.feats, runner.data, triples,
                           score_fn=runner._score_fn)
    ranks1 = filtered_ranks(runner.model, runner.feats, runner.data, triples,
                            score_fn=make_score_fn(runner.model))
    out = {"losses": losses, "batch_size": runner.batch_size,
           "params": _numpy_state(runner.model), "ranks": ranks,
           "ranks_one": ranks1,
           "tables": [_table_record(t)[:4] for t in runner.feats]}
    # one step more, after the record: the bytes its loss keeps alive
    loss = runner.step(runner.train_triples[:runner.batch_size],
                       runner.feats)[0]
    out["loss_bytes"] = loss.untyped_storage().nbytes()
    return out


def cli_job(argv):
    """``cli.train_mmea.main`` on this rank."""
    from snag_tpu_torch.cli.train_mmea import main
    runner = main(argv)
    return {"losses": list(runner.loss_log.loss),
            "mrr": runner.last_result.mrr_l2r}


def fail_on_rank(rank):
    """Rank ``rank`` raises; every other waits at a barrier for it."""
    import torch.distributed as dist
    if dist.get_rank() == rank:
        raise RuntimeError(f"rank {rank} fails")
    dist.barrier()


JOBS = {"runner": runner_job, "step": step_job, "eval": eval_job,
        "mine": mine_job, "mkgc": mkgc_job, "cli": cli_job,
        "tables": tables_job, "take": take_job}
