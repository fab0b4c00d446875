"""``--mesh_shape data:N`` in the port (``snag_tpu_torch/parallel``) on
the CPU, N ranks over gloo, each a spawned process with one intra-op
thread that imports no JAX (``torch_mesh_ranks.py``).

Held against the JAX package's own mesh contract: N ranks give the
results of one (``tests/test_mesh_runner.py``: epoch losses within
rel 5e-3, MEAformer's replay buffers equal; ``tests/test_sharding.py``:
a step's losses rtol 1e-4, parameters rtol 2e-3 and atol 2e-5), and
against the JAX mesh itself on the 8 virtual CPU devices of
``conftest.py``: three sharded optimizer steps, the sharded evaluation
(ranks equal on >= 0.995 of queries, MRR within 1e-3 both ways) and the
sharded mining (exactly equal).  ``data:1`` gives the plain path's bits.

The feature tables: under N > 1 ranks each rank holds its ``Mesh.rows``
share of every table, whose noise statistics and epoch-0 noisy rows are
the one-rank run's bit for bit; ``take_rows`` gives ``whole[idx]`` bit
for bit at N = 2, 3 and 4; and within a rank every family's encoder
outputs are the same bits from the shares as from whole tables.
The MKGC cases are in ``test_torch_mesh_mkgc.py``.
"""

import dataclasses
import os
import os.path as osp
import socket
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_mesh_ranks as ranks
from snag_tpu_torch.parallel import mesh as mesh_mod
from snag_tpu_torch.parallel.mesh import discover_distributed_env
from torch_port_common import model_pair, padded_batch, single_thread

single_thread()

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))

# each runner case: the family, its flags, the epochs it trains; "snag"
# has all six modalities (an exactly-zero gradient would let Adam turn
# rounding noise into steps of either sign) and is also evaluated and
# mined with the trained model
CASES = {
    "snag": dict(model_name="SNAG", use_surface=1, inner_view_num=6,
                 epochs=2, evaluate=True, mine=True),
    "snag_dropout": dict(model_name="SNAG", dropout=0.1, epochs=2),
    "replay": dict(model_name="MEAformer", replay=1, tau2=4.0, epochs=3),
    "msnea": dict(model_name="MSNEA", epochs=2),
    "eva": dict(model_name="EVA", structure_encoder="gcn", epochs=2),
    "mclea": dict(model_name="MCLEA", tau2=4.0, epochs=2),
}
RANKS = {2: ("snag", "snag_dropout", "replay", "msnea", "eva", "mclea"),
         4: ("snag", "replay", "msnea")}
BATCH = 16
# three steps of the JAX package's optimizer (tests/test_torch_train.py)
STEPS, WARMUP = 20, 3
STEP_BATCHES = ((0, 24), (5, 24), (11, 17))
STEP_FLAGS = dict(fused_snag_loss=0, lr=5e-4, scheduler="cos",
                  use_surface=1)


# -- discovery and rendezvous (tests/test_multihost.py's cases) ------------
def test_discovery_single_process():
    assert discover_distributed_env({}) == (None, None, None)


def test_discovery_jax_env():
    env = {"JAX_COORDINATOR_ADDRESS": "10.0.0.1:1234",
           "JAX_NUM_PROCESSES": "4", "JAX_PROCESS_ID": "2"}
    assert discover_distributed_env(env) == ("10.0.0.1:1234", 4, 2)
    assert discover_distributed_env(
        {"JAX_COORDINATOR_ADDRESS": "10.0.0.1:1234"}) == \
        ("10.0.0.1:1234", None, None)


def test_discovery_torchrun_env():
    env = {"RANK": "1", "WORLD_SIZE": "2", "MASTER_ADDR": "host0",
           "MASTER_PORT": "29500"}
    assert discover_distributed_env(env) == ("host0:29500", 2, 1)


def test_discovery_slurm_env():
    env = {"SLURM_PROCID": "3", "SLURM_NTASKS": "8",
           "SLURM_NODELIST": "node[01-04],node07", "MASTER_PORT": "4321"}
    addr, n, pid = discover_distributed_env(env)
    assert addr == "node:4321" and n == 8 and pid == 3


def test_parse_mesh_shape():
    assert mesh_mod.parse_mesh_shape("data:8") == 8
    assert mesh_mod.parse_mesh_shape("8") == 8
    assert mesh_mod.parse_mesh_shape("") == 0
    with pytest.raises(ValueError):
        mesh_mod.parse_mesh_shape("model:4")


def test_rows_split_like_jax():
    """ceil(n / N) rows a rank, the last shares short or empty."""
    spans = [mesh_mod.Mesh(r, 4, torch.device("cpu"), True).rows(601)
             for r in range(4)]
    assert spans == [(0, 151), (151, 302), (302, 453), (453, 601)]
    assert [mesh_mod.Mesh(r, 4, torch.device("cpu"), True).rows(5)
            for r in range(4)] == [(0, 2), (2, 4), (4, 5), (5, 5)]


def test_mesh_above_the_group_raises():
    """A process in no group is one rank: data:2 wants a group of two; a
    run over NCCL wants a card a rank."""
    with pytest.raises(ValueError, match="needs 2 processes"):
        mesh_mod.make_mesh(2, "cpu")
    assert mesh_mod.make_mesh(1, "cpu").world == 1
    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match="NCCL"):
            mesh_mod.spawn(2, print, device="cuda")


def test_a_failing_rank_fails_the_launch():
    """A rank that raises ends the spawn with its error while the other
    waits in a collective for it: no hang."""
    with pytest.raises(Exception, match="rank 1 fails"):
        mesh_mod.spawn(2, ranks.fail_on_rank, (1,), backend="gloo",
                       device="cpu")


_ENV_CHILD = textwrap.dedent("""
    import os, sys
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from snag_tpu_torch.parallel.mesh import (initialize_distributed,
                                              is_main_process, make_mesh)
    assert initialize_distributed(device="cpu")   # RANK/WORLD_SIZE/MASTER_*
    rank = dist.get_rank()
    assert rank == int(os.environ["RANK"]) and dist.get_world_size() == 2
    assert dist.get_backend() == "gloo"
    assert is_main_process() == (rank == 0)
    mesh = make_mesh(2, "cpu")
    x = torch.tensor([rank + 1.0])
    assert mesh.all_reduce_sum_(x).tolist() == [3.0]
    assert mesh.all_gather(torch.tensor([[rank]])).flatten().tolist() == [0, 1]
    try:
        make_mesh(3, "cpu")
        raise AssertionError("data:3 in a group of 2 did not raise")
    except ValueError:
        pass
    assert "jax" not in sys.modules
    dist.destroy_process_group()
    print(f"child {rank} OK")
""")


def test_two_process_env_rendezvous():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(2):
        env = dict(os.environ)
        env.update({"RANK": str(rank), "WORLD_SIZE": "2",
                    "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)})
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _ENV_CHILD], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = [p.communicate(timeout=240)[0] for p in procs]
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-3000:]}"
        assert f"child {rank} OK" in out


# -- the spawned ranks -----------------------------------------------------
@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    return str(tmp_path_factory.mktemp("mesh_data"))


@pytest.fixture(scope="module")
def step_pair(data_root):
    """The SNAG pair of ``tests/test_torch_train.py`` (six modalities),
    its port state dict saved for the ranks, and its three batches."""
    pair = model_pair(data_root, **STEP_FLAGS)
    path = osp.join(data_root, "step_state.pt")
    torch.save(pair["tmodel"].state_dict(), path)
    batches = [padded_batch(pair["tdata"].train_ill[k:], 24, n)
               for k, n in STEP_BATCHES]
    return pair, path, batches


def _spawn(world, jobs, out_dir):
    mesh_mod.spawn(world, ranks.run, (jobs, str(out_dir)), backend="gloo",
                   device="cpu")
    return str(out_dir)


def _runner_kw(data_root, case, mesh_shape=""):
    return dict(data_root=data_root, batch_size=BATCH,
                mesh_shape=mesh_shape, **CASES[case])


@pytest.fixture(scope="module")
def two_ranks(data_root, step_pair, tmp_path_factory):
    """One group of 2 ranks runs every N = 2 job."""
    _, state_path, batches = step_pair
    jobs = [(case, "runner", _runner_kw(data_root, case, "data:2"))
            for case in RANKS[2]]
    jobs.append(("step", "step", dict(state_path=state_path,
                                      data_root=data_root, batches=batches,
                                      total=STEPS, warmup=WARMUP,
                                      mesh_shape="data:2", **STEP_FLAGS)))
    jobs += [(f"eval_{c}", "eval", dict(use_csls=c)) for c in (0, 1)]
    jobs += [(f"mine_{n}", "mine", dict(n_left=n)) for n in (512, 601)]
    jobs += _table_jobs(data_root, 2)
    return _spawn(2, jobs, tmp_path_factory.mktemp("ranks2"))


@pytest.fixture(scope="module")
def three_ranks(tmp_path_factory):
    return _spawn(3, [("take", "take", {})],
                  tmp_path_factory.mktemp("ranks3"))


@pytest.fixture(scope="module")
def four_ranks(data_root, tmp_path_factory):
    jobs = [(case, "runner", _runner_kw(data_root, case, "data:4"))
            for case in RANKS[4]]
    jobs += _table_jobs(data_root, 4)
    return _spawn(4, jobs, tmp_path_factory.mktemp("ranks4"))


def _tables_kw(data_root, case, mesh_shape=""):
    flags = {k: v for k, v in CASES[case].items()
             if k not in ("epochs", "evaluate", "mine")}
    return dict(data_root=data_root, batch_size=BATCH,
                mesh_shape=mesh_shape, **flags)


def _table_jobs(data_root, world):
    """``take_rows``'s cases and the tables of every family of
    ``RANKS[world]``."""
    return [("take", "take", {})] + [
        (f"tables_{case}", "tables",
         _tables_kw(data_root, case, f"data:{world}"))
        for case in RANKS[world]]


_ONE_RANK = {}


def _one_rank(data_root, case):
    if case not in _ONE_RANK:
        _ONE_RANK[case] = ranks.runner_job(**_runner_kw(data_root, case))
    return _ONE_RANK[case]


@pytest.mark.parametrize("world,case", [(w, c) for w in RANKS
                                        for c in RANKS[w]])
def test_runner_epochs_match_one_rank(world, case, data_root, two_ranks,
                                      four_ranks):
    got = ranks.load(two_ranks if world == 2 else four_ranks, case, world)
    want = _one_rank(data_root, case)
    # the loss and the state are replicated: every rank holds the same
    for other in got[1:]:
        assert other["losses"] == got[0]["losses"]
        for k, v in got[0]["params"].items():
            np.testing.assert_array_equal(other["params"][k], v, err_msg=k)
    got = got[0]
    assert got["batch_size"] == want["batch_size"] == BATCH
    for e, (a, b) in enumerate(zip(got["losses"], want["losses"])):
        assert abs(a - b) / max(abs(b), 1e-9) <= 5e-3, (e, a, b)
    for k, v in want["params"].items():
        np.testing.assert_allclose(got["params"][k], v, rtol=2e-3, atol=2e-5,
                                   err_msg=k)
    assert len(got["replay"]) == len(want["replay"])
    for a, b in zip(got["replay"], want["replay"]):
        np.testing.assert_array_equal(a, b)
    if case == "replay":
        assert (want["replay"][-1] >= 0).any()


def test_runner_eval_and_mining_match_one_rank(data_root, two_ranks):
    """The trained SNAG's sharded ``--distance 2`` evaluation and one
    fresh mining round, through the runner, against one rank's."""
    got = ranks.load(two_ranks, "snag", 2)
    want = _one_rank(data_root, "snag")
    for g in got:
        assert (g["eval"][0] == want["eval"][0]).mean() >= 0.995
        assert abs(g["eval"][1] - want["eval"][1]) < 1e-3
        assert abs(g["eval"][2] - want["eval"][2]) < 1e-3
        assert (g["eval"][3][:, 0] == want["eval"][3][:, 0]).mean() >= 0.995
        np.testing.assert_array_equal(g["mine"], want["mine"])
    assert (want["mine"] >= 0).any()


def test_sharded_steps_match_jax_mesh(step_pair, two_ranks):
    """Three optimizer steps, noise and dropout off: the port at N = 2
    against the same jitted JAX step with the batch, the feature tables
    and the edges sharded over the 8-device mesh (``test_sharding.py``'s
    placement)."""
    from snag_tpu.models import build_model as jax_build_model
    from snag_tpu.parallel.mesh import (batch_sharding, entity_sharding,
                                        make_mesh, replicated)
    from snag_tpu.train.optim import build_optimizer as jax_build_optimizer
    from snag_tpu_torch.utils.import_reference import state_dict_from_flax
    pair, _, batches = step_pair
    assert len(jax.devices()) == 8, "conftest must provide 8 CPU devices"
    jcfg = pair["jcfg"]
    model = jax_build_model(jcfg, pair["jdata"])
    mesh = make_mesh(8)
    rep, ent2, ent1 = (replicated(mesh), entity_sharding(mesh, 2),
                       entity_sharding(mesh, 1))
    params = jax.device_put(jax.tree_util.tree_map(jnp.asarray,
                                                   pair["params"]), rep)
    tx, _ = jax_build_optimizer(jcfg, params, STEPS, WARMUP)
    opt_state = jax.device_put(tx.init(params), rep)
    feats = type(pair["jfeats"])(*[None if f is None else
                                   jax.device_put(f, ent2)
                                   for f in pair["jfeats"]])
    g = pair["jdata"].graph
    graph = dataclasses.replace(
        g, row=jax.device_put(jnp.asarray(g.row), ent1),
        col=jax.device_put(jnp.asarray(g.col), ent1),
        w=jax.device_put(jnp.asarray(g.w), ent1),
        mask=jax.device_put(jnp.asarray(g.mask), ent1))

    @jax.jit
    def jstep(p, s, links, valid, feats, graph):
        def f(q):
            return model.apply({"params": q}, links, valid, feats, graph,
                               deterministic=True)
        (loss, _), grads = jax.value_and_grad(f, has_aux=True)(p)
        upd, s = tx.update(grads, s, p)
        return optax.apply_updates(p, upd), s, loss

    want_losses = []
    for links, valid in batches:
        params, opt_state, loss = jstep(
            params, opt_state,
            jax.device_put(jnp.asarray(links), batch_sharding(mesh, 2)),
            jax.device_put(jnp.asarray(valid), batch_sharding(mesh, 1)),
            feats, graph)
        want_losses.append(float(loss))
    want = state_dict_from_flax(jax.device_get(params))
    for got in ranks.load(two_ranks, "step", 2):
        np.testing.assert_allclose(got["losses"], want_losses, rtol=1e-4)
        for k, v in want.items():
            np.testing.assert_allclose(got["params"][k], v.numpy(),
                                       rtol=2e-3, atol=2e-5, err_msg=k)


@pytest.mark.parametrize("use_csls", [False, True])
def test_sharded_eval_matches_jax_mesh(use_csls, two_ranks):
    """``tests/test_sharded_eval.py``'s case: 601 pairs (601 % 2 and
    601 % 8 leave a short last share), CSLS k = 3."""
    from snag_tpu.eval.sharded import sharded_full_rank_eval
    from snag_tpu.parallel.mesh import make_mesh
    l, r = ranks.eval_embs()
    want_l, want_r, want_top3 = sharded_full_rank_eval(
        make_mesh(8), jnp.asarray(l), jnp.asarray(r), csls_k=3,
        use_csls=use_csls)
    for got_l, got_r, top3 in ranks.load(two_ranks, f"eval_{int(use_csls)}",
                                         2):
        assert (got_l == want_l).mean() >= 0.995
        assert (got_r == want_r).mean() >= 0.995
        for got, want in ((got_l, want_l), (got_r, want_r)):
            mrr, want_mrr = (float((1.0 / (x + 1)).mean())
                             for x in (got, want))
            assert abs(mrr - want_mrr) < 1e-3
        assert (top3[:, 0] == np.asarray(want_top3)[:, 0]).mean() >= 0.995


@pytest.mark.parametrize("n_left", [512, 601])
def test_sharded_mining_matches_jax_mesh(n_left, two_ranks):
    """Both argmins exactly, the first occurrence winning ties, at an
    even and an uneven split."""
    from snag_tpu.parallel.mesh import make_mesh
    from snag_tpu.train.il import _mutual_argmins_sharded
    emb, left, lval, right, rval = (jnp.asarray(a) for a in
                                    ranks.mine_inputs(n_left))
    want_l, want_r = _mutual_argmins_sharded(make_mesh(8), emb, left, lval,
                                             right, rval, chunk=128)
    for got_l, got_r in ranks.load(two_ranks, f"mine_{n_left}", 2):
        np.testing.assert_array_equal(got_l, np.asarray(want_l))
        np.testing.assert_array_equal(got_r, np.asarray(want_r))


# -- the feature tables ----------------------------------------------------
def _ranks_dir(world, two_ranks, three_ranks, four_ranks):
    return {2: two_ranks, 3: three_ranks, 4: four_ranks}[world]


@pytest.mark.parametrize("world", [2, 3, 4])
def test_take_rows_is_whole_rows(world, two_ranks, three_ranks, four_ranks):
    """Every case of ``take_cases`` on every rank, of both tables, one
    call a case and every case in one call: bit for bit ``whole[idx]``,
    its shape and dtype, contiguous; an id out of range on one rank
    raises on all."""
    wholes = ranks.take_wholes()
    got = ranks.load(_ranks_dir(world, two_ranks, three_ranks, four_ranks),
                     "take", world)
    for r, rec in enumerate(got):
        lo, hi, n = rec["span"]
        assert (lo, hi) == mesh_mod.Mesh(r, world, torch.device("cpu"),
                                         True).rows(n) and n == ranks.TAKE_N
        for name, ids in ranks.take_cases(r, world).items():
            for got in (rec[name], rec["each"][name]):
                for (rows, contiguous), whole in zip(got, wholes, strict=True):
                    want = whole[ids]
                    assert contiguous, (r, name)
                    assert (rows.shape == want.shape
                            and rows.dtype == want.dtype)
                    np.testing.assert_array_equal(rows, want,
                                                  err_msg=f"{r} {name}")
        assert rec["raised"], r


def _one_rank_tables(data_root, case):
    key = ("tables", case)
    if key not in _ONE_RANK:
        _ONE_RANK[key] = ranks.tables_job(**_tables_kw(data_root, case))
    return _ONE_RANK[key]


TABLE_CASES = [(w, c) for w in RANKS for c in RANKS[w]]


def _tables(world, case, two_ranks, four_ranks):
    return ranks.load(two_ranks if world == 2 else four_ranks,
                      f"tables_{case}", world)


@pytest.mark.parametrize("world,case", TABLE_CASES)
def test_rank_holds_its_share_of_each_table(world, case, data_root,
                                            two_ranks, four_ranks):
    """Each rank holds rows ``Mesh.rows(n)`` of every table, the one-rank
    run's bit for bit, and no whole table."""
    want = _one_rank_tables(data_root, case)["tables"]
    for r, rec in enumerate(_tables(world, case, two_ranks, four_ranks)):
        assert rec["tables"].keys() == want.keys()
        for name, w in want.items():
            got = rec["tables"][name]
            if w is None:
                assert got is None, name
                continue
            kind, lo, hi, n, rows = got
            assert w[0] == "whole" and kind == "shard", name
            assert n == w[1].shape[0] and hi - lo < n
            assert (lo, hi) == mesh_mod.Mesh(r, world, torch.device("cpu"),
                                             True).rows(n)
            np.testing.assert_array_equal(rows, w[1][lo:hi], err_msg=name)


@pytest.mark.parametrize("world,case", TABLE_CASES)
def test_rank_noise_is_rows_of_the_plain_noise(world, case, data_root,
                                               two_ranks, four_ranks):
    """The noise statistics are the whole tables' and epoch 0's noisy
    shares are rows ``lo:hi`` of the one-rank run's noisy tables, bit for
    bit."""
    want = _one_rank_tables(data_root, case)
    for rec in _tables(world, case, two_ranks, four_ranks):
        for name, (mean, std) in want["stats"].items():
            np.testing.assert_array_equal(rec["stats"][name][0], mean)
            np.testing.assert_array_equal(rec["stats"][name][1], std)
        for name, w in want["noisy"].items():
            kind, lo, hi, _, rows = rec["noisy"][name]
            assert kind == "shard"
            np.testing.assert_array_equal(rows, w[1][lo:hi], err_msg=name)
        # the noise moved some rows of this share
        assert any((rec["noisy"][k][4] != rec["tables"][k][4]).any()
                   for k in want["noisy"])


@pytest.mark.parametrize("world,case", TABLE_CASES)
def test_shares_encode_as_whole_tables(world, case, two_ranks, four_ranks):
    """Within a rank, one batch's encoder outputs, those over every
    entity and ``joint_emb`` are bit for bit the same from the rank's
    shares as from whole tables given to the same model."""
    for rec in _tables(world, case, two_ranks, four_ranks):
        for label, same in rec["same"].items():
            assert same and all(same), (label, same)


def test_data1_holds_whole_tables(data_root):
    """``data:1`` keeps every table whole, with the plain run's bits, its
    statistics and its noise."""
    want = _one_rank_tables(data_root, "snag")
    got = ranks.tables_job(**_tables_kw(data_root, "snag", "data:1"))
    for name, w in want["tables"].items():
        assert (got["tables"][name] is None) == (w is None)
        if w is not None:
            assert got["tables"][name][0] == "whole"
            np.testing.assert_array_equal(got["tables"][name][1], w[1])
    for name, w in want["noisy"].items():
        np.testing.assert_array_equal(got["noisy"][name][1], w[1])
    for name, (mean, std) in want["stats"].items():
        np.testing.assert_array_equal(got["stats"][name][0], mean)
        np.testing.assert_array_equal(got["stats"][name][1], std)


def test_a_share_is_no_tensor():
    """A ``RowShard`` cannot be indexed as if it were whole, its own rows
    are read only through its own span, and a forward without a mesh
    refuses it."""
    whole = torch.arange(30.0).reshape(10, 3)
    mesh = mesh_mod.Mesh(1, 3, torch.device("cpu"), True)
    shard = mesh_mod.shard_table(mesh, whole)
    assert (shard.lo, shard.hi, shard.n) == (4, 8, 10)
    assert shard.shape == (10, 3) and shard.dtype == whole.dtype
    assert torch.equal(shard.local, whole[4:8])
    assert mesh_mod.shard_table(None, whole) is whole
    assert mesh_mod.shard_table(mesh_mod.Mesh(0, 1, torch.device("cpu"),
                                              True), whole) is whole
    with pytest.raises(TypeError):
        shard[torch.tensor([0, 1])]
    with pytest.raises(TypeError):
        torch.nn.functional.linear(shard, torch.ones(2, 3))
    own, absent, rows = mesh_mod.take(mesh, [shard, None, whole],
                                      slice(4, 8))
    assert own is shard.local and absent is None
    assert torch.equal(rows, whole[4:8])
    with pytest.raises(ValueError, match="rows 0:4"):
        mesh_mod.take(mesh, [shard], slice(0, 4))
    with pytest.raises(ValueError, match="no gradient"):
        mesh_mod.shard_table(mesh, whole.requires_grad_())


def test_noise_of_a_share_is_rows_of_the_whole_noise():
    """``noise_mask_table`` of a share draws at the whole table's shapes:
    its rows are those of the whole table's noise from the same seed."""
    from snag_tpu_torch.ops import noise as noise_ops
    whole = torch.from_numpy(np.random.default_rng(2).normal(
        size=(101, 6)).astype(np.float32))
    st = noise_ops.table_stats(whole)
    want = noise_ops.noise_mask_table(torch.Generator().manual_seed(9),
                                      whole, st, 0.4, 0.5)
    for r in range(3):
        shard = mesh_mod.shard_table(
            mesh_mod.Mesh(r, 3, torch.device("cpu"), True), whole)
        got = noise_ops.noise_mask_table(torch.Generator().manual_seed(9),
                                         shard, st, 0.4, 0.5)
        assert isinstance(got, mesh_mod.RowShard)
        assert (got.lo, got.hi, got.n) == (shard.lo, shard.hi, shard.n)
        assert torch.equal(got.local, want[shard.lo:shard.hi])
    assert not torch.equal(want, whole)


# -- the CLI ---------------------------------------------------------------
def _cli_argv(path, **extra):
    from torch_port_common import small_argv
    return small_argv(path, epoch=3, eval_epoch=2, batch_size=BATCH,
                      **extra)


def _pred_csv(path):
    pred = osp.join(path, "SNAG")
    found = [osp.join(dp, f) for dp, _, fs in os.walk(pred) for f in fs
             if f.endswith("_pred.txt")]
    assert found, f"no prediction CSV under {pred}"
    with open(sorted(found)[-1]) as f:
        return f.read()


def test_cli_data1_is_the_plain_path_bitwise(tmp_path):
    """``--mesh_shape data:1`` runs in a group of one (gloo on the CPU)
    and gives the plain run's bits: losses, weights and the CSV."""
    from snag_tpu_torch.cli.train_mmea import main
    import torch.distributed as dist
    plain = main(_cli_argv(tmp_path / "plain"))
    one = main(_cli_argv(tmp_path / "one", mesh_shape="data:1"))
    assert not dist.is_initialized()
    assert one.mesh is not None and one.mesh.world == 1
    assert one.loss_log.loss == plain.loss_log.loss
    for k, v in plain.model.state_dict().items():
        assert torch.equal(one.model.state_dict()[k], v), k
    assert _pred_csv(tmp_path / "one") == _pred_csv(tmp_path / "plain")


def test_cli_spawns_ranks(tmp_path):
    """Started plainly, ``--mesh_shape data:2 --device cpu`` spawns two
    ranks over gloo and returns None; rank 0 alone writes the CSV (the
    one-rank run's), rank 1 logs to ``train.log.rank1``."""
    from snag_tpu_torch.cli.train_mmea import main
    plain = main(_cli_argv(tmp_path / "plain"))
    assert main(_cli_argv(tmp_path / "two", mesh_shape="data:2")) is None
    assert _pred_csv(tmp_path / "two") == _pred_csv(tmp_path / "plain")
    logs = [f for _, _, fs in os.walk(tmp_path / "two") for f in fs]
    assert "train.log" in logs and "train.log.rank1" in logs
    assert plain.last_result is not None
