"""MKGC under ``--mesh_shape data:N`` in the port, on the CPU over gloo
(spawned ranks of ``torch_mesh_ranks.py``, no JAX in them).

``tests/test_mesh_runner.py::test_mkgc_runner_mesh_matches_single_device``'s
contract: two epochs at N = 2 against one rank with the same (rounded
down) batch size, epoch losses within rel 5e-3 (and the parameters
within rtol 2e-3, atol 2e-5, but for the attention's key bias, whose
gradient is rounding noise), in both negative branches; the sharded filtered
ranks equal to the unsharded ones on > 0.99 of the triples.  ``data:1``
through the CLI gives the plain run's bits.  Each rank holds its share
of both feature tables.
"""

import numpy as np
import pytest
import torch

import torch_mesh_ranks as ranks
from snag_tpu_torch.parallel import mesh as mesh_mod
from torch_port_common import single_thread

single_thread()

# the all-entity fusion branch (batches of 60) and the role-mixed one
# (batches of 6 with two projection stacks)
BRANCHES = {"all_entity": {},
            "role_mixed": dict(num_batch=64, num_proj=2,
                               joint_way="Mformer_hd_graph")}


@pytest.fixture(scope="module")
def data_path(tmp_path_factory):
    return str(tmp_path_factory.mktemp("mkgc_mesh"))


@pytest.fixture(scope="module")
def two_ranks(data_path, tmp_path_factory):
    out = tmp_path_factory.mktemp("mkgc_ranks2")
    jobs = [(name, "mkgc", dict(data_path=data_path, mesh_shape="data:2",
                                **flags))
            for name, flags in BRANCHES.items()]
    mesh_mod.spawn(2, ranks.run, (jobs, str(out)), backend="gloo",
                   device="cpu")
    return str(out)


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_mkgc_two_ranks_match_one(branch, data_path, two_ranks):
    got = ranks.load(two_ranks, branch, 2)
    assert got[0]["losses"] == got[1]["losses"]
    got = got[0]
    assert got["batch_size"] % 2 == 0
    want = ranks.mkgc_job(data_path, batch_size=got["batch_size"],
                          **BRANCHES[branch])
    ent = 80
    fused_all = got["batch_size"] * (8 + 2) > 2 * ent
    assert fused_all == (branch == "all_entity")
    for e, (a, b) in enumerate(zip(got["losses"], want["losses"])):
        assert abs(a - b) / max(abs(b), 1e-9) <= 5e-3, (e, a, b)
    for k, v in want["params"].items():
        if k.endswith("attention.self.key.bias"):
            # its gradient is zero in exact arithmetic (a bias on every key
            # moves a query's scores alike), and Adam turns the rounding
            # noise left in it into steps of LR size and either sign
            continue
        np.testing.assert_allclose(got["params"][k], v, rtol=2e-3, atol=2e-5,
                                   err_msg=k)


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_mkgc_sharded_filtered_ranks(branch, two_ranks):
    """The chunk-split evaluator against the one-rank evaluator on the
    same trained params, on every rank."""
    for got in ranks.load(two_ranks, branch, 2):
        assert got["ranks"].shape == got["ranks_one"].shape
        assert (got["ranks"] == got["ranks_one"]).mean() > 0.99


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_mkgc_ranks_hold_shares_of_the_tables(branch, two_ranks):
    """Each rank holds its ``Mesh.rows`` share of ``visual`` and
    ``textual``, not the whole table."""
    for r, got in enumerate(ranks.load(two_ranks, branch, 2)):
        for kind, lo, hi, n in got["tables"]:
            assert kind == "shard" and n == 80
            assert (lo, hi) == mesh_mod.Mesh(r, 2, torch.device("cpu"),
                                             True).rows(n)


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_mkgc_step_loss_keeps_no_bucket(branch, two_ranks):
    """A step's loss, which the epoch keeps, holds its own 4 bytes, not
    the step's reduced gradient bucket that it was averaged in."""
    for got in ranks.load(two_ranks, branch, 2):
        assert got["loss_bytes"] == 4


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_mkgc_batch_rounds_down(branch, data_path, two_ranks):
    """The mesh's batch is the one-rank batch rounded down to a multiple
    of N, never below N (JAX train.py:409-414)."""
    one = ranks.mkgc_job(data_path, epochs=0, **BRANCHES[branch])
    got = ranks.load(two_ranks, branch, 2)[0]
    assert got["batch_size"] == max(2, one["batch_size"] // 2 * 2)


def test_mkgc_cli_data1_is_the_plain_path_bitwise(tmp_path):
    from snag_tpu_torch.cli.train_mkgc import main
    import torch.distributed as dist
    argv = ["--data_choice", "SYNTH", "--emb_dim", "32", "--num_batch", "8",
            "--neg_num", "8", "--margin", "1.0", "--lr", "5e-3", "--lrg",
            "5e-3", "--epoch", "3", "--eval_epoch", "2", "--pool_dim", "32",
            "--synth_ents", "80", "--synth_rels", "8", "--synth_triples",
            "600", "--random_seed", "7", "--log_every", "1000", "--device",
            "cpu"]
    plain = main(argv + ["--data_path", str(tmp_path / "plain")])
    one = main(argv + ["--data_path", str(tmp_path / "one"),
                       "--mesh_shape", "data:1"])
    assert not dist.is_initialized()
    assert one.mesh is not None and one.mesh.world == 1
    assert one.losses == plain.losses
    assert one.last_metrics == plain.last_metrics
    for k, v in plain.model.state_dict().items():
        assert torch.equal(one.model.state_dict()[k], v), k
