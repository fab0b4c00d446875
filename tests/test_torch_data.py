"""Port data layer vs the JAX package: the same seed must give the same
KG, bit for bit (synthetic generator, feature tables, edge list, splits)."""

import numpy as np
import pytest

from snag_tpu.data.dataset import load_data as jax_load_data
from snag_tpu.data.graph import build_graph as jax_build_graph
from snag_tpu_torch.data.dataset import load_data as torch_load_data
from snag_tpu_torch.data.graph import build_graph as torch_build_graph
from torch_port_common import assert_graph_equal, configs, single_thread

single_thread()


@pytest.mark.parametrize("seed,n_ents", [(7, 200), (3408, 300)])
def test_load_data_matches_jax(tmp_path, seed, n_ents):
    jcfg, tcfg = configs(str(tmp_path), random_seed=seed, synth_ents=n_ents)
    jd = jax_load_data(jcfg)
    td = torch_load_data(tcfg)
    assert (td.ent_num, td.rel_num) == (jd.ent_num, jd.rel_num)
    assert td.triples == jd.triples
    for name in ("img_features", "rel_features", "att_features",
                 "train_ill", "test_ill"):
        a, b = getattr(td, name), getattr(jd, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    for name in ("ent_wo_img", "ent_w_img", "left_ents", "right_ents",
                 "left_non_train", "right_non_train", "test_ill_set"):
        assert getattr(td, name) == getattr(jd, name), name
    assert_graph_equal(jd.graph, td.graph)


@pytest.mark.parametrize("seed", [0, 1])
def test_build_graph_matches_jax_with_duplicates_and_loops(seed):
    """Repeated triples, both directions of a pair, self-loop triples and
    an isolated node all reduce to the same edge multiset."""
    rng = np.random.default_rng(seed)
    n = 40
    tri = [(int(rng.integers(n - 1)), 0, int(rng.integers(n - 1)))
           for _ in range(150)]
    tri += [(3, 1, 5), (5, 2, 3), (3, 1, 5), (8, 0, 8)]
    assert_graph_equal(jax_build_graph(n, tri), torch_build_graph(n, tri))


def test_device_graph_tensors():
    g = torch_build_graph(6, [(0, 0, 1), (1, 0, 2), (4, 0, 5)])
    dg = g.to_torch("cpu")
    assert dg.row_ptr.dtype.is_floating_point is False
    assert str(dg.row_ptr.dtype) == "torch.int32"
    assert str(dg.col.dtype) == "torch.int32"
    assert str(dg.row.dtype) == "torch.int64"
    assert int(dg.row_ptr[-1]) == dg.n_edges == g.n_edges
