"""The evaluator's rest and the last MMEA flags, the port vs the JAX package.

* ``--distance 1`` (L1): ``eval.ranking.l1_distances`` against JAX's
  ``l1_distances`` (rtol = 1e-6: the 64-wide slices are added in the same
  order, each slice's own sum in torch's order and XLA's; query rows also
  in blocks smaller than the matrix), and the dense and chunked L1
  evaluations against JAX's;
* sides of unequal size, below and above ``FULL_MATRIX_MAX``, and more
  than ``FULL_MATRIX_MAX`` pairs on the CPU: the chunked evaluator against
  JAX's, whose dense path cannot take unequal sides (pinned here: it
  raises a TypeError);
* CSLS at k = 20 and 128 through the dense twin, the split model of the
  rank kernel's sweep A, and a model of its shared-memory lists' upkeep
  (``test_torch_rank_long_schedule.Lists``).

Thresholds and chunk sizes are set alike on both sides (monkeypatch), as
``tests/test_eval_chunked.py`` does, so that no test needs 25,000 pairs.
Both sides' distances can differ in their last bits (matmul tilings, the
order of each L1 slice's sum), which can flip a near-tie: ranks must be
equal on >= 99 % of queries and differ by at most 1, top-3 lists equal on
>= 99 % of queries, and Hits / MRR within 1e-2.

Last, each new flag (``--distance 1``, ``--csls_k 20``,
``--instance_normalization``, ``--profile_dir``, ``--heads 8,8``) through
``cli.train_mmea.main`` on the CPU for two epochs, and ``--profile_dir``
over five: its Chrome trace is written and every loss equals a run
without it.
"""

import functools
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import snag_tpu.eval.ranking as R
import snag_tpu_torch.eval.ranking as TR
from snag_tpu_torch.cli.train_mmea import main as port_main
from snag_tpu_torch.ops.cuda import rank_eval as trk
from test_torch_rank_long_schedule import Lists
from torch_port_common import single_thread, small_argv

single_thread()


def _embs(nl, nr, d, seed, noise=0.3):
    """Unit rows; the right side's first min(nl, nr) rows are noisy copies
    of the left's."""
    rng = np.random.default_rng(seed)
    l = rng.normal(size=(nl, d)).astype(np.float32)
    r = rng.normal(size=(nr, d)).astype(np.float32)
    m = min(nl, nr)
    r[:m] = l[:m] + noise * r[:m]
    l /= np.linalg.norm(l, axis=1, keepdims=True)
    r /= np.linalg.norm(r, axis=1, keepdims=True)
    return l, r


def _port(l, r, **kw):
    return TR.full_rank_eval(torch.from_numpy(l), torch.from_numpy(r),
                             with_top3=True, **kw)


def _jax(l, r, **kw):
    return R.full_rank_eval(jnp.asarray(l), jnp.asarray(r), with_top3=True,
                            **kw)


def _assert_agree(got, want):
    for a, b, name in ((got.ranks_l2r, want.ranks_l2r, "ranks_l2r"),
                       (got.top3_l2r, want.top3_l2r, "top3")):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, name
        same = (a == b) if a.ndim == 1 else (a == b).all(axis=1)
        assert same.mean() >= 0.99, (name, same.mean())
    assert np.abs(got.ranks_l2r.astype(int)
                  - np.asarray(want.ranks_l2r).astype(int)).max() <= 1
    for a, b in ((got.acc_l2r, want.acc_l2r), (got.acc_r2l, want.acc_r2l)):
        np.testing.assert_allclose(a, b, atol=1e-2)
    assert abs(got.mrr_l2r - want.mrr_l2r) < 1e-2
    assert abs(got.mrr_r2l - want.mrr_r2l) < 1e-2


@pytest.fixture
def small_chunks(monkeypatch):
    """Both packages' thresholds and chunk sizes cut alike: dense up to 64
    pairs (L1 16), rank blocks of 48 queries (L1 32), CSLS blocks of 40."""
    for mod in (R, TR):
        monkeypatch.setattr(mod, "FULL_MATRIX_MAX", 64)
        monkeypatch.setattr(mod, "L1_FULL_MAX", 16)
    monkeypatch.setattr(TR, "RANK_CHUNK", 48)
    monkeypatch.setattr(TR, "L1_RANK_CHUNK", 32)
    monkeypatch.setattr(TR, "KNN_CHUNK", 40)
    chunked, knn = R._chunked_ranks_one_direction, R._knn_means

    def jax_chunked(*a, **k):
        k["chunk"] = 32 if k.get("distance_kind") == 1 else 48
        return chunked(*a, **k)
    monkeypatch.setattr(R, "_chunked_ranks_one_direction", jax_chunked)
    monkeypatch.setattr(R, "_knn_means", functools.partial(knn, chunk=40))


# ------------------------------------------------------------------- L1

@pytest.mark.parametrize("d,block", [(70, None), (130, None),
                                     (130, 5 * 53 * 64)])
def test_l1_distances_match_jax(monkeypatch, d, block):
    if block is not None:       # query rows in blocks of 5, the last of 2
        monkeypatch.setattr(TR, "L1_BLOCK", block)
    rng = np.random.default_rng(d)
    q = rng.normal(size=(37, d)).astype(np.float32)
    c = rng.normal(size=(53, d)).astype(np.float32)
    got = TR.l1_distances(torch.from_numpy(q), torch.from_numpy(c)).numpy()
    if block is not None:       # the blocks give the whole matrix's bits
        monkeypatch.undo()
        whole = TR.l1_distances(torch.from_numpy(q), torch.from_numpy(c))
        np.testing.assert_array_equal(got, whole.numpy())
    want = np.asarray(R.l1_distances(jnp.asarray(q), jnp.asarray(c)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    exact = np.abs(q[:, None, :].astype(np.float64) - c[None]).sum(-1)
    np.testing.assert_allclose(got, exact, rtol=1e-6, atol=0)


@pytest.mark.parametrize("use_csls", [False, True])
def test_l1_dense_matches_jax(use_csls):
    l, r = _embs(150, 150, 70, seed=1)
    kw = dict(use_csls=use_csls, csls_k=3, distance_kind=1)
    before = trk.STATS_RANKS.twin_calls
    got = _port(l, r, **kw)
    assert trk.STATS_RANKS.twin_calls == before   # not the L2 sweeps' twin
    _assert_agree(got, _jax(l, r, **kw))


@pytest.mark.parametrize("use_csls", [False, True])
def test_l1_chunked_matches_jax(monkeypatch, small_chunks, use_csls):
    l, r = _embs(140, 140, 24, seed=5)
    kw = dict(use_csls=use_csls, csls_k=3, distance_kind=1)
    got = _port(l, r, **kw)
    _assert_agree(got, _jax(l, r, **kw))
    monkeypatch.setattr(TR, "L1_FULL_MAX", 1024)
    _assert_agree(got, _port(l, r, **kw))         # the port's dense L1


# ------------------------------------------------------ unequal and large

@pytest.mark.parametrize("nl,nr", [(90, 120), (120, 90)])
def test_jax_dense_path_refuses_unequal_sides(nl, nr):
    l, r = _embs(nl, nr, 16, seed=2)
    with pytest.raises(TypeError, match="incompatible shapes"):
        _jax(l, r)


@pytest.mark.parametrize("above", [False, True])
@pytest.mark.parametrize("kind", [2, 1])
@pytest.mark.parametrize("nl,nr", [(90, 120), (120, 90)])
def test_unequal_sides_match_jax_chunked(monkeypatch, small_chunks, above,
                                         kind, nl, nr):
    """Below the threshold the port runs unequal sides through its chunked
    evaluator (JAX's dense path raises); above it both chunk.  Queries past
    the shorter side rank against the last candidate's distance, as JAX's
    clamped gather does."""
    l, r = _embs(nl, nr, 16, seed=3)
    if not above:
        monkeypatch.setattr(TR, "FULL_MATRIX_MAX", 25000)
        monkeypatch.setattr(TR, "L1_FULL_MAX", 1024)
    for use_csls in (False, True):
        kw = dict(use_csls=use_csls, csls_k=3, distance_kind=kind)
        got = _port(l, r, **kw)
        assert got.ranks_l2r.shape == (nl,)
        _assert_agree(got, _jax(l, r, **kw))


def test_above_full_matrix_max_on_cpu(small_chunks):
    l, r = _embs(150, 150, 32, seed=4)
    kw = dict(use_csls=True, csls_k=3)
    before = trk.STATS_RANKS.twin_calls
    got = _port(l, r, **kw)
    assert trk.STATS_RANKS.twin_calls == before   # chunked, not dense
    _assert_agree(got, _jax(l, r, **kw))
    dense = trk.eval_core(torch.from_numpy(l), torch.from_numpy(r), 3, True,
                          True)
    assert (got.ranks_l2r == dense[0].numpy()).mean() >= 0.99


# ----------------------------------------------------------- CSLS k > 10

@pytest.mark.parametrize("k", [20, 128])
def test_csls_k_above_10_twin_matches_jax(k):
    l, r = _embs(200, 200, 24, seed=k)
    want = R._eval_core(jnp.asarray(l), jnp.asarray(r), k, True, 2, True)
    got = trk.eval_core(torch.from_numpy(l), torch.from_numpy(r), k, True,
                        True)
    for a, b, name in zip(got, want[1:], ("ranks_l2r", "ranks_r2l", "top3")):
        a, b = a.numpy(), np.asarray(b)
        same = (a == b) if a.ndim == 1 else (a == b).all(axis=1)
        assert same.mean() >= 0.99, name
    x, y = torch.from_numpy(l), torch.from_numpy(r)
    xn, yn = (x * x).sum(1), (y * y).sum(1)
    mean, diag = trk.topk_mean_twin(x, y, xn, yn, k)
    # the sweep's column splits, merged in order, keep the same top k
    for splits in (1, 3, 7):
        m, dg = trk.topk_mean_split(x, y, xn, yn, k, splits, tile_cols=32)
        assert torch.equal(m, mean) and torch.equal(dg, diag)


def test_list_len():
    assert [trk.list_len(k) for k in (1, 2, 3, 4, 10, 11, 32, 33, 128)] == \
        [1, 3, 3, 10, 10, 32, 32, 128, 128]
    with pytest.raises(ValueError, match="1..128"):
        trk.list_len(129)


@pytest.mark.parametrize("k", [32, 128])
def test_list_insertion_keeps_the_top_k(k):
    """A row's list as the sweep keeps it (``test_torch_rank_long_schedule
    .Lists``: a threshold, K candidates, a network merge when they fill):
    offered a tile's 16 x 16 values at a time, with ties, -inf and NaN, it
    ends with the k largest values that are not NaN."""
    rng = np.random.default_rng(k)
    vals = np.round(rng.normal(size=3000), 2).astype(np.float32)  # ties
    vals[::97] = -np.inf
    vals[5::101] = np.nan
    row = Lists(1, k)
    for s in range(0, len(vals), 16 * 16):     # a tile's 16 x 16 offers
        row.offer(vals[None, s:s + 256])
    want = np.sort(vals[~np.isnan(vals)])[::-1][:k]
    np.testing.assert_array_equal(row.flush()[0], want)
    assert row.merges > 0


# ------------------------------------------------------------ the flags

FLAGS = {"distance": ["--distance", "1"], "csls_k": ["--csls_k", "20"],
         "instance_norm": ["--instance_normalization"],
         "profile_dir": ["--profile_dir"], "heads": ["--heads", "8,8"]}


def _run(tmp_path, name, *extra, epoch=2):
    argv = small_argv(tmp_path / name, epoch=epoch, eval_epoch=1,
                      batch_size=32, lr=5e-4)
    return port_main(argv + list(extra))


@pytest.mark.parametrize("flag", sorted(FLAGS))
def test_new_flags_through_main(tmp_path, flag):
    extra = FLAGS[flag] + ([str(tmp_path / "trace")]
                           if flag == "profile_dir" else [])
    runner = _run(tmp_path, flag, *extra)
    res = runner.last_result
    assert np.isfinite(runner.loss_log.loss).all()
    assert 0 <= res.mrr_l2r <= 1 and 0 <= res.mrr_r2l <= 1
    if flag == "heads":
        assert [layer.n_head for layer in
                runner.model.multimodal_encoder.cross_graph_model.layer_stack
                ] == [8, 8]
    if flag == "instance_norm":
        names = dict(runner.model.named_parameters())
        assert "multimodal_encoder.cross_graph_model.norm.weight" in names


def test_profile_dir_traces_epochs_2_to_4_and_changes_no_loss(tmp_path):
    plain = _run(tmp_path, "plain", epoch=5)
    traced = _run(tmp_path, "traced", "--profile_dir",
                  str(tmp_path / "trace"), epoch=5)
    assert traced.loss_log.loss == plain.loss_log.loss
    np.testing.assert_array_equal(traced.last_result.ranks_l2r,
                                  plain.last_result.ranks_l2r)
    assert traced.trace_path.startswith(str(tmp_path / "trace"))
    with open(traced.trace_path) as f:
        events = json.load(f)["traceEvents"]
    assert any(ev.get("name", "").startswith("aten::") for ev in events)
