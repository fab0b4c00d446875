"""Port rank-eval twins vs the JAX package's evaluators.

The dense twin (``snag_tpu_torch/ops/cuda/rank_eval.py::eval_core``) is what
CPU tensors run; the per-sweep twins are the kernels' plain versions, and
the CUDA sweeps are held against both on the card.  Here they must give
EXACTLY the ranks and top-3 of ``snag_tpu.eval.ranking._eval_core`` and of
the Pallas streaming kernels in interpret mode, as
``tests/test_rank_eval_stream.py`` asks of the JAX kernels.  The inputs
are random unit rows at small N, where no two distances of a row fall
within rounding of each other except where a case builds exact ties.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import snag_tpu.ops.pallas.rank_eval as rk
from snag_tpu.eval.ranking import _eval_core
from snag_tpu.eval.ranking import full_rank_eval as jax_full_rank_eval
from snag_tpu_torch.eval.ranking import full_rank_eval
from snag_tpu_torch.ops.cuda import rank_eval as trk
from torch_port_common import single_thread

single_thread()


@pytest.fixture
def force_interpret(monkeypatch):
    monkeypatch.setattr(rk, "FORCE_INTERPRET", True)


def _embs(n, d, seed=0):
    rng = np.random.default_rng(seed)
    l = rng.normal(size=(n, d)).astype(np.float32)
    r = l + 0.3 * rng.normal(size=(n, d)).astype(np.float32)
    l /= np.linalg.norm(l, axis=1, keepdims=True)
    r /= np.linalg.norm(r, axis=1, keepdims=True)
    return l, r


def _tied_embs(n=120, d=16, seed=11):
    """Duplicated rows on both sides: exact-equal distances exercise the
    ``col < row`` tie rule of the ranks and the lowest-id rule of top-3."""
    l, r = _embs(n, d, seed)
    for a, b in ((5, 9), (9, 40), (17, 3), (60, 61)):
        r[b] = r[a]
        l[b] = l[a]
    r[77] = r[12]              # a right-side duplicate alone
    return l, r


def _twin(l, r, k, use_csls, top3):
    out = trk.eval_core(torch.from_numpy(l), torch.from_numpy(r), k,
                        use_csls, top3)
    return [None if t is None else t.numpy() for t in out]


def _assert_same(got, want):
    for a, b, name in zip(got, want, ("ranks_l2r", "ranks_r2l", "top3")):
        if b is None:
            assert a is None, name
        else:
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=name)


CASES = [("n150", 150, False, 3), ("n150csls", 150, True, 3),
         ("n300csls", 300, True, 3), ("k10", 140, True, 10)]


@pytest.mark.parametrize("name,n,use_csls,k", CASES)
def test_twin_matches_dense_eval_core(name, n, use_csls, k):
    l, r = _embs(n, 32 if n != 140 else 16, seed=n)
    want = _eval_core(jnp.asarray(l), jnp.asarray(r), k, use_csls, 2, True)
    _assert_same(_twin(l, r, k, use_csls, True), want[1:])


@pytest.mark.parametrize("name,n,use_csls,k", CASES)
def test_twin_matches_streaming_interpret(force_interpret, name, n,
                                          use_csls, k):
    l, r = _embs(n, 32 if n != 140 else 16, seed=n)
    want = rk.streaming_rank_eval(jnp.asarray(l), jnp.asarray(r), k,
                                  use_csls, True)
    _assert_same(_twin(l, r, k, use_csls, True), want)


@pytest.mark.parametrize("name,n,use_csls,k", CASES)
def test_sweep_twins_composed_match_streaming_interpret(force_interpret, name,
                                                        n, use_csls, k):
    """The per-sweep twins composed exactly as the CUDA path composes its
    two kernels (``two_sweeps``) reproduce the Pallas sweeps' ranks."""
    l, r = _embs(n, 32 if n != 140 else 16, seed=n)
    got = trk.two_sweeps(torch.from_numpy(l), torch.from_numpy(r), k,
                         use_csls, True, sweep_a=trk.topk_mean_twin,
                         sweep_b=trk.rank_counts_twin)
    want = rk.streaming_rank_eval(jnp.asarray(l), jnp.asarray(r), k,
                                  use_csls, True)
    _assert_same([t.numpy() for t in got], want)


@pytest.mark.parametrize("use_csls", [False, True])
def test_exact_ties(force_interpret, use_csls):
    l, r = _tied_embs()
    got = _twin(l, r, 3, use_csls, True)
    _assert_same(got, _eval_core(jnp.asarray(l), jnp.asarray(r), 3,
                                 use_csls, 2, True)[1:])
    _assert_same(got, rk.streaming_rank_eval(jnp.asarray(l), jnp.asarray(r),
                                             3, use_csls, True))
    swept = trk.two_sweeps(torch.from_numpy(l), torch.from_numpy(r), 3,
                           use_csls, True, sweep_a=trk.topk_mean_twin,
                           sweep_b=trk.rank_counts_twin)
    _assert_same(got, [t.numpy() for t in swept])
    if not use_csls:
        # query 9 equals query 5 and gold column 9 equals column 5: the
        # earlier column wins the tie, so the gold sits one place back,
        # and the retrieval lists the lower id first
        d = trk.pairwise_distances(torch.from_numpy(l), torch.from_numpy(r))
        assert d[9, 5] == d[9, 9]
        assert got[0][9] == got[0][5] + 1
        top = list(got[2][9])
        assert top.index(5) < top.index(9)


def test_full_rank_eval_matches_jax():
    l, r = _embs(200, 24, seed=9)
    want = jax_full_rank_eval(jnp.asarray(l), jnp.asarray(r), csls_k=3,
                              use_csls=True, with_top3=True)
    before = trk.STATS_RANKS.twin_calls
    got = full_rank_eval(torch.from_numpy(l), torch.from_numpy(r), csls_k=3,
                         use_csls=True, with_top3=True)
    assert trk.STATS_RANKS.twin_calls == before + 1
    np.testing.assert_array_equal(got.ranks_l2r, want.ranks_l2r)
    np.testing.assert_array_equal(got.top3_l2r, want.top3_l2r)
    np.testing.assert_array_equal(got.acc_l2r, want.acc_l2r)
    np.testing.assert_array_equal(got.acc_r2l, want.acc_r2l)
    assert (got.mr_l2r, got.mrr_l2r, got.mr_r2l, got.mrr_r2l) == \
        (want.mr_l2r, want.mrr_l2r, want.mr_r2l, want.mrr_r2l)
