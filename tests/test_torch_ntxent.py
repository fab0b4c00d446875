"""Port NT-Xent twins vs the JAX package's streaming Pallas kernels.

``streaming_lse_twin`` and ``ntxent_grad_twin``
(``snag_tpu_torch/ops/cuda/ntxent.py``) are what CPU tensors run; the CUDA
kernels are held against them on the card.  The reference is
``snag_tpu/ops/pallas/ntxent_kernel.py`` run in interpret mode on the CPU,
as tests/test_ntxent_stream.py runs it.  The JAX package pads B to its tile
and places the positive partner at r +/- Bp; the port keeps B.  Inputs
include a padded ``valid`` mask and an all-zero row.  f32 sums in another
order: rtol = 1e-5, atol = 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import snag_tpu.ops.pallas.ntxent_kernel as nk
from snag_tpu_torch.ops.cuda import ntxent as tnx
from torch_port_common import single_thread

single_thread()
TOL = dict(rtol=1e-5, atol=1e-6)
TAU = 0.1


@pytest.fixture
def force_interpret(monkeypatch):
    monkeypatch.setattr(nk, "FORCE_INTERPRET", True)


def _unit(rng, *shape):
    z = rng.normal(size=shape).astype(np.float32)
    return z / np.linalg.norm(z, axis=-1, keepdims=True)


def _case(m, b, d, n_valid, zero_row, seed):
    rng = np.random.default_rng(seed)
    zis, zjs = _unit(rng, m, b, d), _unit(rng, m, b, d)
    # positives are near copies, as in training
    zjs = zjs * 0.3 + zis
    zjs /= np.linalg.norm(zjs, axis=-1, keepdims=True)
    if zero_row:
        zis[0, 2] = 0.0
    valid = None if n_valid is None else np.arange(b) < n_valid
    coef_a = rng.uniform(0.1, 1.0, size=(m, b)).astype(np.float32)
    coef_b = rng.uniform(0.1, 1.0, size=(m, b)).astype(np.float32)
    return zis, zjs, valid, coef_a, coef_b


CASES = [(2, 9, 8, None, False, 0), (3, 40, 32, 33, True, 1),
         (1, 64, 17, 50, False, 2)]


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("m,b,d,n_valid,zero_row,seed", CASES)
def test_lse_twin_matches_pallas_interpret(force_interpret, m, b, d,
                                           n_valid, zero_row, seed):
    zis, zjs, valid, _, _ = _case(m, b, d, n_valid, zero_row, seed)
    want = nk.streaming_lse(_j(zis), _j(zjs), TAU, _j(valid))
    got = tnx.streaming_lse(_t(zis), _t(zjs), TAU, _t(valid))
    for a, w, side in zip(got, want, "ab"):
        np.testing.assert_allclose(a.numpy(), np.asarray(w),
                                   err_msg=f"lse_{side}", **TOL)


@pytest.mark.parametrize("m,b,d,n_valid,zero_row,seed", CASES)
def test_grad_twin_matches_pallas_interpret(force_interpret, m, b, d,
                                            n_valid, zero_row, seed):
    zis, zjs, valid, ca, cb = _case(m, b, d, n_valid, zero_row, seed)
    lse_a, lse_b = (np.asarray(x) for x in
                    nk.streaming_lse(_j(zis), _j(zjs), TAU, _j(valid)))
    want = nk.streaming_ntxent_grad(_j(zis), _j(zjs), _j(lse_a), _j(lse_b),
                                    _j(ca), _j(cb), TAU, _j(valid))
    got = tnx.streaming_ntxent_grad(_t(zis), _t(zjs), _t(lse_a), _t(lse_b),
                                    _t(ca), _t(cb), TAU, _t(valid))
    for a, w, side in zip(got, want, ("d_zis", "d_zjs")):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), err_msg=side,
                                   **TOL)


def test_cpu_dispatch_counts_twins_and_kernels_refuse_cpu():
    zis, zjs, valid, ca, cb = _case(1, 8, 4, 6, False, 3)
    before = {s.name: (s.launches, s.twin_calls)
              for s in (tnx.STATS_LSE, tnx.STATS_GRAD)}
    la, lb = tnx.streaming_lse(_t(zis), _t(zjs), TAU, _t(valid))
    tnx.streaming_ntxent_grad(_t(zis), _t(zjs), la, lb, _t(ca), _t(cb), TAU,
                              _t(valid))
    for s in (tnx.STATS_LSE, tnx.STATS_GRAD):
        assert (s.launches, s.twin_calls) == (before[s.name][0],
                                              before[s.name][1] + 1)
    z, v = tnx.stack(_t(zis), _t(zjs), _t(valid))
    with pytest.raises(ValueError, match="CUDA"):
        tnx.streaming_lse_cuda(z, v, TAU)
    with pytest.raises(ValueError, match="CUDA"):
        tnx.ntxent_grad_cuda(z, torch.cat([la, lb], 1), torch.zeros(1, 16),
                             v, TAU)
