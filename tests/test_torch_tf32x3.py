"""Why the loss kernels take three TF32 products per fp32 one.

``csrc/gram_grad.cuh`` computes both products of the mixture gradient (K =
z z^T and W_tot z) and of the NT-Xent gradient (K and W z) on the tensor
cores in 3xTF32: each fp32 operand x is split into hi = rna_tf32(x) and
lo = rna_tf32(x - hi), and a b is taken as hi hi + (hi lo + lo hi) with
fp32 accumulation.  Here the TF32 rounding of ``cvt.rna.tf32.f32`` is
emulated on the CPU (add 0x1000 to the bit pattern, clear the low 13 bits)
inside the twins' formulas (``ops/cuda/snag_loss.py::mixture_grad_twin``,
``ops/cuda/ntxent.py::ntxent_grad_twin``), and the gradients are held
against an f64 evaluation with the card's limit, max |err| <= 1e-4 x
max |ref|: exact fp32 and 3xTF32 meet it, one TF32 product misses it on dz
(1/tau = 10 multiplies K's error before the exp).

The lse kernels (``csrc/gram_lse.cuh``, the mixture's and NT-Xent's) take
K = z z^T the same way.  Their limit is the card's check,
``assert_close(rtol=1e-5, atol=1e-5)`` against the twin: |err| <= 1e-5 +
1e-5 |lse|, about 1.1e-4 at lse ~ 10.  Against an f64 evaluation, fp32 and
3xTF32 products both stay under 1e-5 absolute and within a tenth of the
limit (at most 8.5e-6 and 7.0e-6: the rounding of K at the positive
pair, ~1e-6, times 1/tau), one TF32 product misses the limit 3-20x.
"""

import numpy as np
import pytest
import torch

from snag_tpu_torch.ops.cuda import ntxent as tnx
from snag_tpu_torch.ops.cuda import snag_loss as tsl
from torch_port_common import single_thread

single_thread()
LIMIT = 1e-4          # chip_smoke.py / test_torch_cuda.py, max |err| / max |ref|
TAU = 0.1


def rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: round an f32 to 10 mantissa bits, ties away
    from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x):
    hi = rna_tf32(x)
    return hi, rna_tf32(x - hi)


def mm_fp32(a, b):
    return torch.bmm(a, b)


def mm_tf32x3(a, b):
    (a_hi, a_lo), (b_hi, b_lo) = split(a), split(b)
    return torch.bmm(a_hi, b_hi) + (torch.bmm(a_hi, b_lo)
                                    + torch.bmm(a_lo, b_hi))


def mm_tf32(a, b):
    return torch.bmm(rna_tf32(a), rna_tf32(b))


def _weights(s, lse, coef, v, inv_tau):
    """The G + G^T weight W of every channel of s (C, 2B, 2B)."""
    n2 = s.shape[1]
    rows = torch.arange(n2)
    neq = (rows[:, None] != rows[None, :]).to(lse.dtype)
    pos = torch.where(rows < n2 // 2, rows + n2 // 2, rows - n2 // 2)
    onehot = (rows[None, :] == pos[:, None]).to(lse.dtype)
    p_row = torch.exp(torch.clamp(s - lse[:, :, None], max=0.0))
    p_col = torch.exp(torch.clamp(s - lse[:, None, :], max=0.0))
    coef_r, coef_c = coef[:, :, None], coef[:, None, :]
    return (neq[None] * (coef_r * p_row * v[None, None, :]
                         + p_col * coef_c * v[None, :, None])
            - onehot[None] * (coef_r + coef_c)) * inv_tau


def grad_with(z, alpha, beta, lse, coef, v, tau, mm):
    """The formulas of ``mixture_grad_twin`` with its two products, K =
    z z^T and W_tot z, taken by ``mm`` in z's dtype and everything else in
    lse's."""
    inv_tau = 1.0 / tau
    m = z.shape[0]
    k = mm(z, z.transpose(1, 2)).to(lse.dtype)
    mix_a = torch.einsum("rm,cm,mrc->rc", alpha, alpha, k)
    mix_f = torch.einsum("m,mrc->rc", beta, k)
    s = torch.cat([k, mix_a[None], mix_f[None]]) * inv_tau
    w = _weights(s, lse, coef, v, inv_tau)
    w_a, w_f = w[m], w[m + 1]
    aa = alpha.T[:, :, None] * alpha.T[:, None, :]
    w_tot = w[:m] + w_a[None] * aa + w_f[None] * beta[:, None, None]
    dz = mm(w_tot.to(z.dtype), z).to(lse.dtype)
    dalpha = torch.einsum("rc,cm,mrc->rm", w_a, alpha, k)
    dbeta = 0.5 * torch.einsum("rc,mrc->m", w_f, k)
    return dz, dalpha, dbeta


def ntxent_grad_with(z, lse, coef, v, tau, mm):
    """The formulas of ``ntxent_grad_twin`` with its two products, K =
    z z^T and W z, taken by ``mm`` in z's dtype and everything else in
    lse's."""
    inv_tau = 1.0 / tau
    s = mm(z, z.transpose(1, 2)).to(lse.dtype) * inv_tau
    w = _weights(s, lse, coef, v, inv_tau)
    return mm(w.to(z.dtype), z).to(lse.dtype)


def _inputs(m=4, b=64, d=48, seed=5):
    """The recipe of chip_smoke.py's mixture phase: unit rows with
    near-copy positives and one all-zero row, unit mixture coefficients."""
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(m, 2 * b, d)).astype(np.float32)
    z[:, b:] = z[:, :b] + 0.5 * z[:, b:]
    z /= np.linalg.norm(z, axis=-1, keepdims=True)
    z[min(1, m - 1), 5] = 0.0
    alpha = np.abs(rng.normal(size=(2 * b, m))).astype(np.float32)
    alpha /= np.linalg.norm(alpha, axis=1, keepdims=True)
    u = rng.uniform(0.2, 1.0, size=m).astype(np.float32)
    beta = u * u / np.sum(u * u)
    v = np.ones(2 * b, dtype=np.float32)
    coef = rng.uniform(0.1, 1.0, size=(m + 2, 2 * b)).astype(np.float32) / b
    return [torch.from_numpy(a) for a in (z, alpha, beta, v, coef)]


def rel_errors(mm, m=4, b=64, d=48):
    """max |err| / max |ref| of (dz, dalpha, dbeta) with the two products
    in f32 inputs through ``mm`` and the rest in f64, against f64."""
    z, alpha, beta, v, coef = _inputs(m, b, d)
    alpha, beta, v, coef = (t.double() for t in (alpha, beta, v, coef))
    lse = tsl.mixture_lse_twin(z.double(), alpha, beta, v, TAU)
    ref = grad_with(z.double(), alpha, beta, lse, coef, v, TAU, mm_fp32)
    got = grad_with(z, alpha, beta, lse, coef, v, TAU, mm)
    return [((g - r).abs().max() / r.abs().max()).item()
            for g, r in zip(got, ref)]


def test_rna_tf32_rounds_to_ten_mantissa_bits_ties_away():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11,
                      -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12, 3.0e-5],
                     dtype=torch.float32)
    want = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -9,
                         -(1.0 + 2.0 ** -10), 1.0], dtype=torch.float32)
    got = rna_tf32(x)
    assert torch.equal(got[:5], want)
    assert (got.view(torch.int32) & 0x1FFF == 0).all()
    # hi + lo keeps ~21 mantissa bits of any x
    xs = torch.from_numpy(np.random.default_rng(0).normal(size=1000)
                          .astype(np.float32))
    hi, lo = split(xs)
    assert ((hi + lo - xs).abs() <= 2.0 ** -20 * xs.abs()).all()


def test_grad_with_exact_products_is_the_twin():
    z, alpha, beta, v, coef = _inputs(m=3, b=10, d=6, seed=1)
    lse = tsl.mixture_lse_twin(z, alpha, beta, v, TAU)
    got = grad_with(z, alpha, beta, lse, coef, v, TAU, mm_fp32)
    want = tsl.mixture_grad_twin(z, alpha, beta, lse, coef, v, TAU)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("mm", [mm_fp32, mm_tf32x3], ids=["fp32", "3xtf32"])
def test_fp32_and_3xtf32_products_hold_the_limit(mm):
    errs = rel_errors(mm)
    assert all(e <= LIMIT for e in errs), errs


def test_one_tf32_product_misses_the_limit_on_dz():
    errs = rel_errors(mm_tf32)
    assert errs[0] > LIMIT, errs


def _ntxent_inputs(m, b, d, n_valid, seed):
    """The recipe of test_torch_cuda.py's NT-Xent cases: unit rows with
    near-copy positives and one all-zero row, validity of the first
    n_valid pairs, row coefficients zero on invalid rows."""
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(m, 2 * b, d)).astype(np.float32)
    z[:, b:] = z[:, :b] + 0.5 * z[:, b:]
    z /= np.linalg.norm(z, axis=-1, keepdims=True)
    z[0, 1] = 0.0
    v = np.concatenate([np.arange(b) < n_valid] * 2).astype(np.float32)
    coef = rng.uniform(0.1, 1.0, size=(m, 2 * b)).astype(np.float32) * v
    coef /= max(n_valid, 1)
    return [torch.from_numpy(a) for a in (z, v, coef)]


def ntxent_rel_error(mm, m, b, d, n_valid):
    """max |err| / max |ref| of dz with the two products in f32 inputs
    through ``mm`` and the rest in f64, against f64."""
    z, v, coef = _ntxent_inputs(m, b, d, n_valid, seed=b)
    v, coef = v.double(), coef.double()
    lse = tnx.streaming_lse_twin(z.double(), v, TAU)
    ref = ntxent_grad_with(z.double(), lse, coef, v, TAU, mm_fp32)
    got = ntxent_grad_with(z, lse, coef, v, TAU, mm)
    return ((got - ref).abs().max() / ref.abs().max()).item()


# the IIR shape cut to B = 257, the card's d = 1,200 case, and the 1,800
# wide GMI rows of six modalities (two feature chunks on the card)
NTXENT_SHAPES = [(4, 257, 300, 257), (1, 70, 1200, 64), (2, 64, 1800, 64)]


def test_ntxent_grad_with_exact_products_is_the_twin():
    z, v, coef = _ntxent_inputs(3, 10, 6, 8, seed=1)
    lse = tnx.streaming_lse_twin(z, v, TAU)
    got = ntxent_grad_with(z, lse, coef, v, TAU, mm_fp32)
    want = tnx.ntxent_grad_twin(z, lse, coef, v, TAU)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("shape", NTXENT_SHAPES, ids=str)
@pytest.mark.parametrize("mm", [mm_fp32, mm_tf32x3], ids=["fp32", "3xtf32"])
def test_ntxent_fp32_and_3xtf32_products_hold_the_limit(mm, shape):
    err = ntxent_rel_error(mm, *shape)
    assert err <= LIMIT, err


@pytest.mark.parametrize("shape", NTXENT_SHAPES, ids=str)
def test_ntxent_one_tf32_product_misses_the_limit(shape):
    err = ntxent_rel_error(mm_tf32, *shape)
    assert err > LIMIT, err


def _lse_of(s, v, inv_tau):
    """The row-lse of the twins over the channels s (C, 2B, 2B)."""
    n2 = s.shape[1]
    neq = (~torch.eye(n2, dtype=torch.bool)).to(v.dtype)
    mask = neq[None] * v[None, None, :]
    return torch.log(torch.sum(torch.exp(s - inv_tau) * mask, dim=2)
                     + tnx.LSE_EPS) + inv_tau


def ntxent_lse_with(z, v, tau, mm):
    """The formula of ``streaming_lse_twin`` with its product K = z z^T
    taken by ``mm`` in z's dtype and everything else in v's."""
    inv_tau = 1.0 / tau
    return _lse_of(mm(z, z.transpose(1, 2)).to(v.dtype) * inv_tau, v, inv_tau)


def mixture_lse_with(z, alpha, beta, v, tau, mm):
    """The formula of ``mixture_lse_twin`` with its product K = z z^T
    taken by ``mm`` in z's dtype and everything else in v's."""
    inv_tau = 1.0 / tau
    k = mm(z, z.transpose(1, 2)).to(v.dtype)
    mix_a = torch.einsum("rm,cm,mrc->rc", alpha, alpha, k)
    mix_f = torch.einsum("m,mrc->rc", beta, k)
    return _lse_of(torch.cat([k, mix_a[None], mix_f[None]]) * inv_tau, v,
                   inv_tau)


# (kind, M, B, d, valid pairs): NT-Xent at the shapes above; the mixture at
# a small batch, six modalities, and a padded batch
LSE_SHAPES = [("ntxent", *shape) for shape in NTXENT_SHAPES] + [
    ("mixture", 4, 64, 48, 64), ("mixture", 6, 300, 300, 300),
    ("mixture", 4, 200, 300, 150)]


def lse_errors(mm, kind, m, b, d, n_valid):
    """(max |err|, max |err| / (1e-5 + 1e-5 |ref|)) of the lse with K in f32
    inputs through ``mm`` and the rest in f64, against f64."""
    if kind == "ntxent":
        z, v, _ = _ntxent_inputs(m, b, d, n_valid, seed=b)
        v = v.double()
        ref = ntxent_lse_with(z.double(), v, TAU, mm_fp32)
        got = ntxent_lse_with(z, v, TAU, mm)
    else:
        z, alpha, beta, _, _ = _inputs(m, b, d)
        v = torch.cat([torch.arange(b) < n_valid] * 2).double()
        alpha, beta = alpha.double(), beta.double()
        ref = mixture_lse_with(z.double(), alpha, beta, v, TAU, mm_fp32)
        got = mixture_lse_with(z, alpha, beta, v, TAU, mm)
    err = (got - ref).abs()
    return err.max().item(), (err / (1e-5 + 1e-5 * ref.abs())).max().item()


@pytest.mark.parametrize("kind", ["ntxent", "mixture"])
def test_lse_with_exact_products_is_the_twin(kind):
    if kind == "ntxent":
        z, v, _ = _ntxent_inputs(3, 10, 6, 8, seed=1)
        got = ntxent_lse_with(z, v, TAU, mm_fp32)
        want = tnx.streaming_lse_twin(z, v, TAU)
    else:
        z, alpha, beta, v, _ = _inputs(m=3, b=10, d=6, seed=1)
        got = mixture_lse_with(z, alpha, beta, v, TAU, mm_fp32)
        want = tsl.mixture_lse_twin(z, alpha, beta, v, TAU)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape", LSE_SHAPES, ids=str)
@pytest.mark.parametrize("mm", [mm_fp32, mm_tf32x3], ids=["fp32", "3xtf32"])
def test_fp32_and_3xtf32_products_hold_the_lse_limit(mm, shape):
    err, share = lse_errors(mm, *shape)
    assert err <= 1e-5 and share <= 0.25, (err, share)


@pytest.mark.parametrize("shape", LSE_SHAPES, ids=str)
def test_one_tf32_product_misses_the_lse_limit(shape):
    err, share = lse_errors(mm_tf32, *shape)
    assert share > 1.0, (err, share)
