"""The bf16 mixture gradient's positive-pair K and W_tot, each rounded once
from its exact value (``snag_loss.positive_k``, ``positive_w``), on the
CPU.

Where W_m, dalpha and dbeta read the own-channel K at a row's positive
partner, the twin (and the card's ``mixture_grad_bf16``) takes the exact
dot of the two bf16 rows rounded once to bf16.  Before, each side rounded
its own f32 sum: the twin ``ntxent.gram``'s 16-wide slice sums, the
kernel its ``mma.sync`` order, and where such a K (~0.9) lies within
their last bits of a bf16 boundary the two rounded one bf16 ulp apart,
which at tau = 0.1 moves the row's W_m by ~4 %.

Where W_tot is rounded to bf16 for dz at the positive column, both take
``positive_w``: W_tot in f64 from the exact dots, kpos and the f32 lse,
coef, v, alpha and beta, rounded once.  The positive pair's W =
coef_r (p_row - 1) + coef_c (p_col - 1) over tau cancels where p is near
1, so the f32 value each side forms in its own order (the mixtures' K
sums, the exps) lies on the other side of a bf16 boundary from the exact
one far more often than one f32 ulp would suggest.

At the fixed seeds below (found by searches over seeds at M = 2, B = 64,
d = 300) the slice sums round a positive pair's K, and the twin's f32
formation rounds a positive pair's W_tot, to the other side of the exact
value: the tests show each fault and its repair.  Tolerances:
``round_bf16_once``, ``positive_k`` and ``positive_w`` exact (bitwise);
the twin against the JAX package's bf16 Pallas kernels in interpret mode
within 4e-3 x max |JAX| per output, the bf16 limit of
tests/test_torch_bf16.py.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import snag_tpu.ops.pallas.snag_loss_kernel as sk
from snag_tpu_torch.ops.cuda import ntxent as tnx
from snag_tpu_torch.ops.cuda import snag_loss as tsl
from torch_port_common import assert_close_bf16, pallas_interpret, \
    single_thread

single_thread()
TAU = 0.1
M, B, D = 2, 64, 300
FLIP_SEED = 1024        # a positive pair's slice sum rounds apart here
WFLIP_SEED = 1          # a positive pair's f32 W_tot rounds apart here


def _flip_inputs(seed=FLIP_SEED):
    """bf16 unit rows with near-copy positives at ``seed``, and seeded
    mixture coefficients, validity (the last 5 pairs invalid) and channel
    coefficients."""
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(M, 2 * B, D)).astype(np.float32)
    z[:, B:] = z[:, :B] + 0.5 * z[:, B:]
    z /= np.linalg.norm(z, axis=-1, keepdims=True)
    z = torch.from_numpy(z).to(torch.bfloat16)
    rng = np.random.default_rng(0)
    alpha = np.abs(rng.normal(size=(2 * B, M))).astype(np.float32)
    alpha /= np.linalg.norm(alpha, axis=1, keepdims=True)
    u = rng.uniform(0.2, 1.0, size=M).astype(np.float32)
    beta = u * u / np.sum(u * u)
    v = np.concatenate([np.arange(B) < B - 5] * 2).astype(np.float32)
    coef = rng.uniform(0.1, 1.0, size=(M + 2, 2 * B)).astype(np.float32) * v
    coef /= B - 5
    return z, *(torch.from_numpy(a) for a in (alpha, beta, v, coef))


def _slice_sum_k(z):
    """The positive pairs' K as the twin rounded it before: ``ntxent.gram``
    in f32, then to bf16."""
    rows = torch.arange(z.shape[1])
    pos = tsl.positive_rows(z.shape[1], z.device)
    return tnx.gram(z)[:, rows, pos].to(torch.bfloat16).to(torch.float32)


def test_round_bf16_once_rounds_once():
    """Just above a bf16 midpoint, torch's f64 -> bf16 rounds through f32
    onto the midpoint and then down; one rounding goes up.  On random
    values the result is a nearest bf16 value."""
    mid = 1.0 + 2.0 ** -8                  # between 1 and 1 + 2^-7
    x = torch.tensor([mid + 2.0 ** -30, mid - 2.0 ** -30, mid,
                      -(mid + 2.0 ** -30), 0.0], dtype=torch.float64)
    assert x.to(torch.bfloat16).tolist()[0] == 1.0        # twice: down
    assert tsl.round_bf16_once(x).tolist() == [
        1.0 + 2.0 ** -7, 1.0, 1.0, -(1.0 + 2.0 ** -7), 0.0]
    r = torch.from_numpy(np.random.default_rng(3).normal(size=20000))
    got = tsl.round_bf16_once(r)
    bits = got.view(torch.int32)
    err = (got.double() - r).abs()
    for step in (0x10000, -0x10000):        # the bf16 neighbours
        other = (bits + step).view(torch.float32).double()
        assert bool(((other - r).abs() >= err).all())


def test_positive_k_is_one_rounding_of_the_exact_dot():
    """kpos is the exact dot (math.fsum of exact products) rounded once;
    at ``FLIP_SEED`` the slice sums' rounding picks the other side at a
    positive pair, and kpos does not."""
    z = _flip_inputs()[0]
    z64 = z.to(torch.float64).numpy()
    pos = tsl.positive_rows(2 * B, "cpu").numpy()
    exact = torch.tensor([[math.fsum(z64[m, r] * z64[m, pos[r]])
                           for r in range(2 * B)] for m in range(M)],
                         dtype=torch.float64)
    want = tsl.round_bf16_once(exact)
    got = tsl.positive_k(z)
    assert torch.equal(got, want)
    old = _slice_sum_k(z)
    flips = (old != want).nonzero().tolist()
    assert flips, "the seed no longer shows the fault"
    for m, r in flips:
        # the slice sum lies on the other side of the rounding boundary:
        # one bf16 ulp apart, and the exact value is nearer to kpos
        assert abs(old[m, r] - want[m, r]) == 2.0 ** -8
        assert abs(want[m, r] - exact[m, r]) < abs(old[m, r] - exact[m, r])


def test_twin_reads_kpos_at_the_positive_pairs():
    """The twin with the slice sums' rounding in place of kpos moves dz
    only in the rows of the flipped pairs (both rows of each, in their
    modality), dalpha only there, and dbeta of those modalities."""
    z, alpha, beta, v, coef = _flip_inputs()
    lse = tsl.mixture_lse_twin(z, alpha, beta, v, TAU)
    new = tsl.mixture_grad_twin(z, alpha, beta, lse, coef, v, TAU)
    old_k = _slice_sum_k(z)
    orig = tsl.positive_k
    tsl.positive_k = lambda zz: old_k
    try:
        old = tsl.mixture_grad_twin(z, alpha, beta, lse, coef, v, TAU)
    finally:
        tsl.positive_k = orig
    flipped = old_k != tsl.positive_k(z)                       # (M, 2B)
    rows_moved = (new[0] != old[0]).any(dim=2)                  # (M, 2B)
    assert torch.equal(rows_moved, flipped)
    assert torch.equal((new[1] != old[1]).T, flipped)
    assert torch.equal(new[2] != old[2], flipped.any(dim=1))


def _f32_w_positive(z, alpha, beta, lse, coef, v):
    """W_tot at the positive pairs (M, 2B) as the twin formed it before
    ``positive_w``: its f32 dense formula (with kpos), rounded to bf16."""
    inv_tau = 1.0 / TAU
    m, n2, _ = z.shape
    rows = torch.arange(n2)
    pos = tsl.positive_rows(n2, "cpu")
    ch = tsl._channels(z, alpha, beta)
    k_b = ch[:m].to(torch.bfloat16).to(torch.float32)
    k_b[:, rows, pos] = tsl.positive_k(z)
    s = torch.cat([k_b, ch[m:]]) * inv_tau
    neq = tsl._off_diagonal(n2, "cpu")
    onehot = (rows[None, :] == pos[:, None]).to(torch.float32)
    p_row = torch.exp(torch.clamp(s - lse[:, :, None], max=0.0))
    p_col = torch.exp(torch.clamp(s - lse[:, None, :], max=0.0))
    c_r, c_c = coef[:, :, None], coef[:, None, :]
    w = (neq[None] * (c_r * p_row * v[None, None, :]
                      + p_col * c_c * v[None, :, None])
         - onehot[None] * (c_r + c_c)) * inv_tau
    aa = alpha.T[:, :, None] * alpha.T[:, None, :]
    w_tot = w[:m] + w[m][None] * aa + w[m + 1][None] * beta[:, None, None]
    return w_tot[:, rows, pos].to(torch.bfloat16).to(torch.float32)


def test_positive_w_is_one_rounding_of_the_pallas_formula_in_f64():
    """wpos is the Pallas formula (``_w_channel``, ``_mix_grad_kernel``)
    evaluated in f64 on dense channels of exact dots, with kpos as the own
    channel's K, read at the positive pairs and rounded once."""
    for seed in (WFLIP_SEED, FLIP_SEED):
        z, alpha, beta, v, coef = _flip_inputs(seed)
        lse = tsl.mixture_lse_twin(z, alpha, beta, v, TAU)
        kpos = tsl.positive_k(z)
        got = tsl.positive_w(z, alpha, beta, lse, coef, v, TAU, kpos)
        zd = z.double().numpy()
        a, b = alpha.double().numpy(), beta.double().numpy()
        lse_d, coef_d, v_d = (t.double().numpy() for t in (lse, coef, v))
        n2 = 2 * B
        k = np.einsum("mrd,mcd->mrc", zd, zd)              # exact dots
        mix_a = np.einsum("rm,cm,mrc->rc", a, a, k)
        mix_f = np.einsum("m,mrc->rc", b, k)
        pos = tsl.positive_rows(n2, "cpu").numpy()
        rows = np.arange(n2)
        k[:, rows, pos] = kpos.double().numpy()
        neq = (rows[:, None] != rows[None, :]).astype(np.float64)
        onehot = (rows[None, :] == pos[:, None]).astype(np.float64)
        inv_tau = float(np.float32(1.0 / TAU))

        def w_channel(ch, kk):
            s = kk * inv_tau
            p_row = np.exp(np.minimum(s - lse_d[ch][:, None], 0.0))
            p_col = np.exp(np.minimum(s - lse_d[ch][None, :], 0.0))
            c_r, c_c = coef_d[ch][:, None], coef_d[ch][None, :]
            return (neq * (c_r * p_row * v_d[None, :]
                           + p_col * c_c * v_d[:, None])
                    - onehot * (c_r + c_c)) * inv_tau

        w_a, w_f = w_channel(M, mix_a), w_channel(M + 1, mix_f)
        want = np.stack([(w_channel(m, k[m]) + w_a * np.outer(a[:, m], a[:, m])
                          + w_f * b[m])[rows, pos] for m in range(M)])
        assert torch.equal(got, tsl.round_bf16_once(torch.from_numpy(want)))


def test_twin_reads_wpos_at_the_positive_pairs_only():
    """At ``WFLIP_SEED`` the twin's own f32 W_tot rounds a positive pair's
    entry to the other side of the exact value; with that rounding in
    place of wpos, dz moves in exactly the rows of the flipped entries, and
    dalpha and dbeta, which read no bf16 W, not at all."""
    z, alpha, beta, v, coef = _flip_inputs(WFLIP_SEED)
    lse = tsl.mixture_lse_twin(z, alpha, beta, v, TAU)
    kpos = tsl.positive_k(z)
    wpos = tsl.positive_w(z, alpha, beta, lse, coef, v, TAU, kpos)
    old_w = _f32_w_positive(z, alpha, beta, lse, coef, v)
    flipped = old_w != wpos                                    # (M, 2B)
    assert flipped.any(), "the seed no longer shows the fault"
    # one bf16 ulp apart
    ulp = (wpos.view(torch.int32) - old_w.view(torch.int32)).abs()
    assert bool((ulp[flipped] == 0x10000).all())
    new = tsl.mixture_grad_twin(z, alpha, beta, lse, coef, v, TAU)
    orig = tsl.positive_w
    tsl.positive_w = lambda *args: old_w
    try:
        old = tsl.mixture_grad_twin(z, alpha, beta, lse, coef, v, TAU)
    finally:
        tsl.positive_w = orig
    assert torch.equal((new[0] != old[0]).any(dim=2), flipped)
    assert torch.equal(new[1], old[1])
    assert torch.equal(new[2], old[2])


def _pallas_grads(seed):
    """The JAX package's bf16 mixture kernels (Pallas, interpret mode, one
    64-row tile pair a step) at ``seed``, fed the twin's lse."""
    z, alpha, beta, v, coef = _flip_inputs(seed)
    lse = tsl.mixture_lse_twin(z, alpha, beta, v, TAU)
    c_pad = sk.C_PAD
    a_l = np.zeros((2 * B, 128), np.float32)
    a_l[:, :M] = alpha.numpy()
    b_l = np.zeros((1, 128), np.float32)
    b_l[0, :M] = beta.numpy()

    def rows(x):
        out = np.zeros((c_pad, 2 * B), np.float32)
        out[:M + 2] = x.numpy()
        return jnp.asarray(out)
    with pallas_interpret():
        sk.RT_B = 64            # pallas_interpret restores it on exit
        dz, da, db = sk.mixture_grad(
            jnp.asarray(z.float().numpy(), jnp.bfloat16), jnp.asarray(a_l),
            jnp.asarray(b_l), rows(lse), rows(coef),
            jnp.asarray(v.numpy()[None]), M, TAU)
    want = (np.asarray(dz), np.asarray(da)[:, :M], np.asarray(db)[0, :M])
    return (z, alpha, beta, lse, coef, v), want


@pytest.fixture(scope="module")
def pallas_grads():
    return _pallas_grads(FLIP_SEED)


@pytest.fixture(scope="module")
def pallas_grads_wflip():
    return _pallas_grads(WFLIP_SEED)


def test_twin_with_kpos_matches_pallas_bf16_at_the_flip(pallas_grads):
    """Within PR 13's bf16 limit of the Pallas kernel, which rounds its
    own f32 sum at the positive pairs (at most one bf16 ulp from kpos)."""
    (z, alpha, beta, lse, coef, v), want = pallas_grads
    got = tsl.mixture_grad_twin(z, alpha, beta, lse, coef, v, TAU)
    for a, w, name in zip(got, want, ("dz", "dalpha", "dbeta")):
        assert_close_bf16(a, w, name)


def test_twin_with_wpos_matches_pallas_bf16_at_the_w_flip(pallas_grads_wflip):
    """Within the bf16 limit of the Pallas kernel, which rounds its
    own f32 W_tot at the positive pairs (at most one bf16 ulp from wpos)."""
    (z, alpha, beta, lse, coef, v), want = pallas_grads_wflip
    got = tsl.mixture_grad_twin(z, alpha, beta, lse, coef, v, TAU)
    for a, w, name in zip(got, want, ("dz", "dalpha", "dbeta")):
        assert_close_bf16(a, w, name)
