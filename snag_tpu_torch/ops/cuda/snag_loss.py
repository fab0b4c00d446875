"""SNAG's fused loss bundle: CUDA kernels and their dense twins.

Kernels: ``csrc/snag_loss.cu``, replacing
``snag_tpu/ops/pallas/snag_loss_kernel.py::mixture_lse`` and
``::mixture_grad``.  For M modality batches of paired unit rows,
z = [zis ; zjs] (M, 2B, d), K_m = z_m z_m^T, alpha (2B, M) and beta (M,)
unit mixture coefficients, the M + 2 channels are
[K_0 .. K_{M-1} | mix_a | mix_f] with mix_a = sum_m a_r,m a_c,m K_m and
mix_f = sum_m beta_m K_m, and S = channel / tau:

* lse[ch, r] = log(sum_{c != r} v[c] exp(S - 1/tau) + 1e-30) + 1/tau (a
  static max: |S| <= 1/tau);
* with W_ch the G + G^T weight of ``_w_channel`` (snag_loss_kernel.py
  :149-157): dz_m = (W_m + W_a a_r,m a_c,m + W_f beta_m) z_m,
  dalpha[r, m] = sum_c W_a a_c,m K_m, dbeta_m = 1/2 sum W_f K_m.

The port's shapes: alpha (2B, M), beta (M,), lse and coef (M + 2, 2B); B
is not padded, the positive partner of row r is r +/- B.

Both run on the tensor cores in 3xTF32 and are bound by operations at
495 / 3 TFLOP/s on an H100 SXM: their products are ``mma.sync`` on hi =
rna_tf32(x), lo = rna_tf32(x - hi) as lo hi + hi lo + hi hi in fp32, as
close to the twin as fp32 products; one TF32 product misses the 1e-5 lse
limit and the 1e-4 gradient limit on dz (tests/test_torch_tf32x3.py).
``mixture_lse`` is the lse kernel it shares with NT-Xent
(``csrc/gram_lse.cuh``): a block takes one unordered pair of row tiles
and every modality, so each element of every symmetric channel is
computed once, and its scratch (``lse_plan``) holds the row partials of
every pair and channel, added in a fixed order.  ``mixture_grad`` computes
each K tile once into registers, the (modalities x 32 rows x d) row
accumulator lives in shared memory (``modality_group`` splits the
modalities where it would not fit), and its scratch
(``mixture_grad_scratch``) holds the partials of blocks that share a row
tile's columns.  Past one modality's fit in that accumulator (d past
~1,500) the same function runs on the body's wide path,
``mixture_grad_wide`` (counted apart, ``STATS_GRAD_WIDE``): the blocks of
a row tile's modalities and feature chunks form a thread-block cluster in
which each block computes its own modality's share of K once and the
weights of a share of the rows for every modality, read by the others
from its shared memory (the library plans both bodies; ``grad_plan``'s
``wide`` says which one runs).

Twins: ``mixture_lse_twin`` and ``mixture_grad_twin``, the same formulas
on the dense (M + 2, 2B, 2B) channels of ``_bundle_channels``
(snag_tpu/losses/contrastive.py:390-408).

bf16: a bf16 z (the JAX package's matmul dtype under ``--dtype bfloat16``,
snag.py:86-87, 168-170) takes ``mixture_lse_bf16``, the lse kernel built
for bf16 (``csrc/gram_lse_bf16.cuh``: persistent blocks that walk the
tile pairs, every modality over a pair, a ring of 64-feature slabs that
runs on across modalities and pairs; ``lse_plan``), and
``mixture_grad_bf16``, the gradient kernel built for bf16
(``csrc/gram_grad_bf16.cuh``: a block owns 128 rows of one modality's dz
in registers, in feature chunks past d = 304, and the M blocks of a row
block form a cluster that shares each modality's K tile for the
mixtures), counted apart
(``STATS_LSE_BF16``, ``STATS_GRAD_BF16``).  The bf16 gradient has no
modality groups; ``grad_plan_bf16`` says how it
runs.
The rounding points are the Pallas kernels' (snag_loss_kernel.py:185-226):
K from the bf16 operands in f32; mix_a and mix_f from that f32 K; each
modality's own weight W_m, its dalpha term and its dbeta term from K
rounded to bf16 (the kernel keeps its K tiles in z's dtype, :191, :297);
W_tot rounded to bf16 before W_tot z (:214).  alpha, beta, lse, coef and
every output are f32.  The twin takes K the kernels' way (``ntxent.gram``:
16-wide feature slices added in order), as W_tot's rounding makes dz
sensitive to the last bits of mix_a and mix_f.

Two rounding points differ from the Pallas kernel's, both at a row's
positive partner pos(r), where each side would otherwise round an f32
value that it forms in its own order:

* where W_m, dalpha and dbeta read the own-channel K, both the kernel and
  the twin take ``positive_k``, the exact dot <z_m[r], z_m[pos(r)]>
  (products of bf16 values are exact in f32, their sum in f64) rounded
  once to bf16.  A positive pair's K (~0.9) whose f32 last bits sit on a
  bf16 boundary rounded apart in the kernel (its mma order) and the twin
  (its slice sums); at tau = 0.1 that one ulp moves the row's W_m by ~4 %.
* where W_tot is rounded to bf16 for dz, both take ``positive_w``:
  W_tot[m, r, pos(r)] in f64 from the exact dots of every modality, kpos,
  and the f32 lse, coef, v, alpha and beta both sides are fed, rounded
  once.  Its f32 input was formed apart (the mixtures' K sums, the
  kernel's ex2.approx against torch.exp), and the positive pair's W_tot,
  which carries -(coef_r + coef_c) / tau, is the largest entry of W, so
  one ulp of it moved a dz row beyond the card check's limit.

The Pallas kernel rounds its own f32 sums there, so the port lies at most
one bf16 ulp from it at those entries.  Every other entry keeps the Pallas
rounding point.  The kernel takes both from a small kernel of its own,
``mixture_kpos_bf16``, launched by ``mixture_grad_bf16``; dalpha and dbeta
have no bf16 rounding point of W and read no ``positive_w``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from snag_tpu_torch.ops.cuda._lib import (KernelStats, aligned16, check,
                                          dtype_suffix, load_library, ptr,
                                          require, stream_of)
from snag_tpu_torch.ops.cuda.ntxent import (GRAD_PLAN_BF16, GRAD_PLAN_F32,
                                            LSE_PLAN, LSE_PLAN_BF16, gram)

STATS_LSE = KernelStats("mixture_lse")
STATS_GRAD = KernelStats("mixture_grad")
STATS_LSE_BF16 = KernelStats("mixture_lse_bf16")
STATS_GRAD_BF16 = KernelStats("mixture_grad_bf16")
# the f32 gradient's launches on its wide path, past one modality's fit in
# the accumulator (``grad_plan``'s ``wide``)
STATS_GRAD_WIDE = KernelStats("mixture_grad_wide")
LSE_EPS = 1e-30
MAX_MOD = 6
FEATURE_TILE = 8                    # the accumulator's n8 feature tiles
_GRAD_CAP: Dict[int, int] = {}      # device index -> modalities x d limit


def _channels(z: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor
              ) -> torch.Tensor:
    """The dense (M + 2, 2B, 2B) channels [K_m | mix_a | mix_f], unscaled;
    K of a bf16 z as the kernels add it (``ntxent.gram``)."""
    k = gram(z)
    mix_a = torch.einsum("rm,cm,mrc->rc", alpha, alpha, k)
    mix_f = torch.einsum("m,mrc->rc", beta, k)
    return torch.cat([k, mix_a[None], mix_f[None]], dim=0)


def round_bf16_once(x: torch.Tensor) -> torch.Tensor:
    """Values of x (f64) rounded once to bf16 (to nearest, ties to even),
    returned as f32.  ``x.to(torch.bfloat16)`` on an f64 tensor rounds
    through f32, twice; rounding to f32 toward zero and setting the last
    bit where that was inexact (round to odd) keeps the information a
    single rounding to bf16 needs."""
    x = x.to(torch.float64)
    r = x.to(torch.float32)
    r = torch.where(r.to(torch.float64).abs() > x.abs(),
                    torch.nextafter(r, torch.zeros_like(r)), r)
    odd = (r.to(torch.float64) != x).to(torch.int32)
    r = (r.view(torch.int32) | odd).view(torch.float32)
    return r.to(torch.bfloat16).to(torch.float32)


def positive_rows(n2: int, device) -> torch.Tensor:
    """pos(r) = r + B or r - B, the positive partner of each row."""
    rows = torch.arange(n2, device=device)
    half = n2 // 2
    return torch.where(rows < half, rows + half, rows - half)


def positive_k(z: torch.Tensor) -> torch.Tensor:
    """kpos (M, 2B) f32: <z_m[r], z_m[pos(r)]> of a bf16 z, exact (f64
    sums of exact products), rounded once to bf16 (module docstring)."""
    z64 = z.to(torch.float64)
    pos = positive_rows(z.shape[1], z.device)
    return round_bf16_once((z64 * z64[:, pos]).sum(dim=2))


def positive_w(z: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor,
               lse: torch.Tensor, coef: torch.Tensor, v: torch.Tensor,
               tau: float, kpos: torch.Tensor) -> torch.Tensor:
    """wpos (M, 2B) f32: W_tot[m, r, pos(r)] of a bf16 z in f64, rounded
    once to bf16 (module docstring).  The Pallas formula (``_w_channel``,
    ``_mix_grad_kernel``) on the exact dots of the bf16 rows at (r, pos(r))
    for every modality: W_m reads ``kpos``, W_a the exact mix_a, W_f the
    exact mix_f; 1/tau as the kernel takes it, in f32."""
    f8 = torch.float64
    inv_tau = float(torch.tensor(1.0 / tau, dtype=torch.float32))
    z64 = z.to(f8)
    m = z.shape[0]
    pos = positive_rows(z.shape[1], z.device)
    k = (z64 * z64[:, pos]).sum(dim=2)                          # (M, 2B)
    a = alpha.to(f8)
    aa = a * a[pos]                                             # (2B, M)
    b = beta.to(f8)
    mix_a = torch.zeros_like(k[0])
    mix_f = torch.zeros_like(k[0])
    for i in range(m):
        mix_a = mix_a + aa[:, i] * k[i]
        mix_f = mix_f + b[i] * k[i]
    lse, coef, v = lse.to(f8), coef.to(f8), v.to(f8)

    def w(ch, kk):
        s = kk * inv_tau
        p_row = torch.exp(torch.clamp(s - lse[ch], max=0.0))
        p_col = torch.exp(torch.clamp(s - lse[ch][pos], max=0.0))
        c_r, c_c = coef[ch], coef[ch][pos]
        return (c_r * p_row * v[pos] + p_col * c_c * v
                - (c_r + c_c)) * inv_tau

    w_a, w_f = w(m, mix_a), w(m + 1, mix_f)
    w_tot = torch.stack([w(i, kpos[i].to(f8)) + w_a * aa[:, i] + w_f * b[i]
                         for i in range(m)])
    return round_bf16_once(w_tot)


def _off_diagonal(n2: int, device) -> torch.Tensor:
    return (~torch.eye(n2, dtype=torch.bool, device=device)).to(torch.float32)


def mixture_lse_twin(z: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor,
                     v: torch.Tensor, tau: float) -> torch.Tensor:
    """Plain version of ``mixture_lse``: (M + 2, 2B)."""
    inv_tau = 1.0 / tau
    s = _channels(z, alpha, beta) * inv_tau
    mask = _off_diagonal(z.shape[1], z.device)[None] * v[None, None, :]
    return torch.log(torch.sum(torch.exp(s - inv_tau) * mask, dim=2)
                     + LSE_EPS) + inv_tau


def mixture_grad_twin(z: torch.Tensor, alpha: torch.Tensor,
                      beta: torch.Tensor, lse: torch.Tensor,
                      coef: torch.Tensor, v: torch.Tensor, tau: float
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of ``mixture_grad``: (dz (M, 2B, d), dalpha (2B, M),
    dbeta (M,)); for a bf16 z with the Pallas kernel's roundings (module
    docstring)."""
    inv_tau = 1.0 / tau
    m, n2, _ = z.shape
    ch = _channels(z, alpha, beta)
    bf16 = z.dtype == torch.bfloat16
    rows = torch.arange(n2, device=z.device)
    pos = positive_rows(n2, z.device)
    if bf16:
        kpos = positive_k(z)
        wpos = positive_w(z, alpha, beta, lse, coef, v, tau, kpos)
        k_b = ch[:m].to(torch.bfloat16).to(torch.float32)
        k_b[:, rows, pos] = kpos
        ch = torch.cat([k_b, ch[m:]])
        z = z.to(torch.float32)
    k = ch[:m]
    s = ch * inv_tau
    neq = _off_diagonal(n2, z.device)
    onehot = (rows[None, :] == pos[:, None]).to(torch.float32)
    p_row = torch.exp(torch.clamp(s - lse[:, :, None], max=0.0))
    p_col = torch.exp(torch.clamp(s - lse[:, None, :], max=0.0))
    coef_r, coef_c = coef[:, :, None], coef[:, None, :]
    w = (neq[None] * (coef_r * p_row * v[None, None, :]
                      + p_col * coef_c * v[None, :, None])
         - onehot[None] * (coef_r + coef_c)) * inv_tau      # (M + 2, 2B, 2B)
    w_a, w_f = w[m], w[m + 1]
    aa = alpha.T[:, :, None] * alpha.T[:, None, :]           # (M, 2B, 2B)
    w_tot = w[:m] + w_a[None] * aa + w_f[None] * beta[:, None, None]
    if bf16:
        w_tot = w_tot.to(torch.bfloat16).to(torch.float32)
        w_tot[:, rows, pos] = wpos
    dz = torch.bmm(w_tot, z)
    dalpha = torch.einsum("rc,cm,mrc->rm", w_a, alpha, k)
    dbeta = 0.5 * torch.einsum("rc,mrc->m", w_f, k)
    return dz, dalpha, dbeta


def _library():
    built = load_library("snag_loss")
    lib = built.lib
    if lib.mixture_lse.argtypes is None:
        for sfx in ("", "_bf16"):
            fn = getattr(lib, f"mixture_lse{sfx}")
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 \
                + [ctypes.c_float, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            fn = getattr(lib, f"mixture_lse{sfx}_plan")
            fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
            fn.restype = ctypes.c_long
            # the bf16 gradient takes no modality group
            fn = getattr(lib, f"mixture_grad{sfx}")
            fn.argtypes = [ctypes.c_void_p] * 10 \
                + [ctypes.c_int] * (3 if sfx else 4) \
                + [ctypes.c_float, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.mixture_grad_scratch.argtypes = [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        lib.mixture_grad_scratch.restype = ctypes.c_long
        lib.mixture_grad_bf16_plan.argtypes = [ctypes.c_int] * 3 \
            + [ctypes.c_void_p]
        lib.mixture_grad_bf16_plan.restype = ctypes.c_long
        lib.mixture_grad_init.argtypes = []
        lib.mixture_grad_init.restype = ctypes.c_int
    return built


def _suffix(dtype: torch.dtype) -> str:
    return dtype_suffix(dtype, "mixture kernels")


def lse_plan(m: int, n2: int, d: int, device: torch.device,
             dtype: torch.dtype = torch.float32) -> Dict[str, int]:
    """How ``mixture_lse`` (``mixture_lse_bf16`` for a bf16 ``dtype``)
    runs at (m, n2, d) on ``device``: its tile, tile pairs (f32: blocks),
    blocks per SM, floats of scratch and, for bf16, the persistent blocks
    that walk the pairs, the ring's slots, the features a slot and warps a
    block."""
    built = _library()
    name = f"mixture_lse{_suffix(dtype)}_plan"
    keys = LSE_PLAN_BF16 if dtype == torch.bfloat16 else LSE_PLAN
    out = (ctypes.c_int * len(keys))()
    with torch.cuda.device(device):
        floats = getattr(built.lib, name)(m, n2, d, out)
    if floats < 0:
        check(built, -floats, name)
    return dict(zip(keys, out), scratch=floats)


def grad_plan_bf16(m: int, n2: int, d: int,
                   device: torch.device) -> Dict[str, int]:
    """How ``mixture_grad_bf16`` runs at (m, n2, d) on ``device``: its
    feature chunks, ring depth, column splits, blocks per SM, rows per
    block, whether they stay resident, blocks a cluster (M: the modalities
    of a row block) and floats of scratch."""
    built = _library()
    out = (ctypes.c_int * len(GRAD_PLAN_BF16))()
    with torch.cuda.device(device):
        floats = built.lib.mixture_grad_bf16_plan(m, n2, d, out)
    if floats < 0:
        check(built, -floats, "mixture_grad_bf16_plan")
    return dict(zip(GRAD_PLAN_BF16, out), scratch=floats)


def _grad_cap(built, device: torch.device) -> int:
    """The largest (modalities per block) x d of the fp32 gradient kernel's
    shared row accumulator on ``device``, set up there at the first call."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    if index not in _GRAD_CAP:
        cap = built.lib.mixture_grad_init()
        if cap < 0:
            check(built, -cap, "mixture_grad_init")
        _GRAD_CAP[index] = cap
    return _GRAD_CAP[index]


def modality_group(m: int, d: int, cap: int) -> Tuple[int, bool]:
    """(modalities a block, past the cap) of the fp32 gradient kernel's
    main-path body, whose shared accumulator holds ``cap`` columns: as few
    groups of modalities as it allows, of balanced size, each of d's
    feature tiles whole; where one modality's d does not fit, one modality
    a block and True (the wide body runs)."""
    tiles, cap_tiles = -(-d // FEATURE_TILE), cap // FEATURE_TILE
    most = min(m, cap_tiles // tiles)
    if most < 1:
        return 1, True
    groups = -(-m // most)
    return -(-m // groups), False


def grad_plan(m: int, n2: int, d: int,
              device: torch.device) -> Dict[str, int]:
    """How the f32 ``mixture_grad`` runs at (m, n2, d) on ``device``: its
    modalities a block (``mg``, ``modality_group``'s), feature chunks, ring
    depth, column splits, blocks per SM, floats of scratch, and ``wide``: 1
    past one modality's fit in the main-path body's accumulator, where the
    wide body runs, with its blocks a cluster, cluster groups and depth
    slices ``q``."""
    built = _library()
    mg, _ = modality_group(m, d, _grad_cap(built, device))
    out = (ctypes.c_int * len(GRAD_PLAN_F32))()
    with torch.cuda.device(device):
        floats = built.lib.mixture_grad_scratch(m, mg, n2, d, out)
    if floats < 0:
        check(built, -floats, "mixture_grad_scratch")
    return dict(zip(GRAD_PLAN_F32, out), mg=mg, scratch=floats)


def _check(z, alpha, beta, v):
    dev = z.device
    if dev.type != "cuda":
        raise ValueError(f"the mixture kernels need CUDA tensors, got {dev}")
    if z.dim() != 3 or z.shape[1] % 2:
        raise ValueError(f"z must be (M, 2B, d), got {tuple(z.shape)}")
    m, n2, d = z.shape
    if not 1 <= m <= MAX_MOD:
        raise ValueError(f"{m} modalities; the mixture kernels take "
                         f"1..{MAX_MOD}")
    _suffix(z.dtype)
    require(z, "z", z.dtype, (m, n2, d), dev)
    require(alpha, "alpha", torch.float32, (n2, m), dev)
    require(beta, "beta", torch.float32, (m,), dev)
    require(v, "v", torch.float32, (n2,), dev)
    return m, n2, d


def mixture_lse_cuda(z: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor,
                     v: torch.Tensor, tau: float) -> torch.Tensor:
    """Launch ``mixture_lse`` (f32 z) or ``mixture_lse_bf16`` (bf16 z):
    lse (M + 2, 2B) f32."""
    m, n2, d = _check(z, alpha, beta, v)
    built = _library()
    stats = STATS_LSE_BF16 if z.dtype == torch.bfloat16 else STATS_LSE
    if z.dtype == torch.bfloat16:
        z = aligned16(z)
    plan = lse_plan(m, n2, d, z.device, z.dtype)
    with torch.cuda.device(z.device):
        lse = torch.empty(m + 2, n2, dtype=torch.float32, device=z.device)
        part = torch.empty(plan["scratch"], dtype=torch.float32,
                           device=z.device)
        err = getattr(built.lib, stats.name)(
            ptr(z), ptr(alpha), ptr(beta), ptr(v), ptr(part), ptr(lse), m, n2,
            d, 1.0 / tau, stream_of(z))
    check(built, err, stats.name)
    stats.launches += 1
    return lse


def mixture_grad_cuda(z: torch.Tensor, alpha: torch.Tensor,
                      beta: torch.Tensor, lse: torch.Tensor,
                      coef: torch.Tensor, v: torch.Tensor, tau: float
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch ``mixture_grad`` (f32 z; counted as ``mixture_grad_wide`` on
    the wide body) or ``mixture_grad_bf16`` (bf16 z): (dz (M, 2B, d),
    dalpha (2B, M), dbeta (M,)), all f32."""
    m, n2, d = _check(z, alpha, beta, v)
    require(lse, "lse", torch.float32, (m + 2, n2), z.device)
    require(coef, "coef", torch.float32, (m + 2, n2), z.device)
    built = _library()
    bf16 = z.dtype == torch.bfloat16
    stats = STATS_GRAD_BF16 if bf16 else STATS_GRAD
    name = f"mixture_grad{_suffix(z.dtype)}"
    with torch.cuda.device(z.device):
        if bf16:
            z = aligned16(z)
            floats = grad_plan_bf16(m, n2, d, z.device)["scratch"]
            shape = (m, n2, d)
        else:
            plan = grad_plan(m, n2, d, z.device)
            floats = plan["scratch"]
            if plan["wide"]:
                stats = STATS_GRAD_WIDE
            shape = (m, plan["mg"], n2, d)
        dz = torch.empty(m, n2, d, dtype=torch.float32, device=z.device)
        dalpha = torch.empty(n2, m, dtype=torch.float32, device=z.device)
        dbeta = torch.empty(m, dtype=torch.float32, device=z.device)
        part = torch.empty(floats, dtype=torch.float32, device=z.device)
        err = getattr(built.lib, name)(
            ptr(z), ptr(alpha), ptr(beta), ptr(lse), ptr(coef), ptr(v),
            ptr(dz), ptr(dalpha), ptr(dbeta), ptr(part), *shape,
            1.0 / tau, stream_of(z))
    check(built, err, name)
    stats.launches += 1
    return dz, dalpha, dbeta


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"no mixture-loss path for device {t.device}")
    return False


def mixture_lse(z: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor,
                v: torch.Tensor, tau: float) -> torch.Tensor:
    """(M + 2, 2B) channel row-logsumexps: the kernel for CUDA tensors, the
    twin for CPU tensors; z f32 or bf16."""
    if _on_cpu(z):
        _suffix(z.dtype)
        (STATS_LSE_BF16 if z.dtype == torch.bfloat16
         else STATS_LSE).twin_calls += 1
        return mixture_lse_twin(z, alpha, beta, v, tau)
    return mixture_lse_cuda(z, alpha, beta, v, tau)


def mixture_grad(z, alpha, beta, lse, coef, v, tau
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradient of sum_ch sum_r coef[ch, r] (lse[ch, r] - pos[ch, r]); coef
    folds the cotangent, ab_weight, row weights and 1/denom.  Returns
    (dz, dalpha, dbeta), f32."""
    if _on_cpu(z):
        _suffix(z.dtype)
        (STATS_GRAD_BF16 if z.dtype == torch.bfloat16
         else STATS_GRAD).twin_calls += 1
        return mixture_grad_twin(z, alpha, beta, lse, coef, v, tau)
    return mixture_grad_cuda(z, alpha, beta, lse, coef, v, tau)
