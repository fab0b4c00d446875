"""Streaming batched NT-Xent: CUDA kernels and their dense twins.

Kernels: ``csrc/ntxent.cu``, replacing
``snag_tpu/ops/pallas/ntxent_kernel.py::streaming_lse`` (``ntxent_lse``) and
``::streaming_ntxent_grad`` (``ntxent_grad``).  For M batches of paired
unit rows zis/zjs (M, B, d), z = [zis ; zjs] (M, 2B, d), S = z z^T / tau:

* lse[r] = log(sum_{c != r} v[c] exp(S[r, c] - 1/tau) + 1e-30) + 1/tau, a
  static max because |S| <= 1/tau; columns are masked, rows are not (an
  invalid row keeps a finite value that its zero coefficient removes);
* dz = W z, W = ((c != r)(coef_r p_row v_c + p_col coef_c v_r)
  - [c == pos(r)](coef_r + coef_c)) / tau with p = exp(min(S - lse, 0))
  and pos(r) = r +/- B.

The JAX package pads B to its TPU tile; padded rows there carry zero
validity and zero coefficients, so the port keeps B as it is and the
positive partner sits at r +/- B.

Both run on the tensor cores in 3xTF32 and are bound by operations at
495 / 3 TFLOP/s on an H100 SXM.  ``ntxent_lse`` is the lse kernel it
shares with the mixture lse (``csrc/gram_lse.cuh``): a block takes one
unordered pair of row tiles, so each element of the symmetric S is
computed once, and its scratch (``lse_plan``) holds the row partials of
every pair, added in a fixed order.  ``ntxent_grad`` is the gradient
kernel it shares with the mixture gradient (``csrc/gram_grad.cuh``), and
its scratch (``ntxent_grad_plan``) holds the partials of blocks that share
a row tile's columns.  Past what that kernel's accumulator of d columns
holds (d > 1,504 on the H100) the same function runs on the body's wide
path, ``ntxent_grad_wide`` (counted apart, ``STATS_GRAD_WIDE``): the
blocks of a row tile's feature chunks form a thread-block cluster that
splits K's depth, so that K and W are computed once per tile pair and
each block's accumulator leaves two blocks an SM.  The library plans
both bodies (``grad_plan``'s ``wide`` says which one runs).

Twins: ``streaming_lse_twin`` and ``ntxent_grad_twin``, the same formulas
on the dense (M, 2B, 2B) matrix.

bf16: a bf16 z (the JAX package's matmul dtype under ``--dtype bfloat16``,
contrastive.py:364-366) takes ``ntxent_lse_bf16``, the lse kernel built for
bf16 (``csrc/gram_lse_bf16.cuh``: persistent blocks that walk the tile
pairs, a ring of 64-feature slabs that runs on across pairs, z padded to
16-byte rows where d % 8 != 0; ``lse_plan`` says how it runs), and
``ntxent_grad_bf16``, the gradient
kernel built for bf16 (``csrc/gram_grad_bf16.cuh``: 128-row blocks, W and
dz in registers, the rows resident up to d = 304), counted apart
(``STATS_LSE_BF16``, ``STATS_GRAD_BF16``).  The rounding points are
the Pallas kernels': S from the bf16 operands in f32 (their products are
exact), everything after it f32, and the gradient's W rounded to bf16
before W z (ntxent_kernel.py:157); lse and dz are f32.

W's rounding makes dz sensitive to S's last bits: two f32 evaluations of
S whose sums differ by an ulp can round an element of W apart, which
moves a row of dz by a bf16 ulp of that element, as much as the card
check's 4e-3 x max when it is the positive pair's.  So the twin takes a
bf16 z's Gram matrix the way the kernels do (``gram``): per 16-wide
feature slice from zero, the slices added in f32 in feature order; it
differs from a kernel only in how each 16-term slice sum is rounded.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from snag_tpu_torch.ops.cuda._lib import (KernelStats, aligned16, check,
                                          dtype_suffix, load_library, ptr,
                                          require, stream_of)

STATS_LSE = KernelStats("ntxent_lse")
STATS_GRAD = KernelStats("ntxent_grad")
STATS_LSE_BF16 = KernelStats("ntxent_lse_bf16")
STATS_GRAD_BF16 = KernelStats("ntxent_grad_bf16")
# the f32 gradient's launches on its wide path (``grad_plan``'s ``wide``)
STATS_GRAD_WIDE = KernelStats("ntxent_grad_wide")
LSE_EPS = 1e-30


def stack(zis: torch.Tensor, zjs: torch.Tensor,
          valid: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """(M, B, d) pair + (B,) mask -> z (M, 2B, d), v (2B,) f32."""
    b = zis.shape[1]
    z = torch.cat([zis, zjs], dim=1).contiguous()
    vf = (torch.ones(b, dtype=torch.float32, device=zis.device)
          if valid is None else valid.to(torch.float32))
    return z, torch.cat([vf, vf]).contiguous()


KSLICE = 16     # the bf16 kernels' k16 steps (mma.sync m16n8k16)
# the bf16 gradients' W z (csrc/gram_grad_bf16.cuh): a column tile's
# WZ_COLS / KSLICE k16 slices accumulate from zero in one mma.sync
# accumulator, and each tile's sum is added in f32 in column order
WZ_COLS = 64


def gram(z: torch.Tensor) -> torch.Tensor:
    """K = z z^T (M, 2B, 2B).  A bf16 z enters as f32, where its products
    are exact, one ``KSLICE``-wide feature slice at a time, the slices
    added in feature order (the kernels' order)."""
    if z.dtype != torch.bfloat16:
        return torch.einsum("mrd,mcd->mrc", z, z)
    z = z.to(torch.float32)
    k = None
    for k0 in range(0, z.shape[2], KSLICE):
        zs = z[:, :, k0:k0 + KSLICE]
        part = torch.einsum("mrd,mcd->mrc", zs, zs)
        k = part if k is None else k + part
    return k


def _dense(z: torch.Tensor, inv_tau: float):
    """(S (M, 2B, 2B), off-diagonal indicator (2B, 2B) f32)."""
    n2 = z.shape[1]
    s = gram(z) * inv_tau
    neq = ~torch.eye(n2, dtype=torch.bool, device=z.device)
    return s, neq.to(torch.float32)


def streaming_lse_twin(z: torch.Tensor, v: torch.Tensor,
                       tau: float) -> torch.Tensor:
    """Plain version of ``ntxent_lse``: (M, 2B) from the dense S."""
    inv_tau = 1.0 / tau
    s, neqf = _dense(z, inv_tau)
    mask = neqf[None] * v[None, None, :]
    return torch.log(torch.sum(torch.exp(s - inv_tau) * mask, dim=2)
                     + LSE_EPS) + inv_tau


def ntxent_grad_twin(z: torch.Tensor, lse: torch.Tensor, coef: torch.Tensor,
                     v: torch.Tensor, tau: float) -> torch.Tensor:
    """Plain version of ``ntxent_grad``: dz (M, 2B, d) = W z; for a bf16 z
    W is rounded to bf16 first."""
    inv_tau = 1.0 / tau
    n2 = z.shape[1]
    s, neqf = _dense(z, inv_tau)
    rows = torch.arange(n2, device=z.device)
    half = n2 // 2
    pos = torch.where(rows < half, rows + half, rows - half)
    onehot = (rows[None, :] == pos[:, None]).to(torch.float32)
    lse_r, lse_c = lse[:, :, None], lse[:, None, :]
    coef_r, coef_c = coef[:, :, None], coef[:, None, :]
    p_row = torch.exp(torch.clamp(s - lse_r, max=0.0))
    p_col = torch.exp(torch.clamp(s - lse_c, max=0.0))
    w = (neqf[None] * (coef_r * p_row * v[None, None, :]
                       + p_col * coef_c * v[None, :, None])
         - onehot[None] * (coef_r + coef_c)) * inv_tau
    if z.dtype == torch.bfloat16:
        return torch.bmm(w.to(torch.bfloat16).to(torch.float32),
                         z.to(torch.float32))
    return torch.bmm(w, z)


def _library():
    built = load_library("ntxent")
    lib = built.lib
    if lib.ntxent_lse.argtypes is None:
        for lse, grad in (("ntxent_lse", "ntxent_grad"),
                          ("ntxent_lse_bf16", "ntxent_grad_bf16")):
            fn = getattr(lib, lse)
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 \
                + [ctypes.c_float, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            fn = getattr(lib, grad)
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 \
                + [ctypes.c_float, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            for plan in (f"{lse}_plan", f"{grad}_plan"):
                fn = getattr(lib, plan)
                fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
                fn.restype = ctypes.c_long
    return built


def _suffix(dtype: torch.dtype) -> str:
    return dtype_suffix(dtype, "NT-Xent kernels")


LSE_PLAN = ("tile", "pairs", "blocks_per_sm")
# the bf16 lse's persistent blocks, ring slots, features a slot and warps
# a block (csrc/gram_lse_bf16.cuh)
LSE_PLAN_BF16 = LSE_PLAN + ("blocks", "depth", "slab", "warps")


def lse_plan(m: int, n2: int, d: int, device: torch.device,
             dtype: torch.dtype = torch.float32) -> Dict[str, int]:
    """How ``ntxent_lse`` (``ntxent_lse_bf16`` for a bf16 ``dtype``) runs
    at (m, n2, d) on ``device``: its tile, tile pairs (f32: blocks per
    batch), blocks per SM, floats of scratch and, for bf16, the persistent
    blocks that walk the pairs of every batch, the ring's slots, the
    features a slot and warps a block."""
    built = _library()
    name = f"ntxent_lse{_suffix(dtype)}_plan"
    keys = LSE_PLAN_BF16 if dtype == torch.bfloat16 else LSE_PLAN
    out = (ctypes.c_int * len(keys))()
    with torch.cuda.device(device):
        floats = getattr(built.lib, name)(m, n2, d, out)
    if floats < 0:
        check(built, -floats, name)
    return dict(zip(keys, out), scratch=floats)


GRAD_PLAN = ("chunks", "depth", "splits", "blocks_per_sm")
# the bf16 gradient's plan also says how many rows a block owns, whether
# they stay resident in shared memory and how many blocks form a cluster
# (csrc/gram_grad_bf16.cuh)
GRAD_PLAN_BF16 = GRAD_PLAN + ("rows", "resident", "cluster")
# the f32 gradients' (csrc/gram_grad.cuh GradPlan): whether the wide body
# runs, and there its blocks a cluster, cluster groups and depth slices of
# K (1, 1 and 1 on the main-path body)
GRAD_PLAN_F32 = GRAD_PLAN + ("wide", "cluster", "groups", "q")


def grad_plan(m: int, n2: int, d: int, device: torch.device,
              dtype: torch.dtype = torch.float32) -> Dict[str, int]:
    """How ``ntxent_grad`` (``ntxent_grad_bf16`` for a bf16 ``dtype``) runs
    at (m, n2, d) on ``device``: its feature chunks, ring depth, column
    splits, blocks per SM, floats of scratch and, for bf16, rows per block,
    whether they stay resident and blocks a cluster; f32: ``wide`` (1 past
    the main-path body's accumulator, where the wide body runs), and its
    blocks a cluster, cluster groups and depth slices ``q``."""
    built = _library()
    name = f"ntxent_grad{_suffix(dtype)}_plan"
    keys = GRAD_PLAN_BF16 if dtype == torch.bfloat16 else GRAD_PLAN_F32
    out = (ctypes.c_int * len(keys))()
    with torch.cuda.device(device):
        floats = getattr(built.lib, name)(m, n2, d, out)
    if floats < 0:
        check(built, -floats, name)
    return dict(zip(keys, out), scratch=floats)


def _check_z(z: torch.Tensor, v: torch.Tensor):
    dev = z.device
    if dev.type != "cuda":
        raise ValueError(f"the NT-Xent kernels need CUDA tensors, got {dev}")
    if z.dim() != 3 or z.shape[1] % 2:
        raise ValueError(f"z must be (M, 2B, d), got {tuple(z.shape)}")
    m, n2, d = z.shape
    _suffix(z.dtype)
    require(z, "z", z.dtype, (m, n2, d), dev)
    require(v, "v", torch.float32, (n2,), dev)
    return m, n2, d


def streaming_lse_cuda(z: torch.Tensor, v: torch.Tensor,
                       tau: float) -> torch.Tensor:
    """Launch ``ntxent_lse`` (f32 z) or ``ntxent_lse_bf16`` (bf16 z): lse
    (M, 2B) f32."""
    m, n2, d = _check_z(z, v)
    built = _library()
    stats = STATS_LSE_BF16 if z.dtype == torch.bfloat16 else STATS_LSE
    if z.dtype == torch.bfloat16:
        z = aligned16(z)
    plan = lse_plan(m, n2, d, z.device, z.dtype)
    with torch.cuda.device(z.device):
        lse = torch.empty(m, n2, dtype=torch.float32, device=z.device)
        part = torch.empty(plan["scratch"], dtype=torch.float32,
                           device=z.device)
        err = getattr(built.lib, stats.name)(
            ptr(z), ptr(v), ptr(part), ptr(lse), m, n2, d, 1.0 / tau,
            stream_of(z))
    check(built, err, stats.name)
    stats.launches += 1
    return lse


def ntxent_grad_cuda(z: torch.Tensor, lse: torch.Tensor, coef: torch.Tensor,
                     v: torch.Tensor, tau: float) -> torch.Tensor:
    """Launch ``ntxent_grad`` (f32 z; counted as ``ntxent_grad_wide`` on the
    wide body) or ``ntxent_grad_bf16`` (bf16 z): dz (M, 2B, d) f32."""
    m, n2, d = _check_z(z, v)
    require(lse, "lse", torch.float32, (m, n2), z.device)
    require(coef, "coef", torch.float32, (m, n2), z.device)
    built = _library()
    name = f"ntxent_grad{_suffix(z.dtype)}"
    if z.dtype == torch.bfloat16:
        z = aligned16(z)
    plan = grad_plan(m, n2, d, z.device, z.dtype)
    stats = STATS_GRAD_BF16 if z.dtype == torch.bfloat16 else (
        STATS_GRAD_WIDE if plan["wide"] else STATS_GRAD)
    with torch.cuda.device(z.device):
        dz = torch.empty(m, n2, d, dtype=torch.float32, device=z.device)
        part = torch.empty(plan["scratch"], dtype=torch.float32,
                           device=z.device)
        err = getattr(built.lib, name)(
            ptr(z), ptr(lse), ptr(coef), ptr(v), ptr(dz), ptr(part), m, n2,
            d, 1.0 / tau, stream_of(z))
    check(built, err, name)
    stats.launches += 1
    return dz


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"no NT-Xent path for device {t.device}")
    return False


def streaming_lse(zis: torch.Tensor, zjs: torch.Tensor, tau: float,
                  valid: Optional[torch.Tensor]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-logsumexp of the masked virtual similarity matrix: (lse_a,
    lse_b), each (M, B) f32, over the [aa | ab] and [ba | bb] rows; zis and
    zjs f32 or bf16."""
    b = zis.shape[1]
    z, v = stack(zis, zjs, valid)
    if _on_cpu(z):
        _suffix(z.dtype)
        (STATS_LSE_BF16 if z.dtype == torch.bfloat16
         else STATS_LSE).twin_calls += 1
        lse = streaming_lse_twin(z, v, tau)
    else:
        lse = streaming_lse_cuda(z, v, tau)
    return lse[:, :b], lse[:, b:]


def streaming_ntxent_grad(zis, zjs, lse_a, lse_b, coef_a, coef_b, tau,
                          valid) -> Tuple[torch.Tensor, torch.Tensor]:
    """dz for L = sum_m sum_r coef[m, r] (lse[m, r] - pos[m, r]); coef_a and
    coef_b (M, B) already fold the cotangent, ab_weight, row weights and
    1/denom.  Returns (d_zis, d_zjs), each (M, B, d) f32."""
    b = zis.shape[1]
    z, v = stack(zis, zjs, valid)
    lse = torch.cat([lse_a, lse_b], dim=1).to(torch.float32).contiguous()
    coef = torch.cat([coef_a, coef_b], dim=1).to(torch.float32).contiguous()
    if _on_cpu(z):
        _suffix(z.dtype)
        (STATS_GRAD_BF16 if z.dtype == torch.bfloat16
         else STATS_GRAD).twin_calls += 1
        dz = ntxent_grad_twin(z, lse, coef, v, tau)
    else:
        dz = ntxent_grad_cuda(z, lse, coef, v, tau)
    return dz[:, :b], dz[:, b:]
