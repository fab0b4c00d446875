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
kernel it shares with the mixture gradient (``csrc/gram_grad.cuh``); it
takes any d, in feature chunks where one accumulator of d columns would
not fit, and its scratch (``ntxent_grad_plan``) holds the partials of
blocks that share a row tile's columns.

Twins: ``streaming_lse_twin`` and ``ntxent_grad_twin``, the same formulas
on the dense (M, 2B, 2B) matrix.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from snag_tpu_torch.ops.cuda._lib import (KernelStats, check, load_library,
                                          ptr, require, stream_of)

STATS_LSE = KernelStats("ntxent_lse")
STATS_GRAD = KernelStats("ntxent_grad")
LSE_EPS = 1e-30


def stack(zis: torch.Tensor, zjs: torch.Tensor,
          valid: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """(M, B, d) pair + (B,) mask -> z (M, 2B, d), v (2B,) f32."""
    b = zis.shape[1]
    z = torch.cat([zis, zjs], dim=1).contiguous()
    vf = (torch.ones(b, dtype=torch.float32, device=zis.device)
          if valid is None else valid.to(torch.float32))
    return z, torch.cat([vf, vf]).contiguous()


def _dense(z: torch.Tensor, inv_tau: float):
    """(S (M, 2B, 2B), off-diagonal indicator (2B, 2B) f32)."""
    n2 = z.shape[1]
    s = torch.einsum("mrd,mcd->mrc", z, z) * inv_tau
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
    """Plain version of ``ntxent_grad``: dz (M, 2B, d) = W z."""
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
    return torch.bmm(w, z)


def _library():
    built = load_library("ntxent")
    lib = built.lib
    if lib.ntxent_lse.argtypes is None:
        lib.ntxent_lse.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 \
            + [ctypes.c_float, ctypes.c_void_p]
        lib.ntxent_lse.restype = ctypes.c_int
        lib.ntxent_lse_plan.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.ntxent_lse_plan.restype = ctypes.c_long
        lib.ntxent_grad.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 \
            + [ctypes.c_float, ctypes.c_void_p]
        lib.ntxent_grad.restype = ctypes.c_int
        lib.ntxent_grad_plan.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.ntxent_grad_plan.restype = ctypes.c_long
    return built


def lse_plan(m: int, n2: int, d: int,
             device: torch.device) -> Dict[str, int]:
    """How ``ntxent_lse`` runs at (m, n2, d) on ``device``: its tile, tile
    pairs (blocks per batch), blocks per SM and floats of scratch."""
    built = _library()
    out = (ctypes.c_int * 3)()
    with torch.cuda.device(device):
        floats = built.lib.ntxent_lse_plan(m, n2, d, out)
    if floats < 0:
        check(built, -floats, "ntxent_lse_plan")
    return dict(zip(("tile", "pairs", "blocks_per_sm"), out), scratch=floats)


def grad_plan(m: int, n2: int, d: int,
              device: torch.device) -> Dict[str, int]:
    """How ``ntxent_grad`` runs at (m, n2, d) on ``device``: its feature
    chunks, ring depth, column splits, blocks per SM and floats of
    scratch."""
    built = _library()
    out = (ctypes.c_int * 4)()
    with torch.cuda.device(device):
        floats = built.lib.ntxent_grad_plan(m, n2, d, out)
    if floats < 0:
        check(built, -floats, "ntxent_grad_plan")
    return dict(zip(("chunks", "depth", "splits", "blocks_per_sm"), out),
                scratch=floats)


def _check_z(z: torch.Tensor, v: torch.Tensor):
    dev = z.device
    if dev.type != "cuda":
        raise ValueError(f"the NT-Xent kernels need CUDA tensors, got {dev}")
    if z.dim() != 3 or z.shape[1] % 2:
        raise ValueError(f"z must be (M, 2B, d), got {tuple(z.shape)}")
    m, n2, d = z.shape
    require(z, "z", torch.float32, (m, n2, d), dev)
    require(v, "v", torch.float32, (n2,), dev)
    return m, n2, d


def streaming_lse_cuda(z: torch.Tensor, v: torch.Tensor,
                       tau: float) -> torch.Tensor:
    """Launch ``ntxent_lse``: lse (M, 2B) f32."""
    m, n2, d = _check_z(z, v)
    built = _library()
    plan = lse_plan(m, n2, d, z.device)
    with torch.cuda.device(z.device):
        lse = torch.empty(m, n2, dtype=torch.float32, device=z.device)
        part = torch.empty(plan["scratch"], dtype=torch.float32,
                           device=z.device)
        err = built.lib.ntxent_lse(ptr(z), ptr(v), ptr(part), ptr(lse), m, n2,
                                   d, 1.0 / tau, stream_of(z))
    check(built, err, "ntxent_lse")
    STATS_LSE.launches += 1
    return lse


def ntxent_grad_cuda(z: torch.Tensor, lse: torch.Tensor, coef: torch.Tensor,
                     v: torch.Tensor, tau: float) -> torch.Tensor:
    """Launch ``ntxent_grad``: dz (M, 2B, d) f32."""
    m, n2, d = _check_z(z, v)
    require(lse, "lse", torch.float32, (m, n2), z.device)
    require(coef, "coef", torch.float32, (m, n2), z.device)
    built = _library()
    plan = grad_plan(m, n2, d, z.device)
    with torch.cuda.device(z.device):
        dz = torch.empty(m, n2, d, dtype=torch.float32, device=z.device)
        part = torch.empty(plan["scratch"], dtype=torch.float32,
                           device=z.device)
        err = built.lib.ntxent_grad(ptr(z), ptr(lse), ptr(coef), ptr(v),
                                    ptr(dz), ptr(part), m, n2, d, 1.0 / tau,
                                    stream_of(z))
    check(built, err, "ntxent_grad")
    STATS_GRAD.launches += 1
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
    lse_b), each (M, B) f32, over the [aa | ab] and [ba | bb] rows."""
    b = zis.shape[1]
    z, v = stack(zis, zjs, valid)
    if _on_cpu(z):
        STATS_LSE.twin_calls += 1
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
        STATS_GRAD.twin_calls += 1
        dz = ntxent_grad_twin(z, lse, coef, v, tau)
    else:
        dz = ntxent_grad_cuda(z, lse, coef, v, tau)
    return dz[:, :b], dz[:, b:]
