#!/usr/bin/env python3
"""Where the bf16 weighted segment sum's warps spend their cycles, and how
fast the card gathers its rows, on one NVIDIA GPU.

    python3 scripts/torch_segment_phases.py [--root DIR]

Copies DIR's ``snag_tpu_torch`` (default: this checkout's) to
``build/segment_phases/`` and adds ``clock64`` counters to that copy of
``csrc/tile_segment.cu``'s bf16 row walk (DIR's own sources are not
touched), then runs ``weighted_segment_sum_bf16`` on
``chip_smoke.segment_bf16_inputs`` (the bench graph: 30,000 nodes, 329,862
edges; C = 300, H = 1, the bf16 GCN's adjacency): the forward on x and the
backward's reverse-edge launch (``round_term``) on g_agg, and prints, per
launch, each phase's share of the warps' summed cycles:

* ``meta``: row_ptr, the edges' columns and weights, and their shuffles;
* ``wait``: the x rows, from their loads to a first use of each (an xor of
  their words, kept live to the end);
* ``unpack``: the bf16 widened to fp32 (x on the forward; under
  ``round_term`` the parent widens x, this checkout the rounded products);
* ``term``: the fmaf into agg, or the rounded product and its fp32 add;
* ``store``: agg (or d_x) and rowsum written;
* ``other``: the rest (loop control, addresses),

and the cycles per warp.  The counters cost registers and issue slots, and
the marks pin values the compiler would otherwise schedule across them, so
the shares, not the times, are the result.

The same copy holds a **gather roof**: a kernel that only gathers the x
rows of the same walk (each edge's row, edges in CSR order, the columns
read from ``col``) and xors their words into one live word a warp, with R
lanes an edge, G 8-byte slices a lane and D edges in flight a group of
lanes, in persistent blocks of 8 warps, 8 blocks an SM.  Its least device
time over the variants is the least time a walk that gathers each edge's
row once can take here; its rate is E C 2 bytes over that time.  The
first variant is also run with 2-6 blocks an SM (16-48 warps), the roof
at the occupancy a kernel's registers allow.

From DIR's unpatched build it then prints each launch's device ms and the
C = 300 instantiations' registers and spills.  An anchor that does not
match the kernel exits naming it.  One JSON line per record, with the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import inspect
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
COPY = ROOT / "build" / "segment_phases"
SOURCE = "snag_tpu_torch/csrc/tile_segment.cu"
PHASES = ("meta", "wait", "unpack", "term", "store")
COUNTERS = """
__device__ unsigned long long g_phase[16];
namespace {
__device__ __forceinline__ void pin(float& v) { asm volatile("" : "+f"(v)); }
__device__ __forceinline__ void pin(float4& v) {
  pin(v.x); pin(v.y); pin(v.z); pin(v.w);
}
__device__ __forceinline__ void pin(int& v) { asm volatile("" : "+r"(v)); }
__device__ __forceinline__ void pin(uint32_t& v) { asm volatile("" : "+r"(v)); }
__device__ __forceinline__ void pin(uint2& v) { pin(v.x); pin(v.y); }
__device__ __forceinline__ uint32_t first_bits(float v) { return __float_as_uint(v); }
__device__ __forceinline__ uint32_t first_bits(float4 v) { return __float_as_uint(v.x); }
__device__ __forceinline__ uint32_t first_bits(uint2 v) { return v.x ^ v.y; }
__device__ __forceinline__ uint32_t first_bits(uint32_t v) { return v; }
__device__ __forceinline__ long long mark() {
  asm volatile("" ::: "memory");
  return clock64();
}
}  // namespace
"""
ENTRY = """  const long long t_entry = clock64();
  unsigned long long cyc[6] = {0, 0, 0, 0, 0, 0};
  uint32_t sink = 0;   // the loads' first uses, kept live to the end
"""
REPORT = """  cyc[5] = clock64() - t_entry;
  if (sink == 0x9e3779b9u) atomicAdd(&g_phase[14], 1ull);
  if ((threadIdx.x & 31) == 0) {
    for (int p = 0; p < 6; ++p) atomicAdd(&g_phase[p], cyc[p]);
    atomicAdd(&g_phase[15], 1ull);
  }
"""

# The parent's kernel: one template (segment_rows) for f32 and bf16, a
# warp a row, one edge's row in flight, x widened on arrival (load_slice).
# (anchor, replacement)
PATCHES_PARENT = [
    ("#include <type_traits>\n", "#include <type_traits>\n" + COUNTERS),
    ("""  const int s0 = blockIdx.y * 32 * G + lane;
  const int nv = c / VEC;
""", """  const int s0 = blockIdx.y * 32 * G + lane;
  const int nv = c / VEC;
""" + ENTRY),
    ("""  const int beg = row_ptr[i];
  const int end = row_ptr[i + 1];
""", """  const long long tm = mark();
  int beg = row_ptr[i];
  int end = row_ptr[i + 1];
  pin(beg);
  pin(end);
  cyc[0] += mark() - tm;
"""),
    ("""    int j_l = 0;
    float e_l[HB];
#pragma unroll
    for (int q = 0; q < HB; ++q) e_l[q] = 0.f;
    if (lane < m) {
      j_l = col[base + lane];
#pragma unroll
      for (int q = 0; q < HB; ++q)
        e_l[q] = to_float(e[(size_t)(base + lane) * h + h0 + q]);
    }
""", """    const long long tc = mark();
    int j_l = 0;
    float e_l[HB];
#pragma unroll
    for (int q = 0; q < HB; ++q) e_l[q] = 0.f;
    if (lane < m) {
      j_l = col[base + lane];
#pragma unroll
      for (int q = 0; q < HB; ++q)
        e_l[q] = to_float(e[(size_t)(base + lane) * h + h0 + q]);
    }
    pin(j_l);
#pragma unroll
    for (int q = 0; q < HB; ++q) pin(e_l[q]);
    cyc[0] += mark() - tc;
"""),
    ("""    for (int k = 0; k < m; ++k) {  // the same k for every lane
      const int j = __shfl_sync(FULL, j_l, k);
      const X* xr = x + (size_t)j * c;
      V v[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int s = s0 + 32 * g;
        v[g] = s < nv ? load_slice<VEC>(xr, s) : V{};
      }
#pragma unroll
      for (int q = 0; q < HB; ++q) {
        const float ek = __shfl_sync(FULL, e_l[q], k);
#pragma unroll
        for (int g = 0; g < G; ++g)
          Vec<VEC>::template fma<ROUND_TERM>(acc[q][g], ek, v[g]);
        rs[q] += ek;
      }
    }
""", """    for (int k = 0; k < m; ++k) {  // the same k for every lane
      const long long t0 = mark();
      int j = __shfl_sync(FULL, j_l, k);
      float ek[HB];
#pragma unroll
      for (int q = 0; q < HB; ++q) {
        ek[q] = __shfl_sync(FULL, e_l[q], k);
        pin(ek[q]);
      }
      pin(j);
      long long t1 = mark();
      cyc[0] += t1 - t0;
      const X* xr = x + (size_t)j * c;
      V v[G];
      uint32_t touch = 0;
      if constexpr (std::is_same<X, __nv_bfloat16>::value && VEC == 4) {
        uint2 raw[G];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const int s = s0 + 32 * g;
          raw[g] = s < nv ? reinterpret_cast<const uint2*>(xr)[s]
                          : make_uint2(0u, 0u);
        }
#pragma unroll
        for (int g = 0; g < G; ++g) touch ^= first_bits(raw[g]);
        pin(touch);
        sink ^= touch;
        const long long t2 = mark();
        cyc[1] += t2 - t1;
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const uint2 u = raw[g];
          v[g] = make_float4(__uint_as_float(u.x << 16),
                             __uint_as_float(u.x & 0xffff0000u),
                             __uint_as_float(u.y << 16),
                             __uint_as_float(u.y & 0xffff0000u));
          pin(v[g]);
        }
        const long long t3 = mark();
        cyc[2] += t3 - t2;
        t1 = t3;
      } else {
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const int s = s0 + 32 * g;
          v[g] = s < nv ? load_slice<VEC>(xr, s) : V{};
        }
#pragma unroll
        for (int g = 0; g < G; ++g) touch ^= first_bits(v[g]);
        pin(touch);
        sink ^= touch;
        const long long t2 = mark();
        cyc[1] += t2 - t1;
        t1 = t2;
      }
#pragma unroll
      for (int q = 0; q < HB; ++q) {
#pragma unroll
        for (int g = 0; g < G; ++g) {
          Vec<VEC>::template fma<ROUND_TERM>(acc[q][g], ek[q], v[g]);
          pin(acc[q][g]);
        }
        rs[q] += ek[q];
      }
      cyc[3] += mark() - t1;
    }
"""),
    ("""#pragma unroll
  for (int q = 0; q < HB; ++q) {
    V* out = reinterpret_cast<V*>(agg + ((size_t)i * h + h0 + q) * c);
""", """  const long long ts = mark();
#pragma unroll
  for (int q = 0; q < HB; ++q) {
    V* out = reinterpret_cast<V*>(agg + ((size_t)i * h + h0 + q) * c);
"""),
    ("""    for (int q = 0; q < HB; ++q) rowsum[(size_t)i * h + h0 + q] = rs[q];
  }
}
""", """    for (int q = 0; q < HB; ++q) rowsum[(size_t)i * h + h0 + q] = rs[q];
  }
  cyc[4] += mark() - ts;
""" + REPORT + "}\n"),
]

# This checkout's bf16 body: a row on 16 or 32 lanes (two rows a warp at
# C = 300), one edge's row loaded at a time, round_term's products on bf16
# pairs.  The widening is split from the products and adds here only.
HELPERS = """
__device__ __forceinline__ float4 phase_widen(uint2 v) {
  return make_float4(lo_f32(v.x), hi_f32(v.x), lo_f32(v.y), hi_f32(v.y));
}
__device__ __forceinline__ float phase_widen(uint32_t v) { return lo_f32(v); }
__device__ __forceinline__ uint2 phase_mul(uint32_t e2, uint2 v) {
  return make_uint2(mul_bf16x2(e2, v.x), mul_bf16x2(e2, v.y));
}
__device__ __forceinline__ uint32_t phase_mul(uint32_t e2, uint32_t v) {
  return mul_bf16x2(e2, v);
}
__device__ __forceinline__ void phase_add(float4& a, float4 w) {
  a.x = __fadd_rn(a.x, w.x);
  a.y = __fadd_rn(a.y, w.y);
  a.z = __fadd_rn(a.z, w.z);
  a.w = __fadd_rn(a.w, w.w);
}
__device__ __forceinline__ void phase_add(float& a, float w) {
  a = __fadd_rn(a, w);
}
__device__ __forceinline__ void phase_fma(float4& a, float e, float4 w) {
  a.x = fmaf(e, w.x, a.x);
  a.y = fmaf(e, w.y, a.y);
  a.z = fmaf(e, w.z, a.z);
  a.w = fmaf(e, w.w, a.w);
}
__device__ __forceinline__ void phase_fma(float& a, float e, float w) {
  a = fmaf(e, w, a);
}

"""
PATCHES_BF16 = [
    ("#include <type_traits>\n", "#include <type_traits>\n" + COUNTERS),
    ("// A slice's fp32 sums written in fp32",
     HELPERS + "// A slice's fp32 sums written in fp32"),
    ("""  const int s0 = blockIdx.y * lanes * G + rl;
  const int nv = c / VEC;
""", """  const int s0 = blockIdx.y * lanes * G + rl;
  const int nv = c / VEC;
""" + ENTRY),
    ("""  const int beg = live ? row_ptr[i] : 0;
  const int len = live ? row_ptr[i + 1] - beg : 0;
  // the warp's longest row: every half runs its trip count
  int most = len;
  for (int o = lanes; o < 32; o <<= 1)
    most = max(most, __shfl_xor_sync(FULL, most, o));
""", """  const long long tm = mark();
  const int beg = live ? row_ptr[i] : 0;
  const int len = live ? row_ptr[i + 1] - beg : 0;
  // the warp's longest row: every half runs its trip count
  int most = len;
  for (int o = lanes; o < 32; o <<= 1)
    most = max(most, __shfl_xor_sync(FULL, most, o));
  pin(most);
  cyc[0] += mark() - tm;
"""),
    ("""    int j_l = 0;
    uint32_t e_l[HB];
#pragma unroll
    for (int q = 0; q < HB; ++q) e_l[q] = 0u;
    if (rl < m) {
      const size_t k = (size_t)beg + base + rl;
      j_l = col[k];
#pragma unroll
      for (int q = 0; q < HB; ++q)
        e_l[q] = __bfloat16_as_ushort(e[k * h + h0 + q]);
    }
""", """    const long long tc = mark();
    int j_l = 0;
    uint32_t e_l[HB];
#pragma unroll
    for (int q = 0; q < HB; ++q) e_l[q] = 0u;
    if (rl < m) {
      const size_t k = (size_t)beg + base + rl;
      j_l = col[k];
#pragma unroll
      for (int q = 0; q < HB; ++q)
        e_l[q] = __bfloat16_as_ushort(e[k * h + h0 + q]);
    }
    pin(j_l);
#pragma unroll
    for (int q = 0; q < HB; ++q) pin(e_l[q]);
    cyc[0] += mark() - tc;
"""),
    ("""      const int j = __shfl_sync(FULL, j_l, k, lanes);
      uint32_t eb[HB];
#pragma unroll
      for (int q = 0; q < HB; ++q) eb[q] = __shfl_sync(FULL, e_l[q], k, lanes);
      const Slices* xr = reinterpret_cast<const Slices*>(x + (size_t)j * c);
      P v[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int s = s0 + lanes * g;
        v[g] = k < m && s < nv ? load_packed(xr, s) : P{};
      }
""", """      const long long t0 = mark();
      int j = __shfl_sync(FULL, j_l, k, lanes);
      uint32_t eb[HB];
#pragma unroll
      for (int q = 0; q < HB; ++q) {
        eb[q] = __shfl_sync(FULL, e_l[q], k, lanes);
        pin(eb[q]);
      }
      pin(j);
      const long long t1 = mark();
      cyc[0] += t1 - t0;
      const Slices* xr = reinterpret_cast<const Slices*>(x + (size_t)j * c);
      P v[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int s = s0 + lanes * g;
        v[g] = k < m && s < nv ? load_packed(xr, s) : P{};
      }
      {
        uint32_t touch = 0;
#pragma unroll
        for (int g = 0; g < G; ++g) touch ^= first_bits(v[g]);
        pin(touch);
        sink ^= touch;
        cyc[1] += mark() - t1;
      }
"""),
    ("""#pragma unroll
      for (int q = 0; q < HB; ++q) {
        const float ek = lo_f32(eb[q]);
        const uint32_t e2 = eb[q] | (eb[q] << 16);
#pragma unroll
        for (int g = 0; g < G; ++g)
          add_slice<ROUND_TERM>(acc[q][g], ek, e2, v[g]);
        rs[q] += ek;
      }
""", """#pragma unroll
      for (int q = 0; q < HB; ++q) {
        const float ek = lo_f32(eb[q]);
        const uint32_t e2 = eb[q] | (eb[q] << 16);
        long long ta = mark();
        V w[G];
        if constexpr (ROUND_TERM) {
          P pr[G];
#pragma unroll
          for (int g = 0; g < G; ++g) {
            pr[g] = phase_mul(e2, v[g]);
            pin(pr[g]);
          }
          const long long tb = mark();
          cyc[3] += tb - ta;
          ta = tb;
#pragma unroll
          for (int g = 0; g < G; ++g) {
            w[g] = phase_widen(pr[g]);
            pin(w[g]);
          }
        } else {
#pragma unroll
          for (int g = 0; g < G; ++g) {
            w[g] = phase_widen(v[g]);
            pin(w[g]);
          }
        }
        const long long tb = mark();
        cyc[2] += tb - ta;
#pragma unroll
        for (int g = 0; g < G; ++g) {
          if constexpr (ROUND_TERM) phase_add(acc[q][g], w[g]);
          else phase_fma(acc[q][g], ek, w[g]);
          pin(acc[q][g]);
        }
        rs[q] += ek;
        cyc[3] += mark() - tb;
      }
"""),
    ("""  if (!live) return;
#pragma unroll
  for (int q = 0; q < HB; ++q) {
    const size_t at = ((size_t)i * h + h0 + q) * c;
""", """  if (!live) return;
  const long long ts = mark();
#pragma unroll
  for (int q = 0; q < HB; ++q) {
    const size_t at = ((size_t)i * h + h0 + q) * c;
"""),
    ("""  if (rowsum != nullptr && blockIdx.y == 0 && rl == 0) {
#pragma unroll
    for (int q = 0; q < HB; ++q) rowsum[(size_t)i * h + h0 + q] = rs[q];
  }
}
""", """  if (rowsum != nullptr && blockIdx.y == 0 && rl == 0) {
#pragma unroll
    for (int q = 0; q < HB; ++q) rowsum[(size_t)i * h + h0 + q] = rs[q];
  }
  cyc[4] += mark() - ts;
""" + REPORT + "}\n"),
]

READ = """

extern "C" int phase_read(unsigned long long* out) {
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(out, g_phase, sizeof(unsigned long long) * 16);
  unsigned long long zero[16] = {};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_phase, zero, sizeof(zero));
  return static_cast<int>(e);
}
"""

# The gather roof: R lanes an edge, lane l loading the 8-byte slices
# l + R g (g < G) of its row, D consecutive edges a group at a time, the
# groups of the grid interleaved over the edges in CSR order.
ROOF = """

namespace {
template <int R, int G, int D>
__global__ void __launch_bounds__(256)
segment_gather_roof_kernel(const uint2* __restrict__ x,
                           const int* __restrict__ col, int n_edges, int nv,
                           unsigned* __restrict__ out) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int rl = threadIdx.x % R;
  const int groups = gridDim.x * blockDim.x / R;
  uint32_t word = 0;
  for (int k0 = t / R * D; k0 < n_edges; k0 += groups * D) {
    int j[D];
#pragma unroll
    for (int d = 0; d < D; ++d) j[d] = k0 + d < n_edges ? col[k0 + d] : -1;
    uint2 v[D][G];
#pragma unroll
    for (int d = 0; d < D; ++d)
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int s = rl + R * g;
        v[d][g] = j[d] >= 0 && s < nv ? x[(size_t)j[d] * nv + s]
                                      : make_uint2(0u, 0u);
      }
#pragma unroll
    for (int d = 0; d < D; ++d)
#pragma unroll
      for (int g = 0; g < G; ++g) word ^= v[d][g].x ^ v[d][g].y;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) word ^= __shfl_xor_sync(0xffffffffu, word, o);
  if ((threadIdx.x & 31) == 0) out[t >> 5] = word;
}

template <int R, int G, int D>
int roof_launch(const uint2* x, const int* col, int n_edges, int nv,
                unsigned* out, int blocks, cudaStream_t s) {
  if (R * G < nv) return static_cast<int>(cudaErrorInvalidValue);
  segment_gather_roof_kernel<R, G, D><<<blocks, 256, 0, s>>>(x, col, n_edges,
                                                             nv, out);
  return static_cast<int>(cudaGetLastError());
}
}  // namespace

// x: bf16 rows of nv 8-byte slices; out: one word a warp of the grid
// (blocks * 8 words).
extern "C" int segment_gather_roof(const void* x, const int* col,
                                   int n_edges, int nv, int variant,
                                   unsigned* out, int blocks, void* stream) {
  const uint2* xs = static_cast<const uint2*>(x);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0: return roof_launch<16, 5, 1>(xs, col, n_edges, nv, out, blocks, s);
    case 1: return roof_launch<16, 5, 2>(xs, col, n_edges, nv, out, blocks, s);
    case 2: return roof_launch<16, 5, 4>(xs, col, n_edges, nv, out, blocks, s);
    case 3: return roof_launch<16, 5, 8>(xs, col, n_edges, nv, out, blocks, s);
    case 4: return roof_launch<32, 3, 1>(xs, col, n_edges, nv, out, blocks, s);
    case 5: return roof_launch<32, 3, 4>(xs, col, n_edges, nv, out, blocks, s);
    case 6: return roof_launch<8, 10, 2>(xs, col, n_edges, nv, out, blocks, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
"""
ROOF_VARIANTS = ((16, 5, 1), (16, 5, 2), (16, 5, 4), (16, 5, 8), (32, 3, 1),
                 (32, 3, 4), (8, 10, 2))


def patch_sets(text: str):
    """The patch sets that apply to this source: the parent's one template
    for both dtypes, or this checkout's bf16 body of its own."""
    if "segment_rows_bf16(" in text:
        return [("bf16 body", PATCHES_BF16)]
    return [("shared body", PATCHES_PARENT)]


def make_copy(root: Path) -> str:
    """The patched copy of root's package under COPY; returns which patch
    sets it took."""
    shutil.rmtree(COPY, ignore_errors=True)
    shutil.copytree(root / "snag_tpu_torch", COPY / "snag_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = COPY / SOURCE
    text = path.read_text()
    names = []
    for name, patches in patch_sets(text):
        for anchor, new in patches:
            if text.count(anchor) != 1:
                raise SystemExit(f"anchor not found once in {SOURCE} "
                                 f"({name}):\n{anchor}")
            text = text.replace(anchor, new)
        names.append(name)
    path.write_text(text + READ + ROOF)
    return ", ".join(names)


def card_name() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]


def launches(ts, x, e, e_rev, g_agg, g):
    """(label, call) of each launch the root's wrapper offers: the forward,
    the ``round_term`` launch, and where the root has it the backward's
    launch that writes d_x in bf16."""
    out = [("forward", lambda: ts.weighted_segment_sum_cuda(x, e, g)),
           ("round_term", lambda: ts.weighted_segment_sum_cuda(
               g_agg, e_rev, g, round_term=True))]
    if "out_bf16" in inspect.signature(
            ts.weighted_segment_sum_cuda).parameters:
        out.append(("round_term bf16 d_x", lambda: ts.weighted_segment_sum_cuda(
            g_agg, e_rev, g, round_term=True, out_bf16=True)))
    return out


def rows_a_warp(ts) -> int:
    """The rows a warp of the root's bf16 kernel walks at C = 300 (the
    parent's: one)."""
    if "bf16" not in inspect.signature(ts.launch_plan).parameters:
        return 1
    return 32 // ts.launch_plan(300, 1, 4, bf16=True).lanes


def roof(cs, torch, built, x, g, card):
    """The gather roof's device ms and rate for each variant."""
    import ctypes
    fn = built.lib.segment_gather_roof
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = sms * 8                         # 2,048 threads an SM
    out = torch.empty(blocks * 8, dtype=torch.int32, device="cuda")
    (n, c), m_e = x.shape, g.n_edges
    stream = torch.cuda.current_stream().cuda_stream
    rec = {"record": "gather roof", "shape": "C300 H1", "card": card,
           "blocks": blocks, "variants": []}
    for v, (r, gs, d) in enumerate(ROOF_VARIANTS):
        def call(v=v):
            err = fn(x.data_ptr(), g.col.data_ptr(), m_e, c // 4, v,
                     out.data_ptr(), blocks, stream)
            if err:
                raise RuntimeError(f"segment_gather_roof {v}: CUDA error {err}")
        ms = cs.device_ms(call, ("segment_gather_roof",))
        rec["variants"].append({"R": r, "G": gs, "D": d, "device_ms": ms,
                                "TB/s": m_e * c * 2 / ms / 1e9})
    best = min(rec["variants"], key=lambda w: w["device_ms"])
    rec["roof_ms"], rec["roof_TB/s"] = best["device_ms"], best["TB/s"]
    # variant 0 (R = 16, G = 5, D = 1) with fewer warps an SM
    rec["by_warps_an_sm"] = []
    for per_sm in (2, 3, 4, 5, 6):
        def call(per_sm=per_sm):
            err = fn(x.data_ptr(), g.col.data_ptr(), m_e, c // 4, 0,
                     out.data_ptr(), sms * per_sm, stream)
            if err:
                raise RuntimeError(f"segment_gather_roof: CUDA error {err}")
        ms = cs.device_ms(call, ("segment_gather_roof",))
        rec["by_warps_an_sm"].append({"warps": 8 * per_sm, "device_ms": ms,
                                      "TB/s": m_e * c * 2 / ms / 1e9})
    return rec


def ptxas(cs, built):
    """(kernel<template arguments>, registers, spill stores, spill loads)
    of the bf16 kernel's one-head, 4-bf16-slice instantiations."""
    out = []
    for entry, regs, st, ld in cs.ptxas_usage(
            built.compiler_log, ("weighted_segment_sum_bf16",)):
        m = re.search(r"(weighted_segment_sum_bf16_kernel)I(L.*?)EEv", entry)
        args = re.findall(r"L[ib](\d+)E", m.group(2)) if m else []
        if args[:2] == ["1", "4"]:
            out.append((f"{m.group(1)}<{','.join(args)}>", regs, st, ld))
    return out


def measure(package: Path, what: str) -> int:
    """In a process of its own: the phase shares and the gather roof
    (``what`` = the patch sets, package = the patched copy) or the device
    ms and registers (``what`` = "times", package = the checkout)."""
    import ctypes
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    sys.path.insert(0, str(package))
    import torch
    from snag_tpu_torch.data.dataset import load_data
    from snag_tpu_torch.ops.cuda import tile_segment as ts
    if not torch.cuda.is_available():
        print("torch_segment_phases: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    if not ts.__file__.startswith(str(package)):
        raise RuntimeError(f"imported {ts.__file__}, not from {package}")
    card = card_name()
    built = ts._library()
    graph = load_data(cs.cfg_from(cs.BENCH_ARGS + ["--device", "cpu"])).graph
    g, x, e, e_rev, g_agg = cs.segment_bf16_inputs(graph)
    names = cs.DEVICE_KERNELS[ts.STATS_BF16.name]
    for label, fn in launches(ts, x, e, e_rev, g_agg, g):
        rec = {"kernel": ts.STATS_BF16.name, "launch": label,
               "shape": "C300 H1", "card": card}
        if what == "times":
            rec["package"] = str(package)
            rec["device_ms"] = cs.device_ms(fn, names)
        else:
            out = (ctypes.c_ulonglong * 16)()
            fn()
            built.lib.phase_read(out)           # drop the first call's counts
            fn()
            if built.lib.phase_read(out):
                raise RuntimeError("phase_read failed")
            total = out[5]
            named = {p: out[i] / total for i, p in enumerate(PHASES)}
            named["other"] = 1.0 - sum(named.values())
            rows = rows_a_warp(ts)
            rec |= {"patched": what,
                    **{p: round(v, 4) for p, v in named.items()},
                    "cycles_per_warp": round(total / max(out[15], 1)),
                    "rows_a_warp": rows}
        print(json.dumps(rec), flush=True)
    if what == "times":
        print(json.dumps({"record": "ptxas", "package": str(package),
                          "card": card, "entries": [
                              {"entry": n, "registers": r, "spill_stores": s,
                               "spill_loads": ld}
                              for n, r, s, ld in ptxas(cs, built)]}),
              flush=True)
    else:
        print(json.dumps(roof(cs, torch, built, x, g, card)), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--measure"]:
        sys.exit(measure(Path(sys.argv[2]).resolve(), sys.argv[3]))
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(ROOT))
    root = Path(ap.parse_args().root).resolve()
    patched = make_copy(root)
    rc = subprocess.run([sys.executable, __file__, "--measure", str(COPY),
                         patched]).returncode
    rc2 = subprocess.run([sys.executable, __file__, "--measure", str(root),
                          "times"]).returncode
    sys.exit(rc or rc2)
