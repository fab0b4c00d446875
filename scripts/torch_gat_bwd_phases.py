#!/usr/bin/env python3
"""Where the GAT backward kernel's warps spend their cycles, on one NVIDIA GPU.

    python3 scripts/torch_gat_bwd_phases.py [--root DIR]

Copies DIR's ``snag_tpu_torch`` (default: this checkout's) to
``build/gat_bwd_phases/`` and adds ``clock64`` counters to that copy of
``csrc/gat_bwd.cu``'s first pass (DIR's own sources are not touched), then
runs ``gat_bwd`` and ``gat_bwd_bf16`` on ``chip_smoke.gat_bwd_inputs`` (the
bench graph: 30,000 nodes, 329,862 edges; bf16: x and G rounded to bf16)
at each (H, C) of ``SHAPES``: the main path's C = 300, H = 2, and the wide
path's H = 8 at C = 300 (the ``--heads 8,8`` training shape) and 1,536,
and H = 2 at C = 330.  It prints, per kernel and shape, each phase's share
of the warps' summed cycles in the first pass.  The main path's body:

* ``wait``: the edge's G rows, from their loads to a first use of each
  (an xor of their words, which waits on every load and is kept live to
  the end);
* ``unpack``: the G rows' bf16 pairs widened to fp32 (the parent's bf16
  kernel, on arrival; this checkout's, for the dot only);
* ``term``: the d_x term (f32: the fmaf into d_x; bf16: the rounded
  products and their sum over heads);
* ``dot``: the lanes' products of x[j] and G[k, h];
* ``butterfly``: the sums across the lanes and the dot's group sums;
* ``dscore``: a chunk's d_scores, their scratch writes and d_s_dst's sum;
* ``other``: the rest (x[j], the chunk's scalars, the edge weights, the
  d_x adds of bf16 terms, the d_x write),

and the cycles per warp.  The wide body (``WIDE_PHASES``; a checkout's
own anchors pick its body's names):

* ``wait``, ``term`` and ``dot`` as above;
* ``sums``: the sums across the lanes (the parent's butterflies, one
  head at a time; this checkout's reduce-scatter of a head group and the
  writes of its group sums to shared memory);
* ``carry``: the parent's read-modify-write of each edge's partial dot in
  its scratch slot, once a column chunk (lane 0); this checkout's edge
  batch's d_scores from the group sums in shared memory, with the
  barriers around them;
* ``scalars``: the parent's broadcast loads of s_src, s_dst (and r) and
  the edge weight, for every head of every edge of every chunk; this
  checkout's batch of column ids, slots, weights and r into shared memory;
* ``other``: the rest, and ``chunks``, the column chunks a warp walks the
  row's edges for (the parent's; 1 in this checkout's body, whose warps
  of a row split its columns).

The counters cost registers and issue slots, and the marks pin values the
compiler would otherwise schedule across them, so the shares, not the
times, are the result.  From DIR's unpatched build it also prints the
device ms of each kernel's two launches apart (the first pass and the
second, the row sums), the whole call's, the gather roof (the E H C
elements of G an edge gathers, once, at 3.35 TB/s) and the first pass's
registers and spills.  An anchor that does not match the kernel exits
naming it.  One JSON line per kernel and shape, with the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
COPY = ROOT / "build" / "gat_bwd_phases"
SOURCE = "snag_tpu_torch/csrc/gat_bwd.cu"
PHASES = ("wait", "unpack", "term", "dot", "butterfly", "dscore")
WIDE_PHASES = ("wait", "term", "dot", "sums", "carry", "scalars")
# (H, C): the main path's shape, then the wide path's
SHAPES = ((2, 300), (8, 300), (8, 1536), (2, 330))
COUNTERS = """
__device__ unsigned long long g_phase[16];
namespace {
__device__ __forceinline__ void pin(float& v) { asm volatile("" : "+f"(v)); }
__device__ __forceinline__ void pin(float4& v) {
  pin(v.x); pin(v.y); pin(v.z); pin(v.w);
}
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
  unsigned long long cyc[7] = {0, 0, 0, 0, 0, 0, 0};
  uint32_t sink = 0;   // the loads' first uses, kept live to the end
"""
REPORT = """  cyc[6] = clock64() - t_entry;
  if (sink == 0x9e3779b9u) atomicAdd(&g_phase[14], 1ull);
  if (lane == 0) {
    for (int i = 0; i < 7; ++i) atomicAdd(&g_phase[i], cyc[i]);
    atomicAdd(&g_phase[15], 1ull);
  }
"""

# The parent's kernel: one template for f32 and bf16, G unpacked on
# arrival (load_slice), the term and the dot in one loop, a butterfly a
# group.  (anchor, replacement)
PATCHES_SHARED = [
    ("#include <type_traits>\n", "#include <type_traits>\n" + COUNTERS),
    ("""  constexpr bool BF16 = !std::is_same<X, float>::value;
  using V = typename Vec<VEC>::T;
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (j >= n) return;  // a tail warp; nothing below waits on a barrier
""", """  constexpr bool BF16 = !std::is_same<X, float>::value;
  using V = typename Vec<VEC>::T;
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (j >= n) return;  // a tail warp; nothing below waits on a barrier
""" + ENTRY),
    ("""      V gk[H][G];
#pragma unroll
      for (int h = 0; h < H; ++h) {
        const X* row = g_agg + ((size_t)k * H + h) * c;
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const int s = lane + 32 * g;
          gk[h][g] = s < nv ? load_slice<VEC>(row, s, false) : V{};
        }
      }
""", """      V gk[H][G];
      long long tq = mark();
      if constexpr (BF16 && VEC == 4) {
        uint2 raw[H][G];
        uint32_t touch = 0;
#pragma unroll
        for (int h = 0; h < H; ++h) {
          const uint2* row =
              reinterpret_cast<const uint2*>(g_agg + ((size_t)k * H + h) * c);
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const int s = lane + 32 * g;
            raw[h][g] = s < nv ? row[s] : make_uint2(0u, 0u);
          }
        }
#pragma unroll
        for (int h = 0; h < H; ++h)
#pragma unroll
          for (int g = 0; g < G; ++g) touch ^= first_bits(raw[h][g]);
        sink ^= touch;
        long long t1 = mark();
        cyc[0] += t1 - tq;
        tq = t1;
#pragma unroll
        for (int h = 0; h < H; ++h)
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const uint2 u = raw[h][g];
            gk[h][g] = make_float4(bf16_bits(u.x & 0xffffu),
                                   __uint_as_float(u.x & 0xffff0000u),
                                   bf16_bits(u.y & 0xffffu),
                                   __uint_as_float(u.y & 0xffff0000u));
            pin(gk[h][g]);
          }
        cyc[1] += mark() - tq;
      } else {
        uint32_t touch = 0;
#pragma unroll
        for (int h = 0; h < H; ++h) {
          const X* row = g_agg + ((size_t)k * H + h) * c;
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const int s = lane + 32 * g;
            gk[h][g] = s < nv ? load_slice<VEC>(row, s, false) : V{};
          }
        }
#pragma unroll
        for (int h = 0; h < H; ++h)
#pragma unroll
          for (int g = 0; g < G; ++g) touch ^= first_bits(gk[h][g]);
        sink ^= touch;
        cyc[0] += mark() - tq;
      }
"""),
    ("""        float part[G];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          if constexpr (BF16)
            dx_term(term[g], round_bf16(e), gk[h][g], h == 0);
          else
            Vec<VEC>::fma(acc[g], e, gk[h][g]);
          part[g] = lane + 32 * g < nv ? Vec<VEC>::dot(xj[g], gk[h][g]) : 0.f;
        }
""", """        float part[G];
        const long long t1 = mark();
#pragma unroll
        for (int g = 0; g < G; ++g) {
          if constexpr (BF16) {
            dx_term(term[g], round_bf16(e), gk[h][g], h == 0);
            pin(term[g]);
          } else {
            Vec<VEC>::fma(acc[g], e, gk[h][g]);
            pin(acc[g]);
          }
        }
        const long long t2 = mark();
        cyc[2] += t2 - t1;
#pragma unroll
        for (int g = 0; g < G; ++g) {
          part[g] = lane + 32 * g < nv ? Vec<VEC>::dot(xj[g], gk[h][g]) : 0.f;
          pin(part[g]);
        }
        const long long t3 = mark();
        cyc[3] += t3 - t2;
"""),
    ("""        if (lane == q) dot_l[h] = dot;
      }
""", """        if (lane == q) dot_l[h] = dot;
        pin(dot_l[h]);
        cyc[4] += mark() - t3;
      }
"""),
    ("""    // the chunk's d_scores, one edge a lane: to scratch, and into d_s_dst[j]
    // in edge order
#pragma unroll
    for (int h = 0; h < H; ++h) {""",
     """    // the chunk's d_scores, one edge a lane: to scratch, and into d_s_dst[j]
    // in edge order
    const long long td = mark();
#pragma unroll
    for (int h = 0; h < H; ++h) {"""),
    ("""      for (int q = 0; q < m; ++q) sum_dst[h] += __shfl_sync(FULL, d_score, q);
    }
""", """      for (int q = 0; q < m; ++q) sum_dst[h] += __shfl_sync(FULL, d_score, q);
      pin(sum_dst[h]);
    }
    cyc[5] += mark() - td;
"""),
    ("""    for (int h = 0; h < H; ++h) d_s_dst[(size_t)j * H + h] = sum_dst[h];
  }
}
""", """    for (int h = 0; h < H; ++h) d_s_dst[(size_t)j * H + h] = sum_dst[h];
  }
""" + REPORT + "}\n"),
]

# This checkout's f32 body (the parent's f32 instantiation, unchanged).
PATCHES_F32 = [
    ("#include <type_traits>\n", "#include <type_traits>\n" + COUNTERS),
    ("""  const int nv = c / VEC;

  V xj[G], acc[G];
""", """  const int nv = c / VEC;
""" + ENTRY + """
  V xj[G], acc[G];
"""),
    ("""          gk[h][g] = s < nv ? row[s] : V{};
        }
      }
""", """          gk[h][g] = s < nv ? row[s] : V{};
        }
      }
      {
        uint32_t touch = 0;
#pragma unroll
        for (int h = 0; h < H; ++h)
#pragma unroll
          for (int g = 0; g < G; ++g) touch ^= first_bits(gk[h][g]);
        sink ^= touch;
        cyc[0] += mark() - tq;
      }
"""),
    ("""      const int k = __shfl_sync(FULL, k_l, q);
      V gk[H][G];
""", """      const int k = __shfl_sync(FULL, k_l, q);
      V gk[H][G];
      const long long tq = mark();
"""),
    ("""        float part[G];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          Vec<VEC>::fma(acc[g], e, gk[h][g]);
          part[g] = lane + 32 * g < nv ? Vec<VEC>::dot(xj[g], gk[h][g]) : 0.f;
        }
""", """        float part[G];
        const long long t1 = mark();
#pragma unroll
        for (int g = 0; g < G; ++g) {
          Vec<VEC>::fma(acc[g], e, gk[h][g]);
          pin(acc[g]);
        }
        const long long t2 = mark();
        cyc[2] += t2 - t1;
#pragma unroll
        for (int g = 0; g < G; ++g) {
          part[g] = lane + 32 * g < nv ? Vec<VEC>::dot(xj[g], gk[h][g]) : 0.f;
          pin(part[g]);
        }
        const long long t3 = mark();
        cyc[3] += t3 - t2;
"""),
    ("""        if (lane == q) dot_l[h] = dot;
      }
    }
""", """        if (lane == q) dot_l[h] = dot;
        pin(dot_l[h]);
        cyc[4] += mark() - t3;
      }
    }
"""),
    ("""    // the chunk's d_scores, one edge a lane: to scratch, and into d_s_dst[j]
    // in edge order
""", """    // the chunk's d_scores, one edge a lane: to scratch, and into d_s_dst[j]
    // in edge order
    const long long td = mark();
"""),
    ("""          -(dot_l[h] + r_l[h]) * e_l[h] * leaky_grad(score_l[h]);
      if (lane < m) scratch[at_l * H + h] = d_score;
      for (int q = 0; q < m; ++q) sum_dst[h] += __shfl_sync(FULL, d_score, q);
    }
""", """          -(dot_l[h] + r_l[h]) * e_l[h] * leaky_grad(score_l[h]);
      if (lane < m) scratch[at_l * H + h] = d_score;
      for (int q = 0; q < m; ++q) sum_dst[h] += __shfl_sync(FULL, d_score, q);
      pin(sum_dst[h]);
    }
    cyc[5] += mark() - td;
"""),
    ("""    if (s < nv) __stcs(reinterpret_cast<V*>(d_x + (size_t)j * c) + s, acc[g]);
  }
  if (lane == 0) {
#pragma unroll
    for (int h = 0; h < H; ++h) d_s_dst[(size_t)j * H + h] = sum_dst[h];
  }
""", """    if (s < nv) __stcs(reinterpret_cast<V*>(d_x + (size_t)j * c) + s, acc[g]);
  }
  if (lane == 0) {
#pragma unroll
    for (int h = 0; h < H; ++h) d_s_dst[(size_t)j * H + h] = sum_dst[h];
  }
""" + REPORT),
]

# This checkout's bf16 body: G and the term packed; the widening for the
# dot, which the kernel does inside it, is split out here.
PATCHES_BF16 = [
    ("""  V xj[G], acc[G];     // x[j] widened once; d_x[j] summed in fp32
""", ENTRY + """  V xj[G], acc[G];     // x[j] widened once; d_x[j] summed in fp32
"""),
    ("""      const int k = __shfl_sync(FULL, k_l, q);
      P gk[H][G];
""", """      const int k = __shfl_sync(FULL, k_l, q);
      P gk[H][G];
      const long long tq = mark();
"""),
    ("""          gk[h][g] = s < nv ? load_packed<VEC>(row, s, false) : P{};
        }
      }
""", """          gk[h][g] = s < nv ? load_packed<VEC>(row, s, false) : P{};
        }
      }
      {
        uint32_t touch = 0;
#pragma unroll
        for (int h = 0; h < H; ++h)
#pragma unroll
          for (int g = 0; g < G; ++g) touch ^= first_bits(gk[h][g]);
        sink ^= touch;
        cyc[0] += mark() - tq;
      }
"""),
    ("""#pragma unroll
        for (int g = 0; g < G; ++g) {
          const P p = mul_bf16x2(e2, gk[h][g]);
          term[g] = h == 0 ? p : add_bf16x2(term[g], p);
          part[h * G + g] =
              lane + 32 * g < nv ? dot_packed(xj[g], gk[h][g]) : 0.f;
        }
""", """        const long long t1 = mark();
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const P p = mul_bf16x2(e2, gk[h][g]);
          term[g] = h == 0 ? p : add_bf16x2(term[g], p);
          pin(term[g]);
        }
        const long long t2 = mark();
        cyc[2] += t2 - t1;
        V gw[G];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          gw[g] = widen(gk[h][g]);
          pin(gw[g]);
        }
        const long long t3 = mark();
        cyc[1] += t3 - t2;
#pragma unroll
        for (int g = 0; g < G; ++g) {
          part[h * G + g] =
              lane + 32 * g < nv ? Vec<VEC>::dot(xj[g], gw[g]) : 0.f;
          pin(part[h * G + g]);
        }
        cyc[3] += mark() - t3;
"""),
    ("""      warp_sums<H * G>(part, lane);
""", """      const long long t4 = mark();
      warp_sums<H * G>(part, lane);
"""),
    ("""        if (lane == q) dot_l[h] = dot;
      }
#pragma unroll
      for (int g = 0; g < G; ++g) add(acc[g], widen(term[g]));
""", """        if (lane == q) dot_l[h] = dot;
        pin(dot_l[h]);
      }
      cyc[4] += mark() - t4;
#pragma unroll
      for (int g = 0; g < G; ++g) add(acc[g], widen(term[g]));
"""),
    ("""    // the chunk's d_scores, one edge a lane, rounded to bf16: to scratch,
""", """    const long long td = mark();
    // the chunk's d_scores, one edge a lane, rounded to bf16: to scratch,
"""),
    ("""          round_bf16(-(dot_l[h] + r_l[h]) * e_l[h] * leaky_grad(score_l[h]));
      if (lane < m) scratch[at_l * H + h] = d_score;
      for (int q = 0; q < m; ++q) sum_dst[h] += __shfl_sync(FULL, d_score, q);
    }
""", """          round_bf16(-(dot_l[h] + r_l[h]) * e_l[h] * leaky_grad(score_l[h]));
      if (lane < m) scratch[at_l * H + h] = d_score;
      for (int q = 0; q < m; ++q) sum_dst[h] += __shfl_sync(FULL, d_score, q);
      pin(sum_dst[h]);
    }
    cyc[5] += mark() - td;
"""),
    ("""    if (s < nv) store_slice<VEC>(d_x + (size_t)j * c, s, acc[g]);
  }
  if (lane == 0) {
#pragma unroll
    for (int h = 0; h < H; ++h) d_s_dst[(size_t)j * H + h] = sum_dst[h];
  }
""", """    if (s < nv) store_slice<VEC>(d_x + (size_t)j * c, s, acc[g]);
  }
  if (lane == 0) {
#pragma unroll
    for (int h = 0; h < H; ++h) d_s_dst[(size_t)j * H + h] = sum_dst[h];
  }
""" + REPORT),
]

# The wide body that walks a row's column chunks in turn in one warp, and
# within an edge its heads in turn (gat_bwd_wide_rows with WIDE_GROUPS):
# phases WIDE_PHASES, the chunk count in slot 7.
WIDE_ENTRY = ENTRY.replace("cyc[7] = {0, 0, 0, 0, 0, 0, 0}",
                           "cyc[8] = {0, 0, 0, 0, 0, 0, 0, 0}")
WIDE_REPORT = REPORT.replace("for (int i = 0; i < 7; ++i)",
                             "for (int i = 0; i < 8; ++i)")
PATCHES_WIDE_CHUNKS = [
    ("""  const int chunks = (c / VEC + 32 * G - 1) / (32 * G);
""", """  const int chunks = (c / VEC + 32 * G - 1) / (32 * G);
""" + WIDE_ENTRY + """  cyc[7] = chunks;
"""),
    ("""          // the edge's weight, the same bits on every lane
          float src = s_src[(size_t)k * h + hh];
""", """          // the edge's weight, the same bits on every lane
          const long long ts = mark();
          float src = s_src[(size_t)k * h + hh];
"""),
    ("""          const float e = edge_weight(score);
          float part[G];
""", """          float e = edge_weight(score);
          pin(e);
          cyc[5] += mark() - ts;
          float part[G];
"""),
    ("""#pragma unroll
            for (int g = 0; g < G; ++g) {
              const int s = lane + 32 * g;
              const auto gk = s < nv ? load_packed<VEC>(row, s0 + s, false)
                                     : typename Packed<VEC>::T{};
              const auto p = mul_bf16x2(e2, gk);
              term[g] = hh == 0 ? p : add_bf16x2(term[g], p);
              part[g] = s < nv ? dot_packed(xj[g], gk) : 0.f;
            }
""", """            typename Packed<VEC>::T gk[G];
            const long long tq = mark();
            uint32_t touch = 0;
#pragma unroll
            for (int g = 0; g < G; ++g) {
              const int s = lane + 32 * g;
              gk[g] = s < nv ? load_packed<VEC>(row, s0 + s, false)
                             : typename Packed<VEC>::T{};
            }
#pragma unroll
            for (int g = 0; g < G; ++g) touch ^= first_bits(gk[g]);
            sink ^= touch;
            pin(sink);
            const long long t1 = mark();
            cyc[0] += t1 - tq;
#pragma unroll
            for (int g = 0; g < G; ++g) {
              const auto p = mul_bf16x2(e2, gk[g]);
              term[g] = hh == 0 ? p : add_bf16x2(term[g], p);
              pin(term[g]);
            }
            const long long t2 = mark();
            cyc[1] += t2 - t1;
#pragma unroll
            for (int g = 0; g < G; ++g) {
              part[g] = lane + 32 * g < nv ? dot_packed(xj[g], gk[g]) : 0.f;
              pin(part[g]);
            }
            cyc[2] += mark() - t2;
"""),
    ("""#pragma unroll
            for (int g = 0; g < G; ++g) {
              const int s = lane + 32 * g;
              const V gk = s < nv ? row[s] : V{};
              Vec<VEC>::fma(acc[g], e, gk);
              part[g] = s < nv ? Vec<VEC>::dot(xj[g], gk) : 0.f;
            }
""", """            V gk[G];
            const long long tq = mark();
            uint32_t touch = 0;
#pragma unroll
            for (int g = 0; g < G; ++g) {
              const int s = lane + 32 * g;
              gk[g] = s < nv ? row[s] : V{};
            }
#pragma unroll
            for (int g = 0; g < G; ++g) touch ^= first_bits(gk[g]);
            sink ^= touch;
            pin(sink);
            const long long t1 = mark();
            cyc[0] += t1 - tq;
#pragma unroll
            for (int g = 0; g < G; ++g) {
              Vec<VEC>::fma(acc[g], e, gk[g]);
              pin(acc[g]);
            }
            const long long t2 = mark();
            cyc[1] += t2 - t1;
#pragma unroll
            for (int g = 0; g < G; ++g) {
              part[g] = lane + 32 * g < nv ? Vec<VEC>::dot(xj[g], gk[g]) : 0.f;
              pin(part[g]);
            }
            cyc[2] += mark() - t2;
"""),
    ("""#pragma unroll
          for (int g = 0; g < G; ++g) {
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
              part[g] += __shfl_xor_sync(FULL, part[g], off);
          }
          if (lane == 0) {
""", """          const long long tb = mark();
#pragma unroll
          for (int g = 0; g < G; ++g) {
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
              part[g] += __shfl_xor_sync(FULL, part[g], off);
          }
#pragma unroll
          for (int g = 0; g < G; ++g) pin(part[g]);
          const long long tc = mark();
          cyc[3] += tc - tb;
          if (lane == 0) {
"""),
    ("""            scratch[at * h + hh] = dot;
          }
""", """            scratch[at * h + hh] = dot;
            pin(dot);
          }
          cyc[4] += mark() - tc;
"""),
    ("""        __stcs(reinterpret_cast<V*>(d_x + (size_t)j * c) + s0 + s, acc[g]);
    }
  }
}
""", """        __stcs(reinterpret_cast<V*>(d_x + (size_t)j * c) + s0 + s, acc[g]);
    }
  }
""" + WIDE_REPORT + "}\n"),
]

# This checkout's wide body (gat_bwd_wide_rows: a row's edges walked once,
# an edge's heads in groups with their G rows in flight together, the
# d_scores of a batch of edges from the group sums in shared memory):
# phases WIDE_PHASES, 1 in slot 7.  The loads' first uses are pinned
# (``pin(sink)``), so that the compiler cannot sink them past the mark.
WIDE_COUNTERS = """
__device__ __forceinline__ void pin(float2& v) { pin(v.x); pin(v.y); }
__device__ __forceinline__ void pin(Pair& v) { pin(v.w); }
__device__ __forceinline__ uint32_t first_bits(float2 v) { return __float_as_uint(v.x); }
__device__ __forceinline__ uint32_t first_bits(Pair v) { return v.w; }
"""
PATCHES_WIDE_BATCH = [
    ("""// ---- the wide path: any head count and width
""", """// ---- the wide path: any head count and width
""" + WIDE_COUNTERS),
    ("""  const bool last = (pass + 1) * ng * 32 >= nv_all;
""", """  const bool last = (pass + 1) * ng * 32 >= nv_all;
""" + WIDE_ENTRY + """  cyc[7] = 1;
"""),
    ("""    // the batch: each edge's column and slot, and per head its weight,
""", """    const long long ts = mark();
    // the batch: each edge's column and slot, and per head its weight,
"""),
    ("""      r_s[hh * batch + q] = r;
    }
    wide_sync(warps);
""", """      r_s[hh * batch + q] = r;
    }
    wide_sync(warps);
    cyc[5] += mark() - ts;
"""),
    ("""        P gk[HG][GW];
""", """        P gk[HG][GW];
        const long long tq = mark();
"""),
    ("""            gk[i][g] = hb + i < h && s < nv ? S::load(row, s_lo + s) : P{};
          }
        }
""", """            gk[i][g] = hb + i < h && s < nv ? S::load(row, s_lo + s) : P{};
          }
        }
        {
          uint32_t touch = 0;
#pragma unroll
          for (int i = 0; i < HG; ++i)
#pragma unroll
            for (int g = 0; g < GW; ++g) touch ^= first_bits(gk[i][g]);
          sink ^= touch;
          pin(sink);
          cyc[0] += mark() - tq;
        }
"""),
    ("""        float part[N];
#pragma unroll
        for (int i = 0; i < HG; ++i) {
          const float e = hb + i < h ? e_s[(hb + i) * batch + q] : 0.f;
#pragma unroll
          for (int g = 0; g < GW; ++g) {
            if (hb + i < h) {
              if constexpr (BF16) {
                const P p = mul_bf16x2(bf16_pair(e), gk[i][g]);
                term[g] = hb + i == 0 ? p : add_bf16x2(term[g], p);
              } else {
                Vec<VEC>::fma(acc[g], e, gk[i][g]);
              }
            }
            part[i * GW + g] =
                lane + 32 * g < nv ? S::dot(xj[g], gk[i][g]) : 0.f;
          }
        }
""", """        float part[N];
        const long long t1 = mark();
#pragma unroll
        for (int i = 0; i < HG; ++i) {
          const float e = hb + i < h ? e_s[(hb + i) * batch + q] : 0.f;
#pragma unroll
          for (int g = 0; g < GW; ++g) {
            if (hb + i < h) {
              if constexpr (BF16) {
                const P p = mul_bf16x2(bf16_pair(e), gk[i][g]);
                term[g] = hb + i == 0 ? p : add_bf16x2(term[g], p);
                pin(term[g]);
              } else {
                Vec<VEC>::fma(acc[g], e, gk[i][g]);
                pin(acc[g]);
              }
            }
          }
        }
        const long long t2 = mark();
        cyc[1] += t2 - t1;
#pragma unroll
        for (int i = 0; i < HG; ++i) {
#pragma unroll
          for (int g = 0; g < GW; ++g) {
            part[i * GW + g] =
                lane + 32 * g < nv ? S::dot(xj[g], gk[i][g]) : 0.f;
            pin(part[i * GW + g]);
          }
        }
        const long long t3 = mark();
        cyc[2] += t3 - t2;
"""),
    ("""              sum_s[(hh * ng + w * GW + i % GW) * stride + q] = held[v];
          }
        }
""", """              sum_s[(hh * ng + w * GW + i % GW) * stride + q] = held[v];
          }
        }
        cyc[3] += mark() - t3;
"""),
    ("""    wide_sync(warps);

    // the batch's d_scores (or partial dots)""",
     """    const long long td = mark();
    wide_sync(warps);

    // the batch's d_scores (or partial dots)"""),
    ("""      scratch[at * h + hh] = dot;
    }
    wide_sync(warps);
  }
""", """      scratch[at * h + hh] = dot;
    }
    wide_sync(warps);
    cyc[4] += mark() - td;
  }
"""),
    ("""      __stcs(reinterpret_cast<V*>(d_x + (size_t)j * c) + s_lo + s, acc[g]);
  }
}
""", """      __stcs(reinterpret_cast<V*>(d_x + (size_t)j * c) + s_lo + s, acc[g]);
  }
""" + WIDE_REPORT + "}\n"),
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


def patch_sets(text: str):
    """The patch sets that apply to this source: the parent's one template
    for both dtypes, or this checkout's two bodies; and the wide body that
    walks column chunks in turn, where the source has it."""
    if "gat_bwd_bf16_rows(" in text:
        sets = [("f32 body", PATCHES_F32), ("bf16 body", PATCHES_BF16)]
    else:
        sets = [("shared body", PATCHES_SHARED)]
    if "const int chunks = (c / VEC + 32 * G - 1) / (32 * G);" in text:
        sets.append(("wide chunk body", PATCHES_WIDE_CHUNKS))
    elif "warp_reduce_scatter" in text:
        sets.append(("wide batch body", PATCHES_WIDE_BATCH))
    return sets


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
    path.write_text(text + READ)
    return ", ".join(names)


def card_name() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]


def inputs(cs, torch, graph, h, c, bf16):
    g, x, s_src, s_dst, g_agg, g_rs = cs.gat_bwd_inputs(graph, c=c, h=h)
    if bf16:
        x, g_agg = x.to(torch.bfloat16), g_agg.to(torch.bfloat16)
    return g, x, s_src, s_dst, g_agg, g_rs


def measure(package: Path, what: str) -> int:
    """In a process of its own: the phase shares (``what`` = the patch
    sets, package = the patched copy) or the device ms and registers
    (``what`` = "times", package = the checkout)."""
    import ctypes
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    sys.path.insert(0, str(package))
    import torch
    from snag_tpu_torch.data.dataset import load_data
    from snag_tpu_torch.ops.cuda import gat_attention as ga
    from snag_tpu_torch.ops.cuda import gat_bwd as gb
    if not torch.cuda.is_available():
        print("torch_gat_bwd_phases: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    card = card_name()
    built = gb._library()
    graph = load_data(cs.cfg_from(cs.BENCH_ARGS + ["--device", "cpu"])).graph
    for h, c in SHAPES:
        for bf16 in (False, True):
            kernel = "gat_bwd_bf16" if bf16 else "gat_bwd"
            args = inputs(cs, torch, graph, h, c, bf16)
            wide = ga.wide(c, h, ga.slice_width(c, args[1], args[4]))
            part = "wide_rows" if wide else "rows"
            sums = "wide_sums" if wide else "src"

            def fn():
                return gb.gat_backward_cuda(*args[1:], args[0])
            xb = args[1].element_size()
            rec = {"kernel": kernel, "shape": f"C{c} H{h}", "wide": wide,
                   "card": card,
                   "gather_roof_ms": round(
                       args[0].n_edges * h * c * xb / cs.HBM_BYTES_PER_S
                       * 1e3, 4)}
            if what == "times":
                rec["package"] = str(package)
                rec["rows_device_ms"] = cs.device_ms(
                    fn, (f"{kernel}_{part}_kernel",))
                rec["sums_device_ms"] = cs.device_ms(
                    fn, (f"{kernel}_{sums}_kernel",))
                rec["device_ms"] = cs.device_ms(fn, cs.DEVICE_KERNELS[kernel])
                entries = ((f"{kernel}_wide_rows_kernel",) if wide else
                           (f"{kernel}_rows_kernelILi2ELi4ELi3E",
                            "_src_kernelILi2E"))
                rec["ptxas"] = [
                    {"entry": e, "registers": r, "spill_stores": s,
                     "spill_loads": ld}
                    for e, r, s, ld in cs.kernel_ptxas(built, entries)]
            else:
                out = (ctypes.c_ulonglong * 16)()
                fn()
                built.lib.phase_read(out)       # drop the first call's counts
                fn()
                if built.lib.phase_read(out):
                    raise RuntimeError("phase_read failed")
                total = out[6]
                phases = WIDE_PHASES if wide else PHASES
                named = {p: out[i] / total for i, p in enumerate(phases)}
                named["other"] = 1.0 - sum(named.values())
                rec |= {"patched": what,
                        **{p: round(v, 4) for p, v in named.items()},
                        "cycles_per_warp": round(total / max(out[15], 1))}
                if wide:
                    rec["chunks"] = round(out[7] / max(out[15], 1), 3)
            print(json.dumps(rec), flush=True)
            del args
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--measure"]:
        sys.exit(measure(Path(sys.argv[2]), sys.argv[3]))
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(ROOT))
    root = Path(ap.parse_args().root).resolve()
    patched = make_copy(root)
    rc = subprocess.run([sys.executable, __file__, "--measure", str(COPY),
                         patched]).returncode
    rc2 = subprocess.run([sys.executable, __file__, "--measure", str(root),
                          "times"]).returncode
    sys.exit(rc or rc2)
