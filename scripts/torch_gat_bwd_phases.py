#!/usr/bin/env python3
"""Where the GAT backward kernel's warps spend their cycles, on one NVIDIA GPU.

    python3 scripts/torch_gat_bwd_phases.py [--root DIR]

Copies DIR's ``snag_tpu_torch`` (default: this checkout's) to
``build/gat_bwd_phases/`` and adds ``clock64`` counters to that copy of
``csrc/gat_bwd.cu``'s first pass (DIR's own sources are not touched), then
runs ``gat_bwd`` and ``gat_bwd_bf16`` on ``chip_smoke.gat_bwd_inputs`` (the
bench graph: 30,000 nodes, 329,862 edges; C = 300, H = 2; bf16: x and G
rounded to bf16) and prints, per kernel, each phase's share of the warps'
summed cycles in the first pass:

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

and the cycles per warp.  The counters cost registers and issue slots, and
the marks pin values the compiler would otherwise schedule across them, so
the shares, not the times, are the result.  From DIR's unpatched build it
also prints the device ms of each kernel's two launches apart (the first
pass, a warp per row, and the second, d_s_src's row sums) and the first
pass's registers and spills.  An anchor that does not match the kernel
exits naming it.  One JSON line per kernel, with the card's name and
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
    for both dtypes, or this checkout's two bodies."""
    if "gat_bwd_bf16_rows(" in text:
        return [("f32 body", PATCHES_F32), ("bf16 body", PATCHES_BF16)]
    return [("shared body", PATCHES_SHARED)]


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


def inputs(cs, torch, bf16):
    from snag_tpu_torch.data.dataset import load_data
    graph = load_data(cs.cfg_from(cs.BENCH_ARGS + ["--device", "cpu"])).graph
    g, x, s_src, s_dst, g_agg, g_rs = cs.gat_bwd_inputs(graph)
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
    from snag_tpu_torch.ops.cuda import gat_bwd as gb
    if not torch.cuda.is_available():
        print("torch_gat_bwd_phases: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    card = card_name()
    built = gb._library()
    for bf16 in (False, True):
        kernel = "gat_bwd_bf16" if bf16 else "gat_bwd"
        args = inputs(cs, torch, bf16)

        def fn():
            return gb.gat_backward_cuda(*args[1:], args[0])
        rec = {"kernel": kernel, "shape": "C300 H2", "card": card}
        if what == "times":
            rec["package"] = str(package)
            for part in ("rows", "src"):
                rec[f"{part}_device_ms"] = cs.device_ms(
                    fn, (f"{kernel}_{part}_kernel",))
            rec["device_ms"] = cs.device_ms(fn, cs.DEVICE_KERNELS[kernel])
            rec["ptxas"] = [
                {"entry": e, "registers": r, "spill_stores": s,
                 "spill_loads": ld}
                for e, r, s, ld in cs.gat_ptxas(built, f"{kernel}_rows_kernel")]
        else:
            out = (ctypes.c_ulonglong * 16)()
            fn()
            built.lib.phase_read(out)           # drop the first call's counts
            fn()
            if built.lib.phase_read(out):
                raise RuntimeError("phase_read failed")
            total = out[6]
            named = {p: out[i] / total for i, p in enumerate(PHASES)}
            named["other"] = 1.0 - sum(named.values())
            rec |= {"patched": what,
                    **{p: round(v, 4) for p, v in named.items()},
                    "cycles_per_warp": round(total / max(out[15], 1))}
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
