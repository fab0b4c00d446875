#!/usr/bin/env python3
"""Where the wide GAT forward kernel's warps spend their cycles, on one NVIDIA GPU.

    python3 scripts/torch_gat_fwd_phases.py [--root DIR]
    python3 scripts/torch_gat_fwd_phases.py --measure DIR times
    python3 scripts/torch_gat_fwd_phases.py --variants [--root DIR]

Copies DIR's ``snag_tpu_torch`` (default: this checkout's) to
``build/gat_fwd_phases/`` and adds ``clock64`` counters to that copy of
``csrc/gat_attention.cu``'s wide body (DIR's own sources are not touched),
then runs ``gat_attention_cuda`` on ``chip_smoke.gat_bwd_inputs``'s x,
s_src and s_dst (the bench graph: 30,000 nodes, 329,862 edges; bf16: x
rounded to bf16) at each (H, C) of ``chip_smoke.PARITY_GAT``, f32 and
bf16.  It prints, per kernel and shape, each phase's share of the warps'
summed cycles in the wide body:

* ``wait``: the edge's x row (the parent's: from its loads to a first
  use of each of the lane's slices, an xor of their words kept live to
  the end; this checkout's: ``cp.async.wait_group`` for the edge's copies
  into the ring);
* ``weights``: the edge weights: their column ids, s_dst loads and exp
  (the parent's per 32 edges and at the first edge; this checkout's
  chunk of a tile's edges staged by every thread into shared memory,
  with its barriers);
* ``fma``: the fmaf of every head into the accumulators and rowsum's
  adds (this checkout's: with the widening of the slot's slices);
* ``shuffles``: the broadcast of an edge's column id and weights to the
  lanes (the parent's ``__shfl_sync``; this checkout's reads of the
  weights from shared memory);
* ``writes``: agg's streamed stores and rowsum;
* ``other``: the rest (the row's or tile's bounds, s_src, the loop, and
  this checkout's issue of the copies),

with the cycles a warp, the warps and the cycles of all warps summed
(the parent's warps walk a row once per column chunk and head group,
this checkout's walk a run of rows once).  The counters cost registers
and issue slots, and the marks pin values the compiler would otherwise
schedule across them, so the shares, not the times, are the result.

The patched copy also holds ``l2_probe_kernel``, which reads a 16 MB
buffer 20 times with 16-byte loads cached in L2 alone: the L2 read rate
of plain loads on this card (the profiler gives no L2 hit rate).  From
DIR's unpatched build (``times``) it prints each shape's device ms
(``chip_smoke.device_ms``), the registers and spills of the wide
instantiations (ptxas), and beside them: the gather roof (the E C x
elements an edge gathers, once, at 3.35 TB/s), agg's writes at 3.35
TB/s, and the floor max(agg's writes at 3.35 TB/s, (one pass of the
gathers + agg's writes) at the probe's L2 rate): x fits the 50 MB L2 at
C = 300 and 330, so its gathers are served there.  An anchor that does
not match the kernel exits naming it.  One JSON line per kernel and
shape, with the card's name and power limit.

``--variants`` times DIR's wide forward at each shape and dtype under
the launches of ``VARIANTS`` beside ``wide_plan``'s (other slice widths,
groups a lane and warps a row, each an instantiation the kernel has),
and requires each to give the plan's bits.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
COPY = ROOT / "build" / "gat_fwd_phases"
SOURCE = "snag_tpu_torch/csrc/gat_attention.cu"
PHASES = ("wait", "weights", "fma", "shuffles", "writes")
L2_PROBE_FLOATS = 4 * 1024 * 1024     # 16 MB: resident in the 50 MB L2
L2_PROBE_REPS = 20
L2_RATE = COPY / "l2_rate.json"        # the phases run's, for the times run
# (vec, gw, warps) beside wide_plan's, per (H, C) of chip_smoke.PARITY_GAT
VARIANTS = {(8, 300): ((4, 1, 3), (2, 3, 2), (2, 6, 1), (1, 6, 2), (1, 3, 4)),
            (8, 1536): ((2, 3, 8), (2, 6, 4), (1, 6, 8), (4, 1, 8)),
            (2, 330): ((1, 12, 1),)}
COUNTERS = """
__device__ unsigned long long g_phase[16];
namespace {
__device__ __forceinline__ void pin(float& v) { asm volatile("" : "+f"(v)); }
__device__ __forceinline__ void pin(float2& v) { pin(v.x); pin(v.y); }
__device__ __forceinline__ void pin(float4& v) {
  pin(v.x); pin(v.y); pin(v.z); pin(v.w);
}
__device__ __forceinline__ void pin(int& v) { asm volatile("" : "+r"(v)); }
__device__ __forceinline__ void pin(uint32_t& v) { asm volatile("" : "+r"(v)); }
__device__ __forceinline__ uint32_t first_bits(float v) { return __float_as_uint(v); }
__device__ __forceinline__ uint32_t first_bits(float2 v) { return __float_as_uint(v.x); }
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

# The parent's wide body: a warp a (row, column chunk of 32 WIDE_GROUPS
# slices, head group of 4), edge weights by lane and __shfl_sync, one x
# row in flight.  (anchor, replacement)
PATCHES_CHUNKS = [
    ("#include <type_traits>\n", "#include <type_traits>\n" + COUNTERS),
    ("""  const int s0 = blockIdx.y * 32 * G;
  const int nv = c / VEC - s0;  // the row's slices from s0 on
""", """  const int s0 = blockIdx.y * 32 * G;
  const int nv = c / VEC - s0;  // the row's slices from s0 on
""" + ENTRY),
    ("""    int j_l = 0;
    float e_l[HB];
#pragma unroll
    for (int h = 0; h < HB; ++h) e_l[h] = 0.f;
    if (lane < m) {
      j_l = col[base + lane];
#pragma unroll
      for (int h = 0; h < HB; ++h) {
        e_l[h] = s_dst[(size_t)j_l * ht + h0 + h];
        if constexpr (BF16) e_l[h] = round_bf16(e_l[h]);
      }
    }
""", """    const long long tw = mark();
    int j_l = 0;
    float e_l[HB];
#pragma unroll
    for (int h = 0; h < HB; ++h) e_l[h] = 0.f;
    if (lane < m) {
      j_l = col[base + lane];
#pragma unroll
      for (int h = 0; h < HB; ++h) {
        e_l[h] = s_dst[(size_t)j_l * ht + h0 + h];
        if constexpr (BF16) e_l[h] = round_bf16(e_l[h]);
      }
    }
    pin(j_l);
#pragma unroll
    for (int h = 0; h < HB; ++h) pin(e_l[h]);
    cyc[1] += mark() - tw;
"""),
    ("""    for (int q = 0; q < m; ++q) {  // the same q for every lane
      const int j = __shfl_sync(FULL, j_l, q);
      const X* row = x + (size_t)j * c;
      V v[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int s = lane + 32 * g;
        v[g] = s < nv ? load_slice<VEC>(row, s0 + s) : V{};
      }
      if (q == 0) {
#pragma unroll
        for (int h = 0; h < HB; ++h) {
          e_l[h] = edge_weight(src[h] + e_l[h]);
          if constexpr (BF16) e_l[h] = round_bf16(e_l[h]);
        }
      }
#pragma unroll
      for (int h = 0; h < HB; ++h) {
        const float e = __shfl_sync(FULL, e_l[h], q);
#pragma unroll
        for (int g = 0; g < G; ++g) Vec<VEC>::fma(acc[h][g], e, v[g]);
        rs[h] += e;
      }
    }
""", """    for (int q = 0; q < m; ++q) {  // the same q for every lane
      const long long t0 = mark();
      int j = __shfl_sync(FULL, j_l, q);
      pin(j);
      const long long t1 = mark();
      cyc[3] += t1 - t0;
      const X* row = x + (size_t)j * c;
      V v[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int s = lane + 32 * g;
        v[g] = s < nv ? load_slice<VEC>(row, s0 + s) : V{};
      }
      {
        uint32_t touch = 0;
#pragma unroll
        for (int g = 0; g < G; ++g) touch ^= first_bits(v[g]);
        sink ^= touch;
        pin(sink);
      }
      const long long t2 = mark();
      cyc[0] += t2 - t1;
      if (q == 0) {
#pragma unroll
        for (int h = 0; h < HB; ++h) {
          e_l[h] = edge_weight(src[h] + e_l[h]);
          if constexpr (BF16) e_l[h] = round_bf16(e_l[h]);
          pin(e_l[h]);
        }
      }
      const long long t3 = mark();
      cyc[1] += t3 - t2;
      float eq[HB];
#pragma unroll
      for (int h = 0; h < HB; ++h) {
        eq[h] = __shfl_sync(FULL, e_l[h], q);
        pin(eq[h]);
      }
      const long long t4 = mark();
      cyc[3] += t4 - t3;
#pragma unroll
      for (int h = 0; h < HB; ++h) {
#pragma unroll
        for (int g = 0; g < G; ++g) {
          Vec<VEC>::fma(acc[h][g], eq[h], v[g]);
          pin(acc[h][g]);
        }
        rs[h] += eq[h];
        pin(rs[h]);
      }
      cyc[2] += mark() - t4;
    }
"""),
    ("""#pragma unroll
  for (int h = 0; h < HB; ++h) {
    V* out = reinterpret_cast<V*>(agg + ((size_t)i * ht + h0 + h) * c) + s0;
""", """  const long long t_out = mark();
#pragma unroll
  for (int h = 0; h < HB; ++h) {
    V* out = reinterpret_cast<V*>(agg + ((size_t)i * ht + h0 + h) * c) + s0;
"""),
    ("""    for (int h = 0; h < HB; ++h) rowsum[(size_t)i * ht + h0 + h] = rs[h];
  }
}
""", """    for (int h = 0; h < HB; ++h) rowsum[(size_t)i * ht + h0 + h] = rs[h];
  }
  cyc[4] += mark() - t_out;
""" + REPORT + "}\n"),
]

# This checkout's wide body (gat_fwd_wide_tile: a block's tile of rows,
# its edges' column ids and weights staged in shared memory by all its
# threads a chunk at a time, each row group's edges streamed with x rows
# copied ahead into a ring in shared memory by cp.async): the weights are
# the chunk's staging with its barriers, the wait is the wait for an
# edge's copies (cp.async.wait_group), the weights' reads from shared
# memory stand for the parent's shuffles, the writes are the rows' sums
# written where the stream passes their end, and the copies' issue (with
# the column id's read) is "other".
PATCHES_TILE = [
    ("#include <type_traits>\n", "#include <type_traits>\n" + COUNTERS),
    ("""  const bool sums = blockIdx.z == 0 && w == 0;  // rowsum's warps
""", """  const bool sums = blockIdx.z == 0 && w == 0;  // rowsum's warps
""" + ENTRY),
    ("""    if (c0 > rp[0]) __syncthreads();   // every warp is done with the last chunk
""", """    const long long tw = mark();
    if (c0 > rp[0]) __syncthreads();   // every warp is done with the last chunk
"""),
    ("""    __syncthreads();

    // this group's edges of the chunk, streamed through the ring
""", """    __syncthreads();
    cyc[1] += mark() - tw;

    // this group's edges of the chunk, streamed through the ring
"""),
    ("""      while (c0 + q >= rp[r + 1]) flush(r++);   // rows that ended before q
      cp_async_wait<D - 1>();
      const P* slot = ring + (q % D) * GW * 32 + lane;
      float e[HB];
      load_weights<HB>(es + q * HB, e);
      V xv[GW];
#pragma unroll
      for (int g = 0; g < GW; ++g)
        xv[g] = lane + 32 * g < nv ? R::widen(slot[32 * g]) : V{};
#pragma unroll
      for (int hh = 0; hh < HB; ++hh) {
        if (hh < hl) {
#pragma unroll
          for (int g = 0; g < GW; ++g) Vec<VEC>::fma(acc[hh][g], e[hh], xv[g]);
        }
      }
      if (sums && lane < hl) rs += es[q * HB + lane];
""", """      const long long tf = mark();
      while (c0 + q >= rp[r + 1]) flush(r++);   // rows that ended before q
      const long long t0 = mark();
      cyc[4] += t0 - tf;
      cp_async_wait<D - 1>();
      const long long t1 = mark();
      cyc[0] += t1 - t0;
      const P* slot = ring + (q % D) * GW * 32 + lane;
      float e[HB];
      load_weights<HB>(es + q * HB, e);
#pragma unroll
      for (int hh = 0; hh < HB; ++hh) pin(e[hh]);
      const long long t2 = mark();
      cyc[3] += t2 - t1;
      V xv[GW];
#pragma unroll
      for (int g = 0; g < GW; ++g)
        xv[g] = lane + 32 * g < nv ? R::widen(slot[32 * g]) : V{};
#pragma unroll
      for (int hh = 0; hh < HB; ++hh) {
        if (hh < hl) {
#pragma unroll
          for (int g = 0; g < GW; ++g) {
            Vec<VEC>::fma(acc[hh][g], e[hh], xv[g]);
            pin(acc[hh][g]);
          }
        }
      }
      if (sums && lane < hl) rs += es[q * HB + lane];
      pin(rs);
      cyc[2] += mark() - t2;
"""),
    ("""  while (r < rb) flush(r++);
}
""", """  const long long tf = mark();
  while (r < rb) flush(r++);
  cyc[4] += mark() - tf;
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

// reps passes of L2-cached 16-byte reads over p (n floats), a thread's
// sums kept live in out: the L2 read rate of a stream of plain loads
__global__ void l2_probe_kernel(const float4* __restrict__ p, long long n4,
                                int reps, float* __restrict__ out) {
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (int r = 0; r < reps; ++r)
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < n4; i += stride) {
      const float4 v = __ldcg(p + i);
      a.x += v.x;
      a.y += v.y;
      a.z += v.z;
      a.w += v.w;
    }
  out[(size_t)blockIdx.x * blockDim.x + threadIdx.x] = a.x + a.y + a.z + a.w;
}

extern "C" int l2_probe(const float* p, long long n, int reps, float* out,
                        int blocks, void* stream) {
  l2_probe_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(p), n / 4, reps, out);
  return static_cast<int>(cudaGetLastError());
}
"""


def patch_sets(text: str):
    """The patch set of this source's wide body: the parent's column-chunk
    body or this checkout's tile body."""
    if "const int s0 = blockIdx.y * 32 * G;" in text:
        return [("wide chunk body", PATCHES_CHUNKS)]
    if "gat_fwd_wide_tile(" in text:
        return [("wide tile body", PATCHES_TILE)]
    raise SystemExit(f"no known wide body in {SOURCE}")


def make_copy(root: Path) -> str:
    """The patched copy of root's package under COPY; returns which patch
    set it took."""
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


def l2_rate(cs, torch, built) -> float:
    """Bytes a ms that the patched copy's ``l2_probe_kernel`` reads in
    L2_PROBE_REPS passes over L2_PROBE_FLOATS floats, 16 bytes a load
    cached in L2 alone, 8 blocks of 256 threads an SM: the L2 read rate of
    plain loads on this card (the profiler gives no L2 hit rate)."""
    import ctypes
    from snag_tpu_torch.ops.cuda._lib import ptr, stream_of
    fn = built.lib.l2_probe
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    blocks = 8 * torch.cuda.get_device_properties(0).multi_processor_count
    probe = torch.rand(L2_PROBE_FLOATS, device="cuda")
    out = torch.empty(blocks * 256, device="cuda")

    def run():
        if fn(ptr(probe), L2_PROBE_FLOATS, L2_PROBE_REPS, ptr(out), blocks,
              stream_of(probe)):
            raise RuntimeError("l2_probe failed")
    ms = cs.device_ms(run, ("l2_probe_kernel",))
    return 4 * L2_PROBE_FLOATS * L2_PROBE_REPS / ms


def measure(package: Path, what: str) -> int:
    """In a process of its own: the phase shares (``what`` = the patch
    set, package = the patched copy) or the device ms, registers and
    floors (``what`` = "times", package = the checkout)."""
    import ctypes
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    sys.path.insert(0, str(package))
    import torch
    from snag_tpu_torch.data.dataset import load_data
    from snag_tpu_torch.ops.cuda import gat_attention as ga
    if not torch.cuda.is_available():
        print("torch_gat_fwd_phases: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    card = card_name()
    built = ga._library()
    graph = load_data(cs.cfg_from(cs.BENCH_ARGS + ["--device", "cpu"])).graph
    if what == "times":
        rate = (json.loads(L2_RATE.read_text())["bytes_per_ms"]
                if L2_RATE.exists() else None)
    else:
        rate = l2_rate(cs, torch, built)
        L2_RATE.write_text(json.dumps({"bytes_per_ms": rate}))
        print(json.dumps({"l2_read_gb_s": round(rate / 1e6, 1),
                          "probe_mb": 4 * L2_PROBE_FLOATS / 2 ** 20,
                          "card": card}), flush=True)
    for h, c in cs.PARITY_GAT:
        g, x, s_src, s_dst, _, _ = cs.gat_bwd_inputs(graph, c=c, h=h)
        for bf16 in (False, True):
            xs = x.to(torch.bfloat16) if bf16 else x
            name = f"gat_attention_fwd{'_bf16' if bf16 else ''}_wide"

            def fn():
                return ga.gat_attention_cuda(xs, s_src, s_dst, g)
            n, e, xb = xs.shape[0], g.n_edges, xs.element_size()
            gathered, written = e * c * xb, 4 * n * h * (c + 1)
            rec = {"kernel": name, "shape": f"H{h} C{c}", "card": card,
                   "package": str(package),
                   "gather_roof_ms": round(gathered / cs.HBM_BYTES_PER_S
                                           * 1e3, 4),
                   "writes_hbm_ms": round(written / cs.HBM_BYTES_PER_S
                                          * 1e3, 4)}
            if what == "times":
                rec["device_ms"] = cs.device_ms(fn, cs.DEVICE_KERNELS[name])
                if rate:
                    rec["l2_read_gb_s"] = round(rate / 1e6, 1)
                    rec["l2_floor_ms"] = round(max(
                        written / cs.HBM_BYTES_PER_S * 1e3,
                        (gathered + written) / rate), 4)
                rec["ptxas"] = [
                    {"entry": en, "registers": r, "spill_stores": st,
                     "spill_loads": ld}
                    for en, r, st, ld in cs.kernel_ptxas(
                        built, (f"{name}_kernel",))]
            else:
                out = (ctypes.c_ulonglong * 16)()
                fn()
                built.lib.phase_read(out)       # drop the first call's counts
                fn()
                if built.lib.phase_read(out):
                    raise RuntimeError("phase_read failed")
                total, warps = out[5], max(out[15], 1)
                named = {p: out[i] / total for i, p in enumerate(PHASES)}
                named["other"] = 1.0 - sum(named.values())
                rec |= {"patched": what,
                        **{p: round(v, 4) for p, v in named.items()},
                        "cycles_per_warp": round(total / warps),
                        "warps": warps, "cycles": total}
            print(json.dumps(rec), flush=True)
        del g, x, s_src, s_dst
        torch.cuda.empty_cache()
    return 0


def launch(ga, x, s_src, s_dst, g, vec, plan):
    """DIR's wide forward under ``plan`` (hn, gw, warps) at slice width
    vec: (agg, rowsum)."""
    import torch
    from snag_tpu_torch.ops.cuda._lib import check, ptr, stream_of
    n, c = x.shape
    h = s_src.shape[1]
    agg = torch.empty(n, h, c, device=x.device)
    rowsum = torch.empty(n, h, device=x.device)
    built = ga._library()
    name = ("gat_attention_fwd_bf16" if x.dtype == torch.bfloat16
            else "gat_attention_fwd")
    err = getattr(built.lib, name)(
        ptr(x), ptr(s_src), ptr(s_dst), ptr(g.row_ptr), ptr(g.col), ptr(agg),
        ptr(rowsum), n, c, h, vec, plan["hn"], plan["gw"], plan["warps"],
        stream_of(x))
    check(built, err, name)
    return agg, rowsum


def variants(package: Path) -> int:
    """Each VARIANTS launch's device ms beside the plan's, and its bits."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    sys.path.insert(0, str(package))
    import torch
    from snag_tpu_torch.data.dataset import load_data
    from snag_tpu_torch.ops.cuda import gat_attention as ga
    if not torch.cuda.is_available():
        print("torch_gat_fwd_phases: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    card = card_name()
    graph = load_data(cs.cfg_from(cs.BENCH_ARGS + ["--device", "cpu"])).graph
    for h, c in cs.PARITY_GAT:
        g, x, s_src, s_dst, _, _ = cs.gat_bwd_inputs(graph, c=c, h=h)
        for bf16 in (False, True):
            xs = x.to(torch.bfloat16) if bf16 else x
            name = f"gat_attention_fwd{'_bf16' if bf16 else ''}_wide"
            vec, _ = ga.wide_slice_width(c, h, xs)
            plan = ga.wide_plan(c, h, vec, bf16)
            want = ga.gat_attention_cuda(xs, s_src, s_dst, g)
            runs = [(vec, plan["gw"], plan["warps"])] + list(VARIANTS[h, c])
            for v, gw, warps in runs:
                p = dict(plan, gw=gw, warps=warps)
                fn = (lambda v=v, p=p: launch(ga, xs, s_src, s_dst, g, v, p))
                same = all(torch.equal(a, b) for a, b in zip(fn(), want))
                print(json.dumps({
                    "kernel": name, "shape": f"H{h} C{c}", "vec": v, "gw": gw,
                    "warps": warps, "plan": (v, gw, warps) == runs[0],
                    "device_ms": cs.device_ms(fn, cs.DEVICE_KERNELS[name]),
                    "same_bits": same, "card": card}), flush=True)
                if not same:
                    return 1
            del want
        del g, x, s_src, s_dst
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--variants"]:
        ap = argparse.ArgumentParser()
        ap.add_argument("--variants", action="store_true")
        ap.add_argument("--root", default=str(ROOT))
        sys.exit(variants(Path(ap.parse_args().root).resolve()))
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
