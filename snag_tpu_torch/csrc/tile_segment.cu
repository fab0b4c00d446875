// Weighted segment sum over the CSR rows of a graph, for Hopper, f32 or
// bf16 operands.
//
// Replaces snag_tpu/ops/pallas/tile_segment.py::tile_weighted_segment_sum
// (grids _kernel_flat and _kernel).  For every row i, head h and edge
// k = i <- j in row_ptr[i]..row_ptr[i+1]:
//     agg[i,h,:]  = sum_k e[k,h] * x[col[k],:]
//     rowsum[i,h] = sum_k e[k,h]
// for any number of heads H.  It is the GCN's aggregation (D^-1/2 A D^-1/2
// applied to x W, H = 1, e = the adjacency values) and, run with the
// weights of the reverse edges e[rev], its input gradient: on a symmetric
// edge multiset a node's in-edges are its CSR row's edges reversed.
//
// What bounds it on the H100: the gathered bytes.  Each edge reads one x
// row (E*C*4 bytes: 396 MB at E = 329,862, C = 300) for 2*H*C flops; the
// N*C*4-byte x table (36 MB at N = 30,000) fits in the 50 MB L2, so most
// of those reads hit L2, and device memory sees little more than x, e,
// col and the output once (~75 MB, ~22 us at 3.35 TB/s).
//
// What the design does about it: the TPU kernel takes the gathered (E, C)
// edge block x[col] from device memory and reduces it with one-hot MXU
// dots per row tile.  Here nothing is materialised, and a row costs no
// block barrier, no shared memory and no serial thread: one warp owns one
// row (WARPS rows a block).  The column ids and weights of up to 32 of its
// edges are loaded one edge a lane and broadcast by shuffle; lane l owns
// the slices l, l + 32, ... (G of them, a template parameter) of a column
// chunk of 32 G slices (blockIdx.y) and keeps up to MAX_HEADS heads'
// register accumulators (blockIdx.z walks the head groups).  One edge's x
// row is in flight at a time, so that registers stay few and an SM holds
// more warps; x is read once per edge for all heads of a group, agg is
// written once and streamed past L2.  No value crosses slices, so a row
// wider than 32 G slices is cut into chunks that each walk the row's edges;
// a row of any length is walked by its one warp, 32 edges at a time.  No
// atomics, and the edge order within a row is fixed: agg is an fmaf chain
// over the row's edges in CSR order from 0 and rowsum a sum in edge order
// from 0, the bits of the block-per-row kernel this one replaced.  This is
// the walk of gat_attention.cu without the score and the exp.
//
// weighted_segment_sum_bf16: the same sums on bf16 x and e (the JAX GCN
// under --dtype bfloat16, snag_tpu/ops/gnn.py:43-50), with the Pallas
// kernel's arithmetic (tile_segment.py:209-234): the one-hot times a bf16
// e is e itself, the MXU forms each product e x of two bf16 values exactly
// in fp32 and adds the products in fp32, and rowsum is an fp32 sum of the
// bf16 e; agg and rowsum are fp32.  A bf16 e times a bf16 x is exact in
// fp32, so the fmaf chain is that sum.  ROUND_TERM rounds each edge's term
// e x to bf16 before the fp32 add: the GCN backward's reverse-edge launch,
// where JAX rounds every edge's e g to bf16 (snag_tpu/ops/gat_agg.py:104)
// before its column reduction adds them in fp32 and rounds the sum to bf16
// (:112); with out_bf16 the launch writes that bf16 sum itself and no
// rowsum.
//
// It has a body of its own, built for bf16 rows.  What bounds it is the
// same as above: the gathered rows (E*C*2 bytes, 198 MB at the bench
// shape, from an 18 MB x table that stays in L2), fetched by L2 round trips
// whose latency under this load sets how many rows must be in flight.  The
// f32 walk, a warp a row, puts a 600-byte bf16 row (C = 300) on 96 lane
// slots of 8 bytes (21 idle) and has one row in flight a warp.  Here a row
// takes `lanes` = 16 lanes where its slices fit in 16 x MAX_GROUPS_BF16
// (75 of 80 at C = 300), so a warp walks two rows and has two in flight at
// 56 registers (36 warps an SM).  (Two edges' rows loaded before the first
// is added, rows walked four at a time as one edge stream, 8 lanes a row,
// a persistent grid fed by an atomic counter and fewer registers for more
// warps were each measured slower; PERF.md.)  Both halves of a warp run
// the longer row's trip count, and the half whose row has no edge left
// loads and adds nothing, so every shuffle has the whole warp.  Under
// ROUND_TERM each product is formed on packed bf16 pairs (mul.rn.bf16x2, e
// broadcast as a pair): rounded once to nearest even, the bits of
// round_bf16(e * x) in fp32 (a product of two bf16 is exact in fp32, and
// where it is too small for fp32's normal range its one fp32 rounding
// cannot land on a bf16 midpoint; held against f64 in
// tests/test_torch_gat_bwd_bf16_schedule.py), two elements an instruction.
// Only the order of the loads changed: agg is still an fmaf chain (or an
// __fadd_rn chain of rounded terms) over the row's edges in CSR order from
// 0, rowsum a sum in edge order from 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int MAX_HEADS = 4;    // heads a launch group
constexpr int MAX_GROUPS = 4;   // slices a lane in one column chunk
constexpr int MAX_GROUPS_BF16 = 5;  // slices a lane in one column chunk (bf16)
constexpr int WARPS = 4;        // warps a block
constexpr unsigned FULL = 0xffffffffu;

template <int VEC> struct Vec;
template <> struct Vec<1> {
  using T = float;
  __device__ static void fma(float& acc, float e, float v) {
    acc = fmaf(e, v, acc);
  }
};
template <> struct Vec<4> {
  using T = float4;
  __device__ static void fma(float4& acc, float e, float4 v) {
    acc.x = fmaf(e, v.x, acc.x);
    acc.y = fmaf(e, v.y, acc.y);
    acc.z = fmaf(e, v.z, acc.z);
    acc.w = fmaf(e, v.w, acc.w);
  }
};

// The launch plan of weighted_segment_sum (ops/cuda/tile_segment.py's
// launch_plan computes the same): c / vec slices in 32-lane groups, cut
// into the fewest column chunks of at most MAX_GROUPS groups, the groups
// shared out evenly; heads in groups of MAX_HEADS, the last HB < MAX_HEADS
// launched on its own.  The bf16 plan (plan_bf16) also gives the lanes of
// a row.
struct Plan {
  int groups, chunks, full, tail, lanes;
};

Plan plan_for(int c, int h, int vec) {
  const int lane_groups = (c / vec + 31) / 32;
  const int chunks = (lane_groups + MAX_GROUPS - 1) / MAX_GROUPS;
  return {(lane_groups + chunks - 1) / chunks, chunks, h / MAX_HEADS,
          h % MAX_HEADS, 32};
}

// bf16: a row of at most 16 MAX_GROUPS_BF16 slices takes 16 lanes, in one
// chunk; a wider row 32 lanes, in the fewest chunks of at most
// MAX_GROUPS_BF16 groups, shared out evenly (at C = 319 in single bf16
// two chunks of 5 walk faster than the f32 plan's three of 4).
Plan plan_bf16(int c, int h, int vec) {
  const int nv = c / vec;
  if (nv <= 16 * MAX_GROUPS_BF16)
    return {(nv + 15) / 16, 1, h / MAX_HEADS, h % MAX_HEADS, 16};
  const int lane_groups = (nv + 31) / 32;
  const int chunks = (lane_groups + MAX_GROUPS_BF16 - 1) / MAX_GROUPS_BF16;
  return {(lane_groups + chunks - 1) / chunks, chunks, h / MAX_HEADS,
          h % MAX_HEADS, 32};
}

// Heads h0 .. h0+HB-1 (h0 = blockIdx.z * MAX_HEADS) of rows
// blockIdx.x * WARPS + warp, slices blockIdx.y * 32 G + lane + 32 g: the
// f32 kernel's body.
template <int HB, int VEC, int G>
__device__ __forceinline__ void segment_rows(
    const float* __restrict__ x, const float* __restrict__ e,
    const int* __restrict__ row_ptr, const int* __restrict__ col,
    float* __restrict__ agg, float* __restrict__ rowsum, int n, int c,
    int h) {
  using V = typename Vec<VEC>::T;
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (i >= n) return;  // a tail warp; nothing below waits on a barrier
  const int h0 = blockIdx.z * MAX_HEADS;
  const int s0 = blockIdx.y * 32 * G + lane;
  const int nv = c / VEC;

  V acc[HB][G];
  float rs[HB];
#pragma unroll
  for (int q = 0; q < HB; ++q) {
    rs[q] = 0.f;
#pragma unroll
    for (int g = 0; g < G; ++g) acc[q][g] = V{};
  }
  const int beg = row_ptr[i];
  const int end = row_ptr[i + 1];

  for (int base = beg; base < end; base += 32) {
    const int m = min(32, end - base);
    // edge base + lane: its column and weights
    int j_l = 0;
    float e_l[HB];
#pragma unroll
    for (int q = 0; q < HB; ++q) e_l[q] = 0.f;
    if (lane < m) {
      j_l = col[base + lane];
#pragma unroll
      for (int q = 0; q < HB; ++q)
        e_l[q] = e[(size_t)(base + lane) * h + h0 + q];
    }

    for (int k = 0; k < m; ++k) {  // the same k for every lane
      const int j = __shfl_sync(FULL, j_l, k);
      const V* xr = reinterpret_cast<const V*>(x + (size_t)j * c);
      V v[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int s = s0 + 32 * g;
        v[g] = s < nv ? xr[s] : V{};
      }
#pragma unroll
      for (int q = 0; q < HB; ++q) {
        const float ek = __shfl_sync(FULL, e_l[q], k);
#pragma unroll
        for (int g = 0; g < G; ++g) Vec<VEC>::fma(acc[q][g], ek, v[g]);
        rs[q] += ek;
      }
    }
  }

#pragma unroll
  for (int q = 0; q < HB; ++q) {
    V* out = reinterpret_cast<V*>(agg + ((size_t)i * h + h0 + q) * c);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int s = s0 + 32 * g;
      if (s < nv) __stcs(out + s, acc[q][g]);
    }
  }
  if (blockIdx.y == 0 && lane == 0) {  // every chunk sums the same weights
#pragma unroll
    for (int q = 0; q < HB; ++q) rowsum[(size_t)i * h + h0 + q] = rs[q];
  }
}

// ---- weighted_segment_sum_bf16's body

// A slice of a bf16 row, packed: VEC = 4, two 32-bit words of two bf16
// each (the lower address in the low half); VEC = 1, one bf16 in the low
// half of a word.
template <int VEC> struct Packed;
template <> struct Packed<4> { using T = uint2; };
template <> struct Packed<1> { using T = uint32_t; };

__device__ __forceinline__ uint2 load_packed(const uint2* row, int s) {
  return row[s];
}
__device__ __forceinline__ uint32_t load_packed(const unsigned short* row,
                                                int s) {
  return row[s];
}

// The bf16 of a word's low or high half as fp32 (exact).
__device__ __forceinline__ float lo_f32(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi_f32(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// Both bf16 of b times the bf16 pair a, each product rounded once to
// nearest even (sm_90's bf16 multiply): round_bf16(a * b) in fp32, two
// elements an instruction.
__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// acc + e v for the slice v: an fmaf of its widened bf16, or under
// ROUND_TERM the products rounded to bf16 (e2: e in both halves) added by
// __fadd_rn.
template <bool ROUND_TERM>
__device__ __forceinline__ void add_slice(float4& acc, float e, uint32_t e2,
                                          uint2 v) {
  if constexpr (ROUND_TERM) {
    const uint32_t p = mul_bf16x2(e2, v.x), q = mul_bf16x2(e2, v.y);
    acc.x = __fadd_rn(acc.x, lo_f32(p));
    acc.y = __fadd_rn(acc.y, hi_f32(p));
    acc.z = __fadd_rn(acc.z, lo_f32(q));
    acc.w = __fadd_rn(acc.w, hi_f32(q));
  } else {
    acc.x = fmaf(e, lo_f32(v.x), acc.x);
    acc.y = fmaf(e, hi_f32(v.x), acc.y);
    acc.z = fmaf(e, lo_f32(v.y), acc.z);
    acc.w = fmaf(e, hi_f32(v.y), acc.w);
  }
}
template <bool ROUND_TERM>
__device__ __forceinline__ void add_slice(float& acc, float e, uint32_t e2,
                                          uint32_t v) {
  if constexpr (ROUND_TERM) acc = __fadd_rn(acc, lo_f32(mul_bf16x2(e2, v)));
  else acc = fmaf(e, lo_f32(v), acc);
}

// A slice's fp32 sums written in fp32 (streamed past L2), or rounded once
// to bf16.
__device__ __forceinline__ void store_slice(float* row, int s, float4 v) {
  __stcs(reinterpret_cast<float4*>(row) + s, v);
}
__device__ __forceinline__ void store_slice(float* row, int s, float v) {
  __stcs(row + s, v);
}
__device__ __forceinline__ uint32_t bf16x2_bits(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}
__device__ __forceinline__ void store_slice(__nv_bfloat16* row, int s,
                                            float4 v) {
  __stcs(reinterpret_cast<uint2*>(row) + s,
         make_uint2(bf16x2_bits(v.x, v.y), bf16x2_bits(v.z, v.w)));
}
__device__ __forceinline__ void store_slice(__nv_bfloat16* row, int s,
                                            float v) {
  __stcs(reinterpret_cast<unsigned short*>(row) + s,
         __bfloat16_as_ushort(__float2bfloat16_rn(v)));
}

// Heads h0 .. h0+HB-1 (h0 = blockIdx.z * MAX_HEADS) of row
// (blockIdx.x * WARPS + warp) * 32 / lanes + lane / lanes, slices
// blockIdx.y * lanes * G + lane % lanes + lanes g; out is agg (f32) or,
// with out_bf16, its bf16 rounding, and rowsum is written unless null.
template <bool ROUND_TERM, int HB, int VEC, int G>
__device__ __forceinline__ void segment_rows_bf16(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ e,
    const int* __restrict__ row_ptr, const int* __restrict__ col,
    void* __restrict__ out, float* __restrict__ rowsum, int n, int c, int h,
    int lanes, bool out_bf16) {
  using V = typename Vec<VEC>::T;
  using P = typename Packed<VEC>::T;
  using Slices = typename std::conditional<VEC == 4, uint2,
                                           unsigned short>::type;
  const int lane = threadIdx.x & 31;
  const int half = lane / lanes;
  const int rl = lane & (lanes - 1);
  const int first = (blockIdx.x * WARPS + (threadIdx.x >> 5)) * (32 / lanes);
  if (first >= n) return;  // a tail warp; nothing below waits on a barrier
  const int i = first + half;
  const bool live = i < n;   // a half of the last warp may have no row
  const int h0 = blockIdx.z * MAX_HEADS;
  const int s0 = blockIdx.y * lanes * G + rl;
  const int nv = c / VEC;

  V acc[HB][G];
  float rs[HB];
#pragma unroll
  for (int q = 0; q < HB; ++q) {
    rs[q] = 0.f;
#pragma unroll
    for (int g = 0; g < G; ++g) acc[q][g] = V{};
  }
  const int beg = live ? row_ptr[i] : 0;
  const int len = live ? row_ptr[i + 1] - beg : 0;
  // the warp's longest row: every half runs its trip count
  int most = len;
  for (int o = lanes; o < 32; o <<= 1)
    most = max(most, __shfl_xor_sync(FULL, most, o));

  for (int base = 0; base < most; base += lanes) {
    const int m = len - base;               // this row's edges left
    const int mk = min(lanes, most - base);  // the same in every lane
    // edge beg + base + rl: its column and weights' bits
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

    for (int k = 0; k < mk; ++k) {  // the same k in every lane
      const int j = __shfl_sync(FULL, j_l, k, lanes);
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
      if (k >= m) continue;  // this half's row has no edge left
#pragma unroll
      for (int q = 0; q < HB; ++q) {
        const float ek = lo_f32(eb[q]);
        const uint32_t e2 = eb[q] | (eb[q] << 16);
#pragma unroll
        for (int g = 0; g < G; ++g)
          add_slice<ROUND_TERM>(acc[q][g], ek, e2, v[g]);
        rs[q] += ek;
      }
    }
  }

  if (!live) return;
#pragma unroll
  for (int q = 0; q < HB; ++q) {
    const size_t at = ((size_t)i * h + h0 + q) * c;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int s = s0 + lanes * g;
      if (s >= nv) continue;
      if (out_bf16)
        store_slice(static_cast<__nv_bfloat16*>(out) + at, s, acc[q][g]);
      else
        store_slice(static_cast<float*>(out) + at, s, acc[q][g]);
    }
  }
  // every chunk sums the same weights
  if (rowsum != nullptr && blockIdx.y == 0 && rl == 0) {
#pragma unroll
    for (int q = 0; q < HB; ++q) rowsum[(size_t)i * h + h0 + q] = rs[q];
  }
}

template <int HB, int VEC, int G>
__global__ void __launch_bounds__(32 * WARPS)
weighted_segment_sum_kernel(const float* __restrict__ x,
                            const float* __restrict__ e,
                            const int* __restrict__ row_ptr,
                            const int* __restrict__ col,
                            float* __restrict__ agg,
                            float* __restrict__ rowsum, int n, int c, int h) {
  segment_rows<HB, VEC, G>(x, e, row_ptr, col, agg, rowsum, n, c, h);
}

// named apart so that a profile tells the two apart
template <int HB, int VEC, int G, bool ROUND_TERM>
__global__ void __launch_bounds__(32 * WARPS)
weighted_segment_sum_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                                 const __nv_bfloat16* __restrict__ e,
                                 const int* __restrict__ row_ptr,
                                 const int* __restrict__ col,
                                 void* __restrict__ out,
                                 float* __restrict__ rowsum, int n, int c,
                                 int h, int lanes, bool out_bf16) {
  segment_rows_bf16<ROUND_TERM, HB, VEC, G>(x, e, row_ptr, col, out, rowsum,
                                            n, c, h, lanes, out_bf16);
}

template <typename X>
struct Args {
  const X *x, *e;
  const int *row_ptr, *col;
  void* out;       // agg: f32, or bf16 (out_bf16)
  float* rowsum;   // null: not written
  int n, c, h, lanes;
  bool round_term, out_bf16;
};

template <typename X, int HB, int VEC, int G>
void launch_rows(const Args<X>& a, dim3 grid, cudaStream_t s) {
  if constexpr (std::is_same<X, float>::value)
    weighted_segment_sum_kernel<HB, VEC, G><<<grid, 32 * WARPS, 0, s>>>(
        a.x, a.e, a.row_ptr, a.col, static_cast<float*>(a.out), a.rowsum,
        a.n, a.c, a.h);
  else if (a.round_term)
    weighted_segment_sum_bf16_kernel<HB, VEC, G, true>
        <<<grid, 32 * WARPS, 0, s>>>(a.x, a.e, a.row_ptr, a.col, a.out,
                                     a.rowsum, a.n, a.c, a.h, a.lanes,
                                     a.out_bf16);
  else
    weighted_segment_sum_bf16_kernel<HB, VEC, G, false>
        <<<grid, 32 * WARPS, 0, s>>>(a.x, a.e, a.row_ptr, a.col, a.out,
                                     a.rowsum, a.n, a.c, a.h, a.lanes,
                                     a.out_bf16);
}

template <typename X, int HB, int VEC>
void launch_groups(const Args<X>& a, dim3 grid, int groups, cudaStream_t s) {
  switch (groups) {
    case 1: launch_rows<X, HB, VEC, 1>(a, grid, s); break;
    case 2: launch_rows<X, HB, VEC, 2>(a, grid, s); break;
    case 3: launch_rows<X, HB, VEC, 3>(a, grid, s); break;
    case 4: launch_rows<X, HB, VEC, 4>(a, grid, s); break;
    default:
      if constexpr (std::is_same<X, float>::value)
        launch_rows<X, HB, VEC, MAX_GROUPS>(a, grid, s);
      else
        launch_rows<X, HB, VEC, MAX_GROUPS_BF16>(a, grid, s);
      break;
  }
}

template <typename X, int HB>
void launch(const Args<X>& a, dim3 grid, int vec, int groups, cudaStream_t s) {
  if (vec == 4) launch_groups<X, HB, 4>(a, grid, groups, s);
  else launch_groups<X, HB, 1>(a, grid, groups, s);
}

// Heads are taken MAX_HEADS at a time; when h is not a multiple of
// MAX_HEADS the last group is launched on its own.  out_size: the bytes of
// an element of out (4, or 2 for a bf16 out).
template <typename X>
int segment_sum(Args<X> a, int vec, int out_size, void* stream) {
  const int n = a.n, c = a.c, h = a.h;
  if (n <= 0 || c <= 0 || h < 1 || (vec != 1 && vec != 4) || c % vec)
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = std::is_same<X, float>::value ? plan_for(c, h, vec)
                                               : plan_bf16(c, h, vec);
  if (p.chunks > 65535 || p.full > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  a.lanes = p.lanes;
  const int rows_a_block = WARPS * 32 / p.lanes;
  const unsigned rows = (n + rows_a_block - 1) / rows_a_block;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.full > 0)
    launch<X, MAX_HEADS>(a, dim3(rows, p.chunks, p.full), vec, p.groups, s);
  if (p.tail > 0) {
    // the tail group's blockIdx.z is 0: offset the head index instead
    const int off = p.full * MAX_HEADS;
    Args<X> t = a;
    t.e += off;
    t.out = static_cast<char*>(a.out) + (size_t)off * c * out_size;
    if (a.rowsum != nullptr) t.rowsum += off;
    const dim3 grid(rows, p.chunks, 1);
    switch (p.tail) {
      case 1: launch<X, 1>(t, grid, vec, p.groups, s); break;
      case 2: launch<X, 2>(t, grid, vec, p.groups, s); break;
      default: launch<X, 3>(t, grid, vec, p.groups, s); break;
    }
  }
  return static_cast<int>(cudaGetLastError());
}

int plan_out(const Plan& p, int* out) {
  out[0] = p.groups;
  out[1] = p.chunks;
  out[2] = p.full;
  out[3] = p.tail;
  out[4] = p.lanes;
  return 0;
}

}  // namespace

extern "C" {

const char* snag_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The plan weighted_segment_sum launches for (c, h, vec): out[0..4] =
// slices a lane (G), column chunks, full head groups, heads of the tail
// group, lanes a row.
int weighted_segment_sum_plan(int c, int h, int vec, int* out) {
  if (c <= 0 || h < 1 || (vec != 1 && vec != 4) || c % vec)
    return static_cast<int>(cudaErrorInvalidValue);
  return plan_out(plan_for(c, h, vec), out);
}

// The same for weighted_segment_sum_bf16.
int weighted_segment_sum_bf16_plan(int c, int h, int vec, int* out) {
  if (c <= 0 || h < 1 || (vec != 1 && vec != 4) || c % vec)
    return static_cast<int>(cudaErrorInvalidValue);
  return plan_out(plan_bf16(c, h, vec), out);
}

// x (n, c), e (row_ptr[n], h), row_ptr (n+1), col (row_ptr[n]) on the
// device; agg (n, h, c) and rowsum (n, h) are written in full.  vec is 4
// when c % 4 == 0 and x is 16-byte aligned, else 1.
int weighted_segment_sum(const float* x, const float* e, const int* row_ptr,
                         const int* col, float* agg, float* rowsum, int n,
                         int c, int h, int vec, void* stream) {
  return segment_sum<float>({x, e, row_ptr, col, agg, rowsum, n, c, h, 32,
                             false, false}, vec, 4, stream);
}

// The same on bf16 x and e; vec is 4 when c % 4 == 0 and x is 8-byte
// aligned, else 1.  round_term != 0 rounds each edge's term e x to bf16
// before it is added.  out is agg (n, h, c) in fp32 and rowsum (n, h) is
// written, or, with out_bf16 != 0 (round_term only), out is agg rounded
// once to bf16 and rowsum is not read (null).
int weighted_segment_sum_bf16(const __nv_bfloat16* x, const __nv_bfloat16* e,
                              const int* row_ptr, const int* col, void* out,
                              float* rowsum, int n, int c, int h, int vec,
                              int round_term, int out_bf16, void* stream) {
  if (out_bf16 ? (!round_term || rowsum != nullptr) : rowsum == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return segment_sum<__nv_bfloat16>(
      {x, e, row_ptr, col, out, rowsum, n, c, h, 32, round_term != 0,
       out_bf16 != 0},
      vec, out_bf16 ? 2 : 4, stream);
}

}  // extern "C"
