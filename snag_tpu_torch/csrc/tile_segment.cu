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
// weighted_segment_sum_bf16: the same walk on bf16 x and e (the JAX GCN
// under --dtype bfloat16, snag_tpu/ops/gnn.py:43-50), with the Pallas
// kernel's arithmetic (tile_segment.py:209-234): the one-hot times a bf16
// e is e itself, the MXU forms each product e x of two bf16 values exactly
// in fp32 and adds the products in fp32, and rowsum is an fp32 sum of the
// bf16 e; agg and rowsum are fp32.  A bf16 e times a bf16 x is exact in
// fp32, so the fmaf chain is that sum.  A lane's slice is 4 bf16, one
// 8-byte load, as in gat_attention.cu.  ROUND_TERM rounds each edge's term
// e x to bf16 before the fp32 add: the GCN backward's reverse-edge launch,
// where JAX rounds every edge's e g to bf16 (snag_tpu/ops/gat_agg.py:104)
// before its column reduction adds them in fp32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int MAX_HEADS = 4;    // heads a launch group
constexpr int MAX_GROUPS = 4;   // slices a lane in one column chunk
constexpr int WARPS = 4;        // rows a block
constexpr unsigned FULL = 0xffffffffu;

// x rounded to bf16 and back: the JAX package's astype(bfloat16)
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// acc + e v: one fmaf, or with ROUND_TERM the product rounded to bf16
// first (exact in fp32 for bf16 e and v) and then added
template <bool ROUND_TERM>
__device__ __forceinline__ void add_term(float& acc, float e, float v) {
  if constexpr (ROUND_TERM) acc = __fadd_rn(acc, round_bf16(__fmul_rn(e, v)));
  else acc = fmaf(e, v, acc);
}

template <int VEC> struct Vec;
template <> struct Vec<1> {
  using T = float;
  template <bool ROUND_TERM>
  __device__ static void fma(float& acc, float e, float v) {
    add_term<ROUND_TERM>(acc, e, v);
  }
};
template <> struct Vec<4> {
  using T = float4;
  template <bool ROUND_TERM>
  __device__ static void fma(float4& acc, float e, float4 v) {
    add_term<ROUND_TERM>(acc.x, e, v.x);
    add_term<ROUND_TERM>(acc.y, e, v.y);
    add_term<ROUND_TERM>(acc.z, e, v.z);
    add_term<ROUND_TERM>(acc.w, e, v.w);
  }
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Slice s of a row of x as fp32: VEC floats, or VEC bf16 (their bits
// shifted into fp32's high half, which is exact).
template <int VEC>
__device__ __forceinline__ typename Vec<VEC>::T load_slice(const float* row,
                                                           int s) {
  return reinterpret_cast<const typename Vec<VEC>::T*>(row)[s];
}

template <int VEC>
__device__ __forceinline__ typename Vec<VEC>::T load_slice(
    const __nv_bfloat16* row, int s) {
  if constexpr (VEC == 4) {
    const uint2 u = reinterpret_cast<const uint2*>(row)[s];
    return make_float4(__uint_as_float(u.x << 16),
                       __uint_as_float(u.x & 0xffff0000u),
                       __uint_as_float(u.y << 16),
                       __uint_as_float(u.y & 0xffff0000u));
  } else {
    return __bfloat162float(row[s]);
  }
}

// The launch plan of weighted_segment_sum (ops/cuda/tile_segment.py's
// launch_plan computes the same): c / vec slices in 32-lane groups, cut
// into the fewest column chunks of at most MAX_GROUPS groups, the groups
// shared out evenly; heads in groups of MAX_HEADS, the last HB < MAX_HEADS
// launched on its own.
struct Plan {
  int groups, chunks, full, tail;
};

Plan plan_for(int c, int h, int vec) {
  const int lane_groups = (c / vec + 31) / 32;
  const int chunks = (lane_groups + MAX_GROUPS - 1) / MAX_GROUPS;
  return {(lane_groups + chunks - 1) / chunks, chunks, h / MAX_HEADS,
          h % MAX_HEADS};
}

// Heads h0 .. h0+HB-1 (h0 = blockIdx.z * MAX_HEADS) of rows
// blockIdx.x * WARPS + warp, slices blockIdx.y * 32 G + lane + 32 g: the
// body of both kernels; X is the type of x and e.
template <typename X, bool ROUND_TERM, int HB, int VEC, int G>
__device__ __forceinline__ void segment_rows(
    const X* __restrict__ x, const X* __restrict__ e,
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
        e_l[q] = to_float(e[(size_t)(base + lane) * h + h0 + q]);
    }

    for (int k = 0; k < m; ++k) {  // the same k for every lane
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

template <int HB, int VEC, int G>
__global__ void __launch_bounds__(32 * WARPS)
weighted_segment_sum_kernel(const float* __restrict__ x,
                            const float* __restrict__ e,
                            const int* __restrict__ row_ptr,
                            const int* __restrict__ col,
                            float* __restrict__ agg,
                            float* __restrict__ rowsum, int n, int c, int h) {
  segment_rows<float, false, HB, VEC, G>(x, e, row_ptr, col, agg, rowsum, n,
                                         c, h);
}

// named apart so that a profile tells the two apart
template <int HB, int VEC, int G, bool ROUND_TERM>
__global__ void __launch_bounds__(32 * WARPS)
weighted_segment_sum_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                                 const __nv_bfloat16* __restrict__ e,
                                 const int* __restrict__ row_ptr,
                                 const int* __restrict__ col,
                                 float* __restrict__ agg,
                                 float* __restrict__ rowsum, int n, int c,
                                 int h) {
  segment_rows<__nv_bfloat16, ROUND_TERM, HB, VEC, G>(x, e, row_ptr, col,
                                                      agg, rowsum, n, c, h);
}

template <typename X>
struct Args {
  const X *x, *e;
  const int *row_ptr, *col;
  float *agg, *rowsum;
  int n, c, h;
};

template <typename X, bool ROUND_TERM, int HB, int VEC, int G>
void launch_rows(const Args<X>& a, dim3 grid, cudaStream_t s) {
  if constexpr (std::is_same<X, float>::value)
    weighted_segment_sum_kernel<HB, VEC, G><<<grid, 32 * WARPS, 0, s>>>(
        a.x, a.e, a.row_ptr, a.col, a.agg, a.rowsum, a.n, a.c, a.h);
  else
    weighted_segment_sum_bf16_kernel<HB, VEC, G, ROUND_TERM>
        <<<grid, 32 * WARPS, 0, s>>>(a.x, a.e, a.row_ptr, a.col, a.agg,
                                     a.rowsum, a.n, a.c, a.h);
}

template <typename X, bool ROUND_TERM, int HB, int VEC>
void launch_groups(const Args<X>& a, dim3 grid, int groups, cudaStream_t s) {
  switch (groups) {
    case 1: launch_rows<X, ROUND_TERM, HB, VEC, 1>(a, grid, s); break;
    case 2: launch_rows<X, ROUND_TERM, HB, VEC, 2>(a, grid, s); break;
    case 3: launch_rows<X, ROUND_TERM, HB, VEC, 3>(a, grid, s); break;
    default: launch_rows<X, ROUND_TERM, HB, VEC, MAX_GROUPS>(a, grid, s); break;
  }
}

template <typename X, bool ROUND_TERM, int HB>
void launch(const Args<X>& a, dim3 grid, int vec, int groups, cudaStream_t s) {
  if (vec == 4) launch_groups<X, ROUND_TERM, HB, 4>(a, grid, groups, s);
  else launch_groups<X, ROUND_TERM, HB, 1>(a, grid, groups, s);
}

// Heads are taken MAX_HEADS at a time; when h is not a multiple of
// MAX_HEADS the last group is launched on its own.
template <typename X, bool ROUND_TERM>
int segment_sum(const X* x, const X* e, const int* row_ptr, const int* col,
                float* agg, float* rowsum, int n, int c, int h, int vec,
                void* stream) {
  if (n <= 0 || c <= 0 || h < 1 || (vec != 1 && vec != 4) || c % vec)
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = plan_for(c, h, vec);
  if (p.chunks > 65535 || p.full > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned rows = (n + WARPS - 1) / WARPS;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.full > 0)
    launch<X, ROUND_TERM, MAX_HEADS>({x, e, row_ptr, col, agg, rowsum, n, c, h},
                                     dim3(rows, p.chunks, p.full), vec,
                                     p.groups, s);
  if (p.tail > 0) {
    // the tail group's blockIdx.z is 0: offset the head index instead
    const int off = p.full * MAX_HEADS;
    const Args<X> a{x, e + off, row_ptr, col, agg + (size_t)off * c,
                    rowsum + off, n, c, h};
    const dim3 grid(rows, p.chunks, 1);
    switch (p.tail) {
      case 1: launch<X, ROUND_TERM, 1>(a, grid, vec, p.groups, s); break;
      case 2: launch<X, ROUND_TERM, 2>(a, grid, vec, p.groups, s); break;
      default: launch<X, ROUND_TERM, 3>(a, grid, vec, p.groups, s); break;
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* snag_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The plan weighted_segment_sum launches for (c, h, vec): out[0..3] =
// slices a lane (G), column chunks, full head groups, heads of the tail
// group.
int weighted_segment_sum_plan(int c, int h, int vec, int* out) {
  if (c <= 0 || h < 1 || (vec != 1 && vec != 4) || c % vec)
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = plan_for(c, h, vec);
  out[0] = p.groups;
  out[1] = p.chunks;
  out[2] = p.full;
  out[3] = p.tail;
  return 0;
}

// x (n, c), e (row_ptr[n], h), row_ptr (n+1), col (row_ptr[n]) on the
// device; agg (n, h, c) and rowsum (n, h) are written in full.  vec is 4
// when c % 4 == 0 and x is 16-byte aligned, else 1.
int weighted_segment_sum(const float* x, const float* e, const int* row_ptr,
                         const int* col, float* agg, float* rowsum, int n,
                         int c, int h, int vec, void* stream) {
  return segment_sum<float, false>(x, e, row_ptr, col, agg, rowsum, n, c, h,
                                   vec, stream);
}

// The same on bf16 x and e (agg and rowsum fp32); vec is 4 when c % 4 == 0
// and x is 8-byte aligned, else 1.  round_term != 0 rounds each edge's
// term e x to bf16 before it is added.
int weighted_segment_sum_bf16(const __nv_bfloat16* x, const __nv_bfloat16* e,
                              const int* row_ptr, const int* col, float* agg,
                              float* rowsum, int n, int c, int h, int vec,
                              int round_term, void* stream) {
  return round_term
             ? segment_sum<__nv_bfloat16, true>(x, e, row_ptr, col, agg,
                                                rowsum, n, c, h, vec, stream)
             : segment_sum<__nv_bfloat16, false>(x, e, row_ptr, col, agg,
                                                 rowsum, n, c, h, vec, stream);
}

}  // extern "C"
