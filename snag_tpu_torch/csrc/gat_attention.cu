// Sparse-GAT layer forward (diag mode) for Hopper, f32 or bf16 x.
//
// Replaces snag_tpu/ops/pallas/gat_attention.py::fused_gat_attention.
// For every destination row i, head h and edge i <- j in row_ptr[i]..row_ptr[i+1]:
//     e_h        = exp(-leakyrelu_0.2(s_src[i,h] + s_dst[j,h]))
//     agg[i,h,:] = sum_j e_h * x[j,:]
//     rowsum[i,h] = sum_j e_h
//
// What bounds it on the H100: the gathered bytes.  Each edge reads one
// x row, so a layer moves E*C*4 bytes (E = 329,862 edges, C = 300 at the
// slice geometry: 0.40 GB) against ~2*H*C flops per edge; the N*C*4-byte x
// table (N = 30,000: 36 MB) fits in the 50 MB L2, so most of those reads
// hit L2.
//
// What the design does about it: the TPU kernel materialises the
// (E, c_pad) gather [x | s_dst | 1][col] and reduces it with one-hot MXU
// dots.  Here nothing is materialised, and a row costs no block barrier, no
// shared memory and no serial thread: one warp owns one destination row.
// The column ids and attention weights of up to 32 of its edges are
// computed one edge a lane, while the first x rows are in flight, and
// broadcast by shuffle; lane l owns the float4 slices l, l + 32, ... (G of
// them, a template parameter) of H register accumulators, and loads the x
// row of one edge at a time, so that registers stay few and an SM holds
// more warps.  x is read once per edge for all heads; agg is written
// once and streamed past L2.  There are no
// atomics and the edge order within a row is fixed, so the result is
// deterministic: agg is an fmaf chain over the edges in order from 0 and
// rowsum a sum in edge order from 0, the bits of the block-per-row kernel
// this one replaced.  A row of any length is walked by its one warp, 32 edges
// at a time.
//
// gat_attention_fwd_bf16: the same kernel on bf16 x (T = __nv_bfloat16),
// with the rounding points of the Pallas kernel on the JAX package's bf16
// path: s_src[i] and s_dst[j] are rounded to bf16 (gat_attention.py:135,
// gat_attn_primitive.py:85), and so is e, before both the aggregate and
// the rowsum (gat_attention.py:74); the sums run in fp32 (a bf16 e times a
// bf16 x is exact there) and agg and rowsum are fp32.  A lane's slice is 4
// bf16, one 8-byte load (C = 300 is not a multiple of 8), so the gathered
// bytes halve.
//
// Any head count and width (gat_attention_wide_rows): the kernels above
// hold MAX_HEADS heads and MAX_GROUPS slices a lane in registers, which
// covers H <= 4 and C <= 1,280 (C % 4 == 0) or 320, the main path's
// shapes.  Beyond them the same walk runs on a grid of (row blocks,
// column chunks of 32 WIDE_GROUPS slices, head groups of MAX_HEADS): each
// block takes its chunk's slices and its group's heads, recomputes its
// heads' weights, and writes its part of agg (and, in chunk 0, rowsum).
// Every element is still the fmaf chain over the row's edges in order
// from 0, so the outputs are the bits the kernels above would give; x is
// read once per (chunk, head group).  A last group of fewer heads is a
// launch of its own.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int MAX_HEADS = 4;
constexpr int MAX_GROUPS = 10;   // c / vec <= 320
constexpr int WIDE_GROUPS = 5;   // slices a lane in a column chunk, wide
constexpr int WARPS = 4;         // rows a block
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float edge_weight(float score) {
  const float lr = score > 0.f ? score : 0.2f * score;
  return expf(-lr);
}

template <int VEC> struct Vec;
template <> struct Vec<1> {
  using T = float;
  __device__ static void fma(float& acc, float e, float v) { acc = fmaf(e, v, acc); }
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

// x rounded to bf16 and back: the JAX package's astype(bfloat16)
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
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

// The body of both kernels; X is x's type.
template <typename X, int H, int VEC, int G>
__device__ __forceinline__ void gat_attention_rows(
    const X* __restrict__ x, const float* __restrict__ s_src,
    const float* __restrict__ s_dst, const int* __restrict__ row_ptr,
    const int* __restrict__ col, float* __restrict__ agg,
    float* __restrict__ rowsum, int n, int c) {
  constexpr bool BF16 = !std::is_same<X, float>::value;
  using V = typename Vec<VEC>::T;
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (i >= n) return;  // a tail warp; nothing below waits on a barrier
  const int nv = c / VEC;

  float src[H], rs[H];
  V acc[H][G];
#pragma unroll
  for (int h = 0; h < H; ++h) {
    src[h] = s_src[(size_t)i * H + h];
    if constexpr (BF16) src[h] = round_bf16(src[h]);
    rs[h] = 0.f;
#pragma unroll
    for (int g = 0; g < G; ++g) acc[h][g] = V{};
  }
  const int beg = row_ptr[i];
  const int end = row_ptr[i + 1];

  for (int base = beg; base < end; base += 32) {
    const int m = min(32, end - base);
    // edge base + lane: its column and weights
    int j_l = 0;
    float e_l[H];
#pragma unroll
    for (int h = 0; h < H; ++h) e_l[h] = 0.f;
    if (lane < m) {
      j_l = col[base + lane];
#pragma unroll
      for (int h = 0; h < H; ++h) {
        e_l[h] = s_dst[(size_t)j_l * H + h];
        if constexpr (BF16) e_l[h] = round_bf16(e_l[h]);
      }
    }

    for (int q = 0; q < m; ++q) {  // the same q for every lane
      const int j = __shfl_sync(FULL, j_l, q);
      const X* row = x + (size_t)j * c;
      V v[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int s = lane + 32 * g;
        v[g] = s < nv ? load_slice<VEC>(row, s) : V{};
      }
      if (q == 0) {  // with the first x row in flight: the edge weights
#pragma unroll
        for (int h = 0; h < H; ++h) {
          e_l[h] = edge_weight(src[h] + e_l[h]);
          if constexpr (BF16) e_l[h] = round_bf16(e_l[h]);
        }
      }
#pragma unroll
      for (int h = 0; h < H; ++h) {
        const float e = __shfl_sync(FULL, e_l[h], q);
#pragma unroll
        for (int g = 0; g < G; ++g) Vec<VEC>::fma(acc[h][g], e, v[g]);
        rs[h] += e;
      }
    }
  }

#pragma unroll
  for (int h = 0; h < H; ++h) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int s = lane + 32 * g;
      if (s < nv) __stcs(reinterpret_cast<V*>(agg + ((size_t)i * H + h) * c) + s, acc[h][g]);
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int h = 0; h < H; ++h) rowsum[(size_t)i * H + h] = rs[h];
  }
}

template <int H, int VEC, int G>
__global__ void __launch_bounds__(32 * WARPS)
gat_attention_fwd_kernel(const float* __restrict__ x,
                         const float* __restrict__ s_src,
                         const float* __restrict__ s_dst,
                         const int* __restrict__ row_ptr,
                         const int* __restrict__ col,
                         float* __restrict__ agg,
                         float* __restrict__ rowsum, int n, int c) {
  gat_attention_rows<float, H, VEC, G>(x, s_src, s_dst, row_ptr, col, agg,
                                       rowsum, n, c);
}

// named apart so that a profile tells the two apart
template <int H, int VEC, int G>
__global__ void __launch_bounds__(32 * WARPS)
gat_attention_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                              const float* __restrict__ s_src,
                              const float* __restrict__ s_dst,
                              const int* __restrict__ row_ptr,
                              const int* __restrict__ col,
                              float* __restrict__ agg,
                              float* __restrict__ rowsum, int n, int c) {
  gat_attention_rows<__nv_bfloat16, H, VEC, G>(x, s_src, s_dst, row_ptr, col,
                                               agg, rowsum, n, c);
}

// The body of the wide kernels: heads h0 .. h0+HB-1 (h0 = head0 +
// MAX_HEADS * blockIdx.z) of ht, and the slices of column chunk blockIdx.y
// (32 WIDE_GROUPS of them from s0) of row blockIdx.x * WARPS + warp, the
// weights and sums of gat_attention_rows.
template <typename X, int HB, int VEC>
__device__ __forceinline__ void gat_attention_wide_rows(
    const X* __restrict__ x, const float* __restrict__ s_src,
    const float* __restrict__ s_dst, const int* __restrict__ row_ptr,
    const int* __restrict__ col, float* __restrict__ agg,
    float* __restrict__ rowsum, int n, int c, int ht, int head0) {
  constexpr bool BF16 = !std::is_same<X, float>::value;
  constexpr int G = WIDE_GROUPS;
  using V = typename Vec<VEC>::T;
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (i >= n) return;  // a tail warp; nothing below waits on a barrier
  const int h0 = head0 + MAX_HEADS * blockIdx.z;
  const int s0 = blockIdx.y * 32 * G;
  const int nv = c / VEC - s0;  // the row's slices from s0 on

  float src[HB], rs[HB];
  V acc[HB][G];
#pragma unroll
  for (int h = 0; h < HB; ++h) {
    src[h] = s_src[(size_t)i * ht + h0 + h];
    if constexpr (BF16) src[h] = round_bf16(src[h]);
    rs[h] = 0.f;
#pragma unroll
    for (int g = 0; g < G; ++g) acc[h][g] = V{};
  }
  const int beg = row_ptr[i];
  const int end = row_ptr[i + 1];

  for (int base = beg; base < end; base += 32) {
    const int m = min(32, end - base);
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

    for (int q = 0; q < m; ++q) {  // the same q for every lane
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
  }

#pragma unroll
  for (int h = 0; h < HB; ++h) {
    V* out = reinterpret_cast<V*>(agg + ((size_t)i * ht + h0 + h) * c) + s0;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int s = lane + 32 * g;
      if (s < nv) __stcs(out + s, acc[h][g]);
    }
  }
  if (lane == 0 && blockIdx.y == 0) {
#pragma unroll
    for (int h = 0; h < HB; ++h) rowsum[(size_t)i * ht + h0 + h] = rs[h];
  }
}

template <int HB, int VEC>
__global__ void __launch_bounds__(32 * WARPS)
gat_attention_fwd_wide_kernel(const float* __restrict__ x,
                              const float* __restrict__ s_src,
                              const float* __restrict__ s_dst,
                              const int* __restrict__ row_ptr,
                              const int* __restrict__ col,
                              float* __restrict__ agg,
                              float* __restrict__ rowsum, int n, int c,
                              int ht, int head0) {
  gat_attention_wide_rows<float, HB, VEC>(x, s_src, s_dst, row_ptr, col, agg,
                                          rowsum, n, c, ht, head0);
}

template <int HB, int VEC>
__global__ void __launch_bounds__(32 * WARPS)
gat_attention_fwd_bf16_wide_kernel(const __nv_bfloat16* __restrict__ x,
                                   const float* __restrict__ s_src,
                                   const float* __restrict__ s_dst,
                                   const int* __restrict__ row_ptr,
                                   const int* __restrict__ col,
                                   float* __restrict__ agg,
                                   float* __restrict__ rowsum, int n, int c,
                                   int ht, int head0) {
  gat_attention_wide_rows<__nv_bfloat16, HB, VEC>(
      x, s_src, s_dst, row_ptr, col, agg, rowsum, n, c, ht, head0);
}

template <typename X>
struct Args {
  const X* x;
  const float *s_src, *s_dst;
  const int *row_ptr, *col;
  float *agg, *rowsum;
  int n, c;
};

template <typename X, int H, int VEC, int G>
void launch_rows(const Args<X>& a, cudaStream_t stream) {
  const int blocks = (a.n + WARPS - 1) / WARPS;
  if constexpr (std::is_same<X, float>::value)
    gat_attention_fwd_kernel<H, VEC, G><<<blocks, 32 * WARPS, 0, stream>>>(
        a.x, a.s_src, a.s_dst, a.row_ptr, a.col, a.agg, a.rowsum, a.n, a.c);
  else
    gat_attention_fwd_bf16_kernel<H, VEC, G><<<blocks, 32 * WARPS, 0, stream>>>(
        a.x, a.s_src, a.s_dst, a.row_ptr, a.col, a.agg, a.rowsum, a.n, a.c);
}

template <typename X, int H, int VEC>
void launch_groups(const Args<X>& a, int groups, cudaStream_t stream) {
  if (groups <= 1) launch_rows<X, H, VEC, 1>(a, stream);
  else if (groups <= 2) launch_rows<X, H, VEC, 2>(a, stream);
  else if (groups <= 3) launch_rows<X, H, VEC, 3>(a, stream);
  else if (groups <= 5) launch_rows<X, H, VEC, 5>(a, stream);
  else launch_rows<X, H, VEC, MAX_GROUPS>(a, stream);
}

template <typename X, int H>
void launch(const Args<X>& a, int vec, int groups, cudaStream_t stream) {
  if (vec == 4) launch_groups<X, H, 4>(a, groups, stream);
  else launch_groups<X, H, 1>(a, groups, stream);
}

// `heads` heads from head0 on, of h, over grid.z = groups of MAX_HEADS
// (HB = MAX_HEADS) or one group of the HB heads left.
template <typename X, int HB, int VEC>
void launch_wide_heads(const Args<X>& a, int h, int head0, int groups,
                       int chunks, cudaStream_t stream) {
  const dim3 grid((a.n + WARPS - 1) / WARPS, chunks, groups);
  if constexpr (std::is_same<X, float>::value)
    gat_attention_fwd_wide_kernel<HB, VEC><<<grid, 32 * WARPS, 0, stream>>>(
        a.x, a.s_src, a.s_dst, a.row_ptr, a.col, a.agg, a.rowsum, a.n, a.c,
        h, head0);
  else
    gat_attention_fwd_bf16_wide_kernel<HB, VEC><<<grid, 32 * WARPS, 0, stream>>>(
        a.x, a.s_src, a.s_dst, a.row_ptr, a.col, a.agg, a.rowsum, a.n, a.c,
        h, head0);
}

template <typename X, int VEC>
void launch_wide(const Args<X>& a, int h, cudaStream_t stream) {
  const int chunks = (a.c / VEC + 32 * WIDE_GROUPS - 1) / (32 * WIDE_GROUPS);
  const int full = h / MAX_HEADS;
  if (full > 0)
    launch_wide_heads<X, MAX_HEADS, VEC>(a, h, 0, full, chunks, stream);
  const int head0 = full * MAX_HEADS;
  switch (h % MAX_HEADS) {
    case 1: launch_wide_heads<X, 1, VEC>(a, h, head0, 1, chunks, stream); break;
    case 2: launch_wide_heads<X, 2, VEC>(a, h, head0, 1, chunks, stream); break;
    case 3: launch_wide_heads<X, 3, VEC>(a, h, head0, 1, chunks, stream); break;
    default: break;
  }
}

template <typename X>
int forward(const X* x, const float* s_src, const float* s_dst,
            const int* row_ptr, const int* col, float* agg, float* rowsum,
            int n, int c, int h, int vec, void* stream) {
  if (n <= 0 || c <= 0 || h < 1 || (vec != 1 && vec != 4) || c % vec)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args<X> a{x, s_src, s_dst, row_ptr, col, agg, rowsum, n, c};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (h > MAX_HEADS || c / vec > 32 * MAX_GROUPS) {
    if (vec == 4) launch_wide<X, 4>(a, h, s);
    else launch_wide<X, 1>(a, h, s);
    return static_cast<int>(cudaGetLastError());
  }
  const int groups = (c / vec + 31) / 32;
  switch (h) {
    case 1: launch<X, 1>(a, vec, groups, s); break;
    case 2: launch<X, 2>(a, vec, groups, s); break;
    case 3: launch<X, 3>(a, vec, groups, s); break;
    default: launch<X, 4>(a, vec, groups, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* snag_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x (n, c), s_src/s_dst (n, h), row_ptr (n+1), col (row_ptr[n]) on the
// device; agg (n, h, c) and rowsum (n, h) are written in full.  vec is 4
// when c % 4 == 0 and x and agg are 16-byte aligned, else 1.  h <= 4 with
// c / vec <= 320 runs gat_attention_rows, anything else the wide kernels.
int gat_attention_fwd(const float* x, const float* s_src, const float* s_dst,
                      const int* row_ptr, const int* col, float* agg,
                      float* rowsum, int n, int c, int h, int vec,
                      void* stream) {
  return forward(x, s_src, s_dst, row_ptr, col, agg, rowsum, n, c, h, vec,
                 stream);
}

// The same on bf16 x (s_src, s_dst, agg and rowsum fp32); vec is 4 when
// c % 4 == 0, x is 8-byte and agg 16-byte aligned, else 1.
int gat_attention_fwd_bf16(const __nv_bfloat16* x, const float* s_src,
                           const float* s_dst, const int* row_ptr,
                           const int* col, float* agg, float* rowsum, int n,
                           int c, int h, int vec, void* stream) {
  return forward(x, s_src, s_dst, row_ptr, col, agg, rowsum, n, c, h, vec,
                 stream);
}

}  // extern "C"
