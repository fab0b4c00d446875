// Sparse-GAT layer forward (diag mode) for Hopper, f32.
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

#include <cuda_runtime.h>

namespace {

constexpr int MAX_HEADS = 4;
constexpr int MAX_GROUPS = 10;   // c / vec <= 320
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

template <int H, int VEC, int G>
__global__ void __launch_bounds__(32 * WARPS)
gat_attention_fwd_kernel(const float* __restrict__ x,
                         const float* __restrict__ s_src,
                         const float* __restrict__ s_dst,
                         const int* __restrict__ row_ptr,
                         const int* __restrict__ col,
                         float* __restrict__ agg,
                         float* __restrict__ rowsum, int n, int c) {
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
      for (int h = 0; h < H; ++h) e_l[h] = s_dst[(size_t)j_l * H + h];
    }

    for (int q = 0; q < m; ++q) {  // the same q for every lane
      const int j = __shfl_sync(FULL, j_l, q);
      const V* row = reinterpret_cast<const V*>(x + (size_t)j * c);
      V v[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int s = lane + 32 * g;
        v[g] = s < nv ? row[s] : V{};
      }
      if (q == 0) {  // with the first x row in flight: the edge weights
#pragma unroll
        for (int h = 0; h < H; ++h) e_l[h] = edge_weight(src[h] + e_l[h]);
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

struct Args {
  const float *x, *s_src, *s_dst;
  const int *row_ptr, *col;
  float *agg, *rowsum;
  int n, c;
};

template <int H, int VEC, int G>
void launch_rows(const Args& a, cudaStream_t stream) {
  gat_attention_fwd_kernel<H, VEC, G><<<(a.n + WARPS - 1) / WARPS, 32 * WARPS, 0, stream>>>(
      a.x, a.s_src, a.s_dst, a.row_ptr, a.col, a.agg, a.rowsum, a.n, a.c);
}

template <int H, int VEC>
void launch_groups(const Args& a, int groups, cudaStream_t stream) {
  if (groups <= 1) launch_rows<H, VEC, 1>(a, stream);
  else if (groups <= 2) launch_rows<H, VEC, 2>(a, stream);
  else if (groups <= 3) launch_rows<H, VEC, 3>(a, stream);
  else if (groups <= 5) launch_rows<H, VEC, 5>(a, stream);
  else launch_rows<H, VEC, MAX_GROUPS>(a, stream);
}

template <int H>
void launch(const Args& a, int vec, int groups, cudaStream_t stream) {
  if (vec == 4) launch_groups<H, 4>(a, groups, stream);
  else launch_groups<H, 1>(a, groups, stream);
}

}  // namespace

extern "C" {

const char* snag_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x (n, c), s_src/s_dst (n, h), row_ptr (n+1), col (row_ptr[n]) on the
// device; agg (n, h, c) and rowsum (n, h) are written in full.  vec is 4
// when c % 4 == 0 and x and agg are 16-byte aligned, else 1; c / vec <= 320.
int gat_attention_fwd(const float* x, const float* s_src, const float* s_dst,
                      const int* row_ptr, const int* col, float* agg,
                      float* rowsum, int n, int c, int h, int vec,
                      void* stream) {
  if (n <= 0 || c <= 0 || h < 1 || h > MAX_HEADS || (vec != 1 && vec != 4) ||
      c % vec || c / vec > 32 * MAX_GROUPS)
    return static_cast<int>(cudaErrorInvalidValue);
  const int groups = (c / vec + 31) / 32;
  const Args a{x, s_src, s_dst, row_ptr, col, agg, rowsum, n, c};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (h) {
    case 1: launch<1>(a, vec, groups, s); break;
    case 2: launch<2>(a, vec, groups, s); break;
    case 3: launch<3>(a, vec, groups, s); break;
    default: launch<4>(a, vec, groups, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
