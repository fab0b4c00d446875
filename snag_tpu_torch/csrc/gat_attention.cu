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
// slice geometry) against ~2*H*C flops per edge; the N*C*4-byte x table
// (N = 30,000) fits in the 50 MB L2, so most of those reads hit L2.
//
// What the design does about it: the TPU kernel materialises the
// (E, c_pad) gather [x | s_dst | 1][col] and reduces it with one-hot MXU
// dots.  Here nothing is materialised: one block owns one destination
// row, stages up to EDGE_CHUNK of its edges' column ids and attention
// weights in shared memory, and every thread gathers its own float4 slice
// of x[col] straight from L2 into H register accumulators.  x is read once
// per edge for all heads.  There are no atomics and the edge order within
// a row is fixed, so the result is deterministic.

#include <cuda_runtime.h>

namespace {

constexpr int EDGE_CHUNK = 64;
constexpr int MAX_HEADS = 4;

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

template <int H, int VEC>
__global__ void gat_attention_fwd_kernel(const float* __restrict__ x,
                                         const float* __restrict__ s_src,
                                         const float* __restrict__ s_dst,
                                         const int* __restrict__ row_ptr,
                                         const int* __restrict__ col,
                                         float* __restrict__ agg,
                                         float* __restrict__ rowsum,
                                         int c) {
  using V = typename Vec<VEC>::T;
  __shared__ int sh_col[EDGE_CHUNK];
  __shared__ float sh_e[EDGE_CHUNK * H];

  const int i = blockIdx.x;
  const int t = threadIdx.x;
  const int nv = c / VEC;
  const bool owns_slice = t < nv;
  const int beg = row_ptr[i];
  const int end = row_ptr[i + 1];

  float src[H];
#pragma unroll
  for (int h = 0; h < H; ++h) src[h] = s_src[(size_t)i * H + h];

  V acc[H];
  float rs[H];
#pragma unroll
  for (int h = 0; h < H; ++h) {
    acc[h] = V{};
    rs[h] = 0.f;
  }

  for (int base = beg; base < end; base += EDGE_CHUNK) {
    const int m = min(EDGE_CHUNK, end - base);
    __syncthreads();  // the previous chunk is fully consumed
    if (t < m) {
      const int j = col[base + t];
      sh_col[t] = j;
#pragma unroll
      for (int h = 0; h < H; ++h)
        sh_e[t * H + h] = edge_weight(src[h] + s_dst[(size_t)j * H + h]);
    }
    __syncthreads();
    if (owns_slice) {
      for (int q = 0; q < m; ++q) {
        const V v = reinterpret_cast<const V*>(x + (size_t)sh_col[q] * c)[t];
#pragma unroll
        for (int h = 0; h < H; ++h) Vec<VEC>::fma(acc[h], sh_e[q * H + h], v);
      }
    }
    if (t == 0) {
      for (int q = 0; q < m; ++q) {
#pragma unroll
        for (int h = 0; h < H; ++h) rs[h] += sh_e[q * H + h];
      }
    }
  }

  if (owns_slice) {
#pragma unroll
    for (int h = 0; h < H; ++h)
      reinterpret_cast<V*>(agg + ((size_t)i * H + h) * c)[t] = acc[h];
  }
  if (t == 0) {
#pragma unroll
    for (int h = 0; h < H; ++h) rowsum[(size_t)i * H + h] = rs[h];
  }
}

template <int H>
void launch(const float* x, const float* s_src, const float* s_dst,
            const int* row_ptr, const int* col, float* agg, float* rowsum,
            int n, int c, int vec, int threads, cudaStream_t stream) {
  if (vec == 4)
    gat_attention_fwd_kernel<H, 4><<<n, threads, 0, stream>>>(
        x, s_src, s_dst, row_ptr, col, agg, rowsum, c);
  else
    gat_attention_fwd_kernel<H, 1><<<n, threads, 0, stream>>>(
        x, s_src, s_dst, row_ptr, col, agg, rowsum, c);
}

}  // namespace

extern "C" {

const char* snag_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x (n, c), s_src/s_dst (n, h), row_ptr (n+1), col (row_ptr[n]) on the
// device; agg (n, h, c) and rowsum (n, h) are written in full.  vec is 4
// when c % 4 == 0 and x is 16-byte aligned, else 1.
int gat_attention_fwd(const float* x, const float* s_src, const float* s_dst,
                      const int* row_ptr, const int* col, float* agg,
                      float* rowsum, int n, int c, int h, int vec,
                      void* stream) {
  if (n <= 0 || c <= 0 || h < 1 || h > MAX_HEADS || (vec != 1 && vec != 4) ||
      c % vec)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nv = c / vec;
  const int threads = (((nv > EDGE_CHUNK ? nv : EDGE_CHUNK) + 31) / 32) * 32;
  if (threads > 1024) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (h) {
    case 1: launch<1>(x, s_src, s_dst, row_ptr, col, agg, rowsum, n, c, vec, threads, s); break;
    case 2: launch<2>(x, s_src, s_dst, row_ptr, col, agg, rowsum, n, c, vec, threads, s); break;
    case 3: launch<3>(x, s_src, s_dst, row_ptr, col, agg, rowsum, n, c, vec, threads, s); break;
    default: launch<4>(x, s_src, s_dst, row_ptr, col, agg, rowsum, n, c, vec, threads, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
