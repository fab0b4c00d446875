// Weighted segment sum over the CSR rows of a graph, for Hopper, f32.
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
// dots per row tile.  Here nothing is materialised: one block owns one
// row and up to MAX_HEADS heads (blockIdx.y walks the head groups), stages
// EDGE_CHUNK of the row's column ids and weights in shared memory, and
// every thread gathers its float4 slice of x[col] from L2 into register
// accumulators.  No atomics, and the edges of a row are summed in CSR
// order, so the result is deterministic.  This is the structure of
// gat_attention.cu without the score and the exp.

#include <cuda_runtime.h>

namespace {

constexpr int EDGE_CHUNK = 64;
constexpr int MAX_HEADS = 4;   // heads per block; more go to blockIdx.y

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

// Heads h0 .. h0+HB-1 of row blockIdx.x, h0 = blockIdx.y * MAX_HEADS.
template <int HB, int VEC>
__global__ void weighted_segment_sum_kernel(const float* __restrict__ x,
                                            const float* __restrict__ e,
                                            const int* __restrict__ row_ptr,
                                            const int* __restrict__ col,
                                            float* __restrict__ agg,
                                            float* __restrict__ rowsum,
                                            int c, int h) {
  using V = typename Vec<VEC>::T;
  __shared__ int sh_col[EDGE_CHUNK];
  __shared__ float sh_e[EDGE_CHUNK * HB];

  const int i = blockIdx.x;
  const int h0 = blockIdx.y * MAX_HEADS;
  const int t = threadIdx.x;
  const int nv = c / VEC;
  const bool owns_slice = t < nv;
  const int beg = row_ptr[i];
  const int end = row_ptr[i + 1];

  V acc[HB];
  float rs[HB];
#pragma unroll
  for (int q = 0; q < HB; ++q) {
    acc[q] = V{};
    rs[q] = 0.f;
  }

  for (int base = beg; base < end; base += EDGE_CHUNK) {
    const int m = min(EDGE_CHUNK, end - base);
    __syncthreads();  // the previous chunk is fully consumed
    if (t < m) {
      sh_col[t] = col[base + t];
#pragma unroll
      for (int q = 0; q < HB; ++q)
        sh_e[t * HB + q] = e[(size_t)(base + t) * h + h0 + q];
    }
    __syncthreads();
    if (owns_slice) {
      for (int k = 0; k < m; ++k) {
        const V v = reinterpret_cast<const V*>(x + (size_t)sh_col[k] * c)[t];
#pragma unroll
        for (int q = 0; q < HB; ++q) Vec<VEC>::fma(acc[q], sh_e[k * HB + q], v);
      }
    }
    if (t == 0) {
      for (int k = 0; k < m; ++k) {
#pragma unroll
        for (int q = 0; q < HB; ++q) rs[q] += sh_e[k * HB + q];
      }
    }
  }

  if (owns_slice) {
#pragma unroll
    for (int q = 0; q < HB; ++q)
      reinterpret_cast<V*>(agg + ((size_t)i * h + h0 + q) * c)[t] = acc[q];
  }
  if (t == 0) {
#pragma unroll
    for (int q = 0; q < HB; ++q) rowsum[(size_t)i * h + h0 + q] = rs[q];
  }
}

template <int HB>
void launch(const float* x, const float* e, const int* row_ptr, const int* col,
            float* agg, float* rowsum, dim3 grid, int c, int h, int vec,
            int threads, cudaStream_t s) {
  if (vec == 4)
    weighted_segment_sum_kernel<HB, 4><<<grid, threads, 0, s>>>(
        x, e, row_ptr, col, agg, rowsum, c, h);
  else
    weighted_segment_sum_kernel<HB, 1><<<grid, threads, 0, s>>>(
        x, e, row_ptr, col, agg, rowsum, c, h);
}

}  // namespace

extern "C" {

const char* snag_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x (n, c), e (row_ptr[n], h), row_ptr (n+1), col (row_ptr[n]) on the
// device; agg (n, h, c) and rowsum (n, h) are written in full.  vec is 4
// when c % 4 == 0 and x is 16-byte aligned, else 1.  Heads are taken
// MAX_HEADS at a time; when h is not a multiple of MAX_HEADS the last
// group is launched on its own.
int weighted_segment_sum(const float* x, const float* e, const int* row_ptr,
                         const int* col, float* agg, float* rowsum, int n,
                         int c, int h, int vec, void* stream) {
  if (n <= 0 || c <= 0 || h < 1 || (vec != 1 && vec != 4) || c % vec ||
      h / MAX_HEADS > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nv = c / vec;
  const int threads = (((nv > EDGE_CHUNK ? nv : EDGE_CHUNK) + 31) / 32) * 32;
  if (threads > 1024) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int full = h / MAX_HEADS;
  if (full > 0)
    launch<MAX_HEADS>(x, e, row_ptr, col, agg, rowsum, dim3(n, full), c, h,
                      vec, threads, s);
  const int tail = h % MAX_HEADS;
  if (tail > 0) {
    // the tail group's blockIdx.y is 0: offset the head index instead
    const int off = full * MAX_HEADS;
    const float* et = e + off;
    float* at = agg + (size_t)off * c;
    float* rt = rowsum + off;
    const dim3 grid(n, 1);
    switch (tail) {
      case 1: launch<1>(x, et, row_ptr, col, at, rt, grid, c, h, vec, threads, s); break;
      case 2: launch<2>(x, et, row_ptr, col, at, rt, grid, c, h, vec, threads, s); break;
      default: launch<3>(x, et, row_ptr, col, at, rt, grid, c, h, vec, threads, s); break;
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
