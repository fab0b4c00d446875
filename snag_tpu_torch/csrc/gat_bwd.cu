// Sparse-GAT layer backward (diag mode) for Hopper, f32.
//
// Replaces snag_tpu/ops/pallas/gat_bwd.py::fused_gat_backward_row (per-edge
// math edgewise_bwd).  Given the cotangents G (n, h, c) of agg and r (n, h)
// of rowsum from gat_attention.cu, every edge i <- j contributes
//     e        = exp(-leakyrelu_0.2(s_src[i] + s_dst[j]))
//     d_e      = <x[j], G[i, h]> + r[i, h]
//     d_score  = -d_e * e * leaky'(s_src[i] + s_dst[j])
//     d_x[j]     += sum_h e_h * G[i, h]
//     d_s_dst[j] += d_score
//     d_s_src[i] += d_score
//
// The edge multiset is symmetric (an undirected graph with self-loops; the
// wrapper refuses a graph without that flag), so node j's in-edges are its
// CSR out-edges (j, k) read backwards.  One block per CSR row j therefore
// produces all three outputs of j with no atomics and a fixed edge order:
//   reverse edge (row k, col j): score = s_src[k] + s_dst[j], gathering
//       G[k] and r[k]  ->  d_x[j], d_s_dst[j];
//   forward edge (row j, col k): score = s_src[j] + s_dst[k], gathering
//       x[k] and s_dst[k]  ->  d_s_src[j].
// e is recomputed, never stored.
//
// What bounds it on the H100: the gathered bytes.  Each edge reads one G row
// (h*c floats) and one x row (c floats): (h+1)*c*4 bytes, 1.19 GB per layer
// at the slice geometry (E = 329,862, c = 300, h = 2), mostly from L2.
// What the design does about it: like the forward, nothing per-edge is
// materialised; every thread owns a float4 slice of the c features, keeps
// x[j] and G[j] in registers, and accumulates d_x[j] in registers.  The two
// per-edge dot products per head are reduced across the block with warp
// shuffles into shared memory, and one thread per edge turns them into
// d_score.  The TPU kernel's one-hot dots, packed [G | r | s_src] tables and
// spill tails are not needed here.

#include <cuda_runtime.h>

namespace {

constexpr int EDGE_CHUNK = 32;
constexpr int MAX_HEADS = 4;
constexpr int MAX_WARPS = 32;

__device__ __forceinline__ float edge_weight(float score) {
  const float lr = score > 0.f ? score : 0.2f * score;
  return expf(-lr);
}

__device__ __forceinline__ float leaky_grad(float score) {
  return score > 0.f ? 1.f : 0.2f;
}

template <int VEC> struct Vec;
template <> struct Vec<1> {
  using T = float;
  __device__ static void fma(float& acc, float e, float v) { acc = fmaf(e, v, acc); }
  __device__ static float dot(float a, float b) { return a * b; }
};
template <> struct Vec<4> {
  using T = float4;
  __device__ static void fma(float4& acc, float e, float4 v) {
    acc.x = fmaf(e, v.x, acc.x);
    acc.y = fmaf(e, v.y, acc.y);
    acc.z = fmaf(e, v.z, acc.z);
    acc.w = fmaf(e, v.w, acc.w);
  }
  __device__ static float dot(float4 a, float4 b) {
    return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, a.x * b.x)));
  }
};

template <int H, int VEC>
__global__ void gat_bwd_kernel(const float* __restrict__ x,
                               const float* __restrict__ s_src,
                               const float* __restrict__ s_dst,
                               const float* __restrict__ g_agg,
                               const float* __restrict__ g_rs,
                               const int* __restrict__ row_ptr,
                               const int* __restrict__ col,
                               float* __restrict__ d_x,
                               float* __restrict__ d_s_src,
                               float* __restrict__ d_s_dst, int c) {
  using V = typename Vec<VEC>::T;
  __shared__ int sh_col[EDGE_CHUNK];
  __shared__ float sh_erev[EDGE_CHUNK * H];
  __shared__ float sh_part[MAX_WARPS][EDGE_CHUNK][2 * H];
  __shared__ float sh_dscore[EDGE_CHUNK][2 * H];

  const int j = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int n_warps = blockDim.x >> 5;
  const int nv = c / VEC;
  const bool owns_slice = t < nv;
  const int beg = row_ptr[j];
  const int end = row_ptr[j + 1];

  float src_j[H], dst_j[H], r_j[H];
#pragma unroll
  for (int h = 0; h < H; ++h) {
    src_j[h] = s_src[(size_t)j * H + h];
    dst_j[h] = s_dst[(size_t)j * H + h];
    r_j[h] = g_rs[(size_t)j * H + h];
  }
  V xj{}, gj[H], acc{};
#pragma unroll
  for (int h = 0; h < H; ++h) gj[h] = V{};
  if (owns_slice) {
    xj = reinterpret_cast<const V*>(x + (size_t)j * c)[t];
#pragma unroll
    for (int h = 0; h < H; ++h)
      gj[h] = reinterpret_cast<const V*>(g_agg + ((size_t)j * H + h) * c)[t];
  }
  float sum_dst[H], sum_src[H];
#pragma unroll
  for (int h = 0; h < H; ++h) sum_dst[h] = sum_src[h] = 0.f;

  for (int base = beg; base < end; base += EDGE_CHUNK) {
    const int m = min(EDGE_CHUNK, end - base);
    __syncthreads();  // the previous chunk is fully consumed
    if (t < m) {
      const int k = col[base + t];
      sh_col[t] = k;
#pragma unroll
      for (int h = 0; h < H; ++h)
        sh_erev[t * H + h] = edge_weight(s_src[(size_t)k * H + h] + dst_j[h]);
    }
    __syncthreads();

    // per edge: d_x accumulation, and the block-wide dot products
    // <x[j], G[k, h]> (reverse edge) and <x[k], G[j, h]> (forward edge)
    for (int q = 0; q < m; ++q) {
      const int k = sh_col[q];
      float part[2 * H];
#pragma unroll
      for (int p = 0; p < 2 * H; ++p) part[p] = 0.f;
      if (owns_slice) {
        const V xk = reinterpret_cast<const V*>(x + (size_t)k * c)[t];
#pragma unroll
        for (int h = 0; h < H; ++h) {
          const V gk = reinterpret_cast<const V*>(g_agg + ((size_t)k * H + h) * c)[t];
          Vec<VEC>::fma(acc, sh_erev[q * H + h], gk);
          part[h] = Vec<VEC>::dot(xj, gk);
          part[H + h] = Vec<VEC>::dot(xk, gj[h]);
        }
      }
#pragma unroll
      for (int p = 0; p < 2 * H; ++p) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          part[p] += __shfl_xor_sync(0xffffffffu, part[p], off);
      }
      if (lane == 0) {
#pragma unroll
        for (int p = 0; p < 2 * H; ++p) sh_part[warp][q][p] = part[p];
      }
    }
    __syncthreads();

    if (t < m) {
      const int k = sh_col[t];
#pragma unroll
      for (int h = 0; h < H; ++h) {
        float dot_rev = 0.f, dot_fwd = 0.f;
        for (int w = 0; w < n_warps; ++w) {
          dot_rev += sh_part[w][t][h];
          dot_fwd += sh_part[w][t][H + h];
        }
        const float score_rev = s_src[(size_t)k * H + h] + dst_j[h];
        const float d_e_rev = dot_rev + g_rs[(size_t)k * H + h];
        sh_dscore[t][h] = -d_e_rev * sh_erev[t * H + h] * leaky_grad(score_rev);
        const float score_fwd = src_j[h] + s_dst[(size_t)k * H + h];
        const float d_e_fwd = dot_fwd + r_j[h];
        sh_dscore[t][H + h] = -d_e_fwd * edge_weight(score_fwd) * leaky_grad(score_fwd);
      }
    }
    __syncthreads();
    if (t == 0) {
      for (int q = 0; q < m; ++q) {
#pragma unroll
        for (int h = 0; h < H; ++h) {
          sum_dst[h] += sh_dscore[q][h];
          sum_src[h] += sh_dscore[q][H + h];
        }
      }
    }
  }

  if (owns_slice) reinterpret_cast<V*>(d_x + (size_t)j * c)[t] = acc;
  if (t == 0) {
#pragma unroll
    for (int h = 0; h < H; ++h) {
      d_s_dst[(size_t)j * H + h] = sum_dst[h];
      d_s_src[(size_t)j * H + h] = sum_src[h];
    }
  }
}

template <int H>
void launch(const float* x, const float* s_src, const float* s_dst,
            const float* g_agg, const float* g_rs, const int* row_ptr,
            const int* col, float* d_x, float* d_s_src, float* d_s_dst, int n,
            int c, int vec, int threads, cudaStream_t stream) {
  if (vec == 4)
    gat_bwd_kernel<H, 4><<<n, threads, 0, stream>>>(
        x, s_src, s_dst, g_agg, g_rs, row_ptr, col, d_x, d_s_src, d_s_dst, c);
  else
    gat_bwd_kernel<H, 1><<<n, threads, 0, stream>>>(
        x, s_src, s_dst, g_agg, g_rs, row_ptr, col, d_x, d_s_src, d_s_dst, c);
}

}  // namespace

extern "C" {

const char* snag_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x (n, c), s_src/s_dst (n, h), g_agg (n, h, c), g_rs (n, h), row_ptr (n+1),
// col (row_ptr[n]) on the device, the CSR multiset symmetric; d_x (n, c),
// d_s_src and d_s_dst (n, h) are written in full.  vec is 4 when c % 4 == 0
// and x, g_agg, d_x are 16-byte aligned, else 1.
int gat_bwd(const float* x, const float* s_src, const float* s_dst,
            const float* g_agg, const float* g_rs, const int* row_ptr,
            const int* col, float* d_x, float* d_s_src, float* d_s_dst, int n,
            int c, int h, int vec, void* stream) {
  if (n <= 0 || c <= 0 || h < 1 || h > MAX_HEADS || (vec != 1 && vec != 4) ||
      c % vec)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nv = c / vec;
  const int threads = (((nv > EDGE_CHUNK ? nv : EDGE_CHUNK) + 31) / 32) * 32;
  if (threads > 32 * MAX_WARPS) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (h) {
    case 1: launch<1>(x, s_src, s_dst, g_agg, g_rs, row_ptr, col, d_x, d_s_src, d_s_dst, n, c, vec, threads, s); break;
    case 2: launch<2>(x, s_src, s_dst, g_agg, g_rs, row_ptr, col, d_x, d_s_src, d_s_dst, n, c, vec, threads, s); break;
    case 3: launch<3>(x, s_src, s_dst, g_agg, g_rs, row_ptr, col, d_x, d_s_src, d_s_dst, n, c, vec, threads, s); break;
    default: launch<4>(x, s_src, s_dst, g_agg, g_rs, row_ptr, col, d_x, d_s_src, d_s_dst, n, c, vec, threads, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
