// Streaming batched NT-Xent for Hopper, f32: the row-logsumexp of the
// virtual similarity matrix and its gradient, neither of which writes a
// quadratic array.
//
// Replaces snag_tpu/ops/pallas/ntxent_kernel.py::streaming_lse (kernel
// _lse_kernel) and ::streaming_ntxent_grad (kernel _grad_kernel).  For each
// of M batches, z = [zis ; zjs] is (n2 = 2B, d) with L2-normalised rows,
// S = z z^T / tau, v (n2,) marks valid rows, and the positive partner of
// row r is r + B or r - B:
//
//   ntxent_lse:  lse[r] = log(sum_{c != r} v[c] exp(S[r,c] - 1/tau) + 1e-30)
//                         + 1/tau
//     (static max: |S| <= 1/tau for unit rows; only columns are masked, an
//     invalid row gets a finite value that its zero coefficient removes);
//   ntxent_grad: dz[r] = sum_c W[r,c] z[c] with
//     W = ((c != r) (coef_r p_row v_c + p_col coef_c v_r)
//          - [c == pos(r)] (coef_r + coef_c)) / tau,
//     p_row = exp(min(S - lse_r, 0)), p_col = exp(min(S - lse_c, 0)):
//     the row and column passes of the symmetric S folded into one visit.
//
// What bounds it on the H100: arithmetic.  The forward is 2 n2^2 d flops per
// batch, the gradient twice that (S recomputed, then W z); at the slice
// shapes (M, B, d) in {(4, 3500, 300), (2, 3500, 1200)} a training step's
// three losses come to ~1.4e12 flops, against O(n2 d) bytes per block read
// from L2.
//
// ntxent_lse: TF32 keeps 10 mantissa bits, far from the 1e-5 lse
// tolerance, so it is a plain fp32 SIMT tile product (tile_dot.cuh, shared
// with rank_eval.cu): each block owns BM rows of one batch and walks every
// column tile, the S tile lives in a TM x TN register tile per thread.
//
// ntxent_grad: the shared 3xTF32 tensor-core gradient of gram_grad.cuh
// with MIX = false, the mixture gradient without its mixtures.  One TF32
// product misses the 1e-4 dz limit 4-16x, 3xTF32 holds it as fp32 products
// do (tests/test_torch_tf32x3.py).  A block owns 32 rows of one batch and
// one feature chunk: its accumulator (32 rows x the chunk's features, 38 KB
// at d = 300) and a four-slot ring take 107 KB, so two blocks share an SM
// and one block's loads run under the other's products.  d takes any
// value: where the accumulator of all of d does not fit beside the
// shallowest ring (d > 1,504 on the H100), blockIdx.y also walks balanced
// feature chunks, each recomputing S over the whole d.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "gram_grad.cuh"
#include "tile_dot.cuh"

namespace {

constexpr float LSE_EPS = 1e-30f;

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
ntxent_lse_kernel(const float* __restrict__ z, const float* __restrict__ v,
                  float* __restrict__ lse, int n2, int d, float inv_tau) {
  __shared__ __align__(16) Smem sm;
  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
  const int row0 = blockIdx.x * BM;
  const float* zm = z + (size_t)blockIdx.y * n2 * d;

  float sum[TM];
#pragma unroll
  for (int r = 0; r < TM; ++r) sum[r] = 0.f;

  for (int col0 = 0; col0 < n2; col0 += BN) {
    float acc[TM][TN];
    tile_dot<VEC>(zm, zm, n2, d, row0, col0, sm, acc);
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      const int gc = col0 + tile_col(tx, c);
      if (gc >= n2) continue;
      const float vc = v[gc];
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        const int gr = row0 + ty * TM + r;
        if (gc != gr) sum[r] += expf(acc[r][c] * inv_tau - inv_tau) * vc;
      }
    }
  }

  // merge the row's TX partial sums (lanes of one half-warp)
#pragma unroll
  for (int off = TX / 2; off >= 1; off >>= 1) {
#pragma unroll
    for (int r = 0; r < TM; ++r)
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], off);
  }
  if (tx == 0) {
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const int gr = row0 + ty * TM + r;
      if (gr < n2)
        lse[(size_t)blockIdx.y * n2 + gr] = logf(sum[r] + LSE_EPS) + inv_tau;
    }
  }
}

// out[i] += part[0][i] + part[1][i] + ..., in that order: the dz partials
// of the gradient's column splits.
__global__ void __launch_bounds__(REDUCE_THREADS)
ntxent_grad_sum_kernel(float* __restrict__ out, const float* __restrict__ part,
                       size_t n, int parts) {
  add_partials(out, part, n, parts);
}

// Lets the gradient kernel take all the shared memory a block may opt in
// to on the current device, then plans a launch (gram_grad.cuh).
int ntxent_plan(int m, int n2, int d, GradPlan& plan) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(grad::ntxent_grad_mma_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(grad::ntxent_grad_mma_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err != cudaSuccess) return static_cast<int>(err);
  return grad_plan<false>(
      reinterpret_cast<const void*>(grad::ntxent_grad_mma_kernel<true>), m, 1,
      n2, d, plan);
}

bool vec_ok(const float* z, int d) {
  return d % 4 == 0 && reinterpret_cast<uintptr_t>(z) % 16 == 0;
}

int check_shape(int m, int n2, int d) {
  return (m <= 0 || n2 <= 0 || n2 % 2 || d <= 0 || m > 65535)
             ? static_cast<int>(cudaErrorInvalidValue)
             : 0;
}

}  // namespace

extern "C" {

const char* snag_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// z (m, n2, d) with unit rows, v (n2,) 0/1 column validity; writes lse
// (m, n2) in full.
int ntxent_lse(const float* z, const float* v, float* lse, int m, int n2,
               int d, float inv_tau, void* stream) {
  if (check_shape(m, n2, d)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n2 + BM - 1) / BM, m);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec_ok(z, d))
    ntxent_lse_kernel<true><<<grid, THREADS, 0, s>>>(z, v, lse, n2, d, inv_tau);
  else
    ntxent_lse_kernel<false><<<grid, THREADS, 0, s>>>(z, v, lse, n2, d, inv_tau);
  return static_cast<int>(cudaGetLastError());
}

// How ntxent_grad runs at this shape on the current device: returns the
// floats of scratch it needs (the dz partials of the column splits past the
// first), or a negative CUDA error; if out is not null, writes {feature
// chunks, ring depth, column splits, blocks per SM} to it.
long ntxent_grad_plan(int m, int n2, int d, int* out) {
  if (check_shape(m, n2, d)) return -static_cast<long>(cudaErrorInvalidValue);
  GradPlan plan;
  const int err = ntxent_plan(m, n2, d, plan);
  if (err) return -static_cast<long>(err);
  if (out) {
    out[0] = plan.chunks;
    out[1] = plan.depth;
    out[2] = plan.splits;
    out[3] = plan.per_sm;
  }
  return static_cast<long>(plan.scratch);
}

// z (m, n2, d), lse and coef (m, n2), v (n2,); writes dz (m, n2, d) in
// full, using part (ntxent_grad_plan floats) as scratch.
int ntxent_grad(const float* z, const float* lse, const float* coef,
                const float* v, float* dz, float* part, int m, int n2, int d,
                float inv_tau, void* stream) {
  if (check_shape(m, n2, d)) return static_cast<int>(cudaErrorInvalidValue);
  GradPlan plan;
  int err = ntxent_plan(m, n2, d, plan);
  if (err) return err;
  const dim3 grid((n2 + grad::ROWS - 1) / grad::ROWS, m * plan.chunks,
                  plan.splits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec_ok(z, d))
    grad::ntxent_grad_mma_kernel<true><<<grid, grad::THREADS, plan.bytes, s>>>(
        z, lse, coef, v, dz, part, m, plan.chunks, n2, d, inv_tau, plan.depth);
  else
    grad::ntxent_grad_mma_kernel<false><<<grid, grad::THREADS, plan.bytes, s>>>(
        z, lse, coef, v, dz, part, m, plan.chunks, n2, d, inv_tau, plan.depth);
  err = static_cast<int>(cudaGetLastError());
  if (err || plan.splits == 1) return err;
  ntxent_grad_sum_kernel<<<1024, REDUCE_THREADS, 0, s>>>(
      dz, part, (size_t)m * n2 * d, plan.splits - 1);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
