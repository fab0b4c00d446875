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
// from L2.  TF32 keeps 10 mantissa bits, far from the 1e-5 lse tolerance,
// so this first version is a plain fp32 SIMT tile product (tile_dot.cuh,
// shared with rank_eval.cu): each block owns BM rows of one batch and walks every
// column tile, the S tile lives in a TM x TN register tile per thread.
//
// The gradient's row accumulator is BM x d.  At d = 1200 that is 38,400
// floats per block, too many for registers, so it lives in shared memory
// (153.6 KB at BM = 32; the kernel takes up to ~1500 columns): for each
// column tile the block computes S and W (W staged in shared memory), then
// streams z[cols] in 16 x 128 slices and adds W z into the shared
// accumulator, each element owned by one thread (tile_wz, tile_dot.cuh).  The alternative, a grid
// over d-chunks, would recompute S once per chunk (4x the S work at
// d = 1200 with 300-wide chunks).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

size_t grad_smem_bytes(int d) {
  return sizeof(Smem) + W_BYTES + sizeof(float) * BM * (size_t)d;
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
ntxent_grad_kernel(const float* __restrict__ z, const float* __restrict__ lse,
                   const float* __restrict__ coef,
                   const float* __restrict__ v, float* __restrict__ dz,
                   int n2, int d, float inv_tau) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  float(*ws)[BN + PAD] =
      reinterpret_cast<float(*)[BN + PAD]>(smem_raw + sizeof(Smem));
  float* accs = reinterpret_cast<float*>(smem_raw + sizeof(Smem) + W_BYTES);

  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
  const int row0 = blockIdx.x * BM;
  const int half = n2 / 2;
  const size_t mo = (size_t)blockIdx.y * n2;
  const float* zm = z + mo * d;

  for (int i = threadIdx.x; i < BM * d; i += THREADS) accs[i] = 0.f;

  int gr[TM], pos[TM];
  float lse_r[TM], coef_r[TM], v_r[TM];
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    gr[r] = row0 + ty * TM + r;
    const bool ok = gr[r] < n2;
    pos[r] = gr[r] < half ? gr[r] + half : gr[r] - half;
    lse_r[r] = ok ? lse[mo + gr[r]] : 0.f;
    coef_r[r] = ok ? coef[mo + gr[r]] : 0.f;
    v_r[r] = ok ? v[gr[r]] : 0.f;
  }

  for (int col0 = 0; col0 < n2; col0 += BN) {
    float acc[TM][TN];
    tile_dot<VEC>(zm, zm, n2, d, row0, col0, sm, acc);

    // W tile into shared memory (zero outside the matrix)
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      const int lc = tile_col(tx, c);
      const int gc = col0 + lc;
      const bool okc = gc < n2;
      const float lse_c = okc ? lse[mo + gc] : 0.f;
      const float coef_c = okc ? coef[mo + gc] : 0.f;
      const float v_c = okc ? v[gc] : 0.f;
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        float w = 0.f;
        if (okc && gr[r] < n2) {
          const float s = acc[r][c] * inv_tau;
          const float p_row = expf(fminf(s - lse_r[r], 0.f));
          const float p_col = expf(fminf(s - lse_c, 0.f));
          if (gc != gr[r]) w = coef_r[r] * p_row * v_c + p_col * coef_c * v_r[r];
          if (gc == pos[r]) w -= coef_r[r] + coef_c;
          w *= inv_tau;
        }
        ws[ty * TM + r][lc] = w;
      }
    }
    __syncthreads();

    // accs[rows, :] += W (BM x BN) @ z[col0 : col0 + BN, :]
    tile_wz(ws, zm, n2, d, col0, sm, accs);
    // the next tile_dot writes sm only after its own loads, and every
    // thread passed the last barrier above after its final read of sm and
    // ws; accs entries are thread-private until the write-out barrier
  }
  __syncthreads();

  for (int i = threadIdx.x; i < BM * d; i += THREADS) {
    const int r = row0 + i / d;
    if (r < n2) dz[(mo + r) * d + i % d] = accs[i];
  }
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

// Once per device, before the first ntxent_grad on it: lets the gradient
// kernel take all the shared memory a block may opt in to, and returns the
// largest d its shared-memory row accumulator then holds, or a negative
// CUDA error.
int ntxent_grad_init(void) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ntxent_grad_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ntxent_grad_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err != cudaSuccess) return -static_cast<int>(err);
  const long room = (long)optin - (long)(sizeof(Smem) + W_BYTES);
  return room > 0 ? static_cast<int>(room / (sizeof(float) * BM)) : 0;
}

// z (m, n2, d), lse and coef (m, n2), v (n2,); writes dz (m, n2, d) in full.
// d must not exceed what ntxent_grad_init returned for this device.
int ntxent_grad(const float* z, const float* lse, const float* coef,
                const float* v, float* dz, int m, int n2, int d,
                float inv_tau, void* stream) {
  if (check_shape(m, n2, d)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = grad_smem_bytes(d);
  const dim3 grid((n2 + BM - 1) / BM, m);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec_ok(z, d))
    ntxent_grad_kernel<true><<<grid, THREADS, bytes, s>>>(z, lse, coef, v, dz, n2, d, inv_tau);
  else
    ntxent_grad_kernel<false><<<grid, THREADS, bytes, s>>>(z, lse, coef, v, dz, n2, d, inv_tau);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
