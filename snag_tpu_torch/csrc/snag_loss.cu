// SNAG's fused loss bundle for Hopper, f32: the row-logsumexp of M modality
// channels and two mixture channels from shared similarity tiles, and its
// gradient, neither of which writes a quadratic array.
//
// Replaces snag_tpu/ops/pallas/snag_loss_kernel.py::mixture_lse (kernel
// _mix_lse_kernel) and ::mixture_grad (kernel _mix_grad_kernel).  z is
// (M, n2 = 2B, d) with L2-normalised rows, K_m = z_m z_m^T, alpha (n2, M)
// and beta (M,) are unit vectors, v (n2,) marks valid rows, and the
// positive partner of row r is r + B or r - B.  Channels are
// [K_0 .. K_{M-1} | mix_a | mix_f] with
//     mix_a[r,c] = sum_m alpha[r,m] alpha[c,m] K_m[r,c]
//     mix_f[r,c] = sum_m beta[m] K_m[r,c]
// and S = channel / tau.  |S| <= 1/tau (unit rows; Cauchy-Schwarz for the
// mixtures), so the logsumexp takes the static max 1/tau:
//
//   mixture_lse:  lse[ch,r] = log(sum_{c != r} v[c] exp(S - 1/tau) + 1e-30)
//                             + 1/tau;
//   mixture_grad: with W_ch = ((c != r)(coef_r p_row v_c + p_col coef_c v_r)
//                 - [c == pos(r)](coef_r + coef_c)) / tau,
//                 p = exp(min(S - lse, 0)) (the G + G^T fold of the
//                 symmetric S, as in ntxent.cu):
//     dz_m[r]     = sum_c (W_m + W_a alpha[r,m] alpha[c,m] + W_f beta_m) z_m[c]
//     dalpha[r,m] = sum_c W_a alpha[c,m] K_m[r,c]
//     dbeta[m]    = 1/2 sum_{r,c} W_f K_m[r,c]  (the fold counts each pair
//                   twice for beta; alpha[r,m] sits in row r and column r
//                   of S, so dalpha needs no halving).
//
// mixture_lse: M tile products, 2 n2^2 d M flops (1.18e11 at M = 4,
// B = 3500, d = 300) plus the mixtures and M + 2 exps per element, in fp32
// SIMT tiles (tile_dot.cuh), because one TF32 product is far from the 1e-5
// lse tolerance.
//
// mixture_grad: what bounds it on the H100 is arithmetic, M products
// K_m = z_r z_c^T and M products W z per tile, 4 n2^2 d M flops (2.35e11
// at M = 4), taken on the tensor cores in 3xTF32 (tile_mma.cuh): mma.sync
// m16n8k8 on hi = rna_tf32(x) and lo = rna_tf32(x - hi) of each operand,
// a_lo b_hi + a_hi b_lo + a_hi b_hi in fp32, so the bound is the flops
// over 495 / 3 TFLOP/s.  One TF32 product is refused: K's error is
// multiplied by 1/tau = 10 before the exp.  max|err| / max|ref| of (dz,
// dalpha, dbeta) at tau = 0.1 with the two products emulated on the CPU
// and the rest in f64, against f64 (tests/test_torch_tf32x3.py::rel_errors):
//     (M, B, d)       fp32 products            3xTF32                   1xTF32
//     (4, 500, 300)   6.0e-6 2.2e-6 7.0e-8     7.0e-6 3.4e-6 8.2e-8     7.8e-4 4.1e-4 4.2e-5
//     (6, 300, 300)   8.9e-6 1.3e-6 5.9e-7     1.0e-5 1.7e-6 5.8e-7     1.2e-3 2.3e-4 1.1e-5
//     (4, 400, 48)    3.1e-6 6.7e-7 2.3e-8     2.9e-6 9.7e-7 2.2e-7     1.7e-3 4.0e-4 1.4e-4
// against a limit of 1e-4: 3xTF32 is as close as fp32 products, one TF32
// product misses dz by 8-17x.  The tensor cores also truncate when they
// accumulate, so each k8 step of K starts from zero and is added in fp32.
//
// The kernel is gram_grad.cuh's, instantiated with MIX = true (NT-Xent
// shares it with MIX = false): per (32 x 64) tile every K_m once into
// registers, the mixture weights W_a and W_f from them, then per modality
// of the block's group the combined weight, its dalpha and dbeta terms,
// and W z into the (modalities x 32 rows x d) shared accumulator, 152 KB at
// M = 4, d = 300, one block (8 warps) per SM.  Where the accumulator of
// every modality does not fit (M = 6 at d = 300), a block takes a group of
// modalities (blockIdx.y, chosen by the wrapper).  dbeta is summed per
// block, written as per-block partials and reduced in a fixed order: no
// atomics, two runs give the same bits.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "gram_grad.cuh"
#include "tile_dot.cuh"

namespace {

constexpr float LSE_EPS = 1e-30f;

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
mixture_lse_kernel(const float* __restrict__ z, const float* __restrict__ alpha,
                   const float* __restrict__ beta, const float* __restrict__ v,
                   float* __restrict__ lse, int nm, int n2, int d,
                   float inv_tau) {
  __shared__ __align__(16) Smem sm;
  // thread-private partial row sums of every channel
  __shared__ float sums[MAX_MOD + 2][TM][THREADS];
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int row0 = blockIdx.x * BM;

  for (int ch = 0; ch < nm + 2; ++ch)
#pragma unroll
    for (int r = 0; r < TM; ++r) sums[ch][r][tid] = 0.f;

  for (int col0 = 0; col0 < n2; col0 += BN) {
    float vc[TN];
    bool neq[TM][TN];
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      const int gc = col0 + tile_col(tx, c);
      vc[c] = gc < n2 ? v[gc] : 0.f;
#pragma unroll
      for (int r = 0; r < TM; ++r) neq[r][c] = gc != row0 + ty * TM + r;
    }
    float mix_a[TM][TN], mix_f[TM][TN];
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int c = 0; c < TN; ++c) mix_a[r][c] = mix_f[r][c] = 0.f;

    for (int m = 0; m < nm; ++m) {
      const float* zm = z + (size_t)m * n2 * d;
      float acc[TM][TN];
      tile_dot<VEC>(zm, zm, n2, d, row0, col0, sm, acc);
      const float bm = beta[m];
      float ar[TM], ac[TN], part[TM];
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        const int gr = row0 + ty * TM + r;
        ar[r] = gr < n2 ? alpha[(size_t)gr * nm + m] : 0.f;
        part[r] = 0.f;
      }
#pragma unroll
      for (int c = 0; c < TN; ++c) {
        const int gc = col0 + tile_col(tx, c);
        ac[c] = gc < n2 ? alpha[(size_t)gc * nm + m] : 0.f;
      }
#pragma unroll
      for (int c = 0; c < TN; ++c)
#pragma unroll
        for (int r = 0; r < TM; ++r) {
          const float k = acc[r][c];
          if (neq[r][c]) part[r] += expf(k * inv_tau - inv_tau) * vc[c];
          mix_a[r][c] = fmaf(ar[r] * ac[c], k, mix_a[r][c]);
          mix_f[r][c] = fmaf(bm, k, mix_f[r][c]);
        }
#pragma unroll
      for (int r = 0; r < TM; ++r) sums[m][r][tid] += part[r];
    }

    float pa[TM], pf[TM];
#pragma unroll
    for (int r = 0; r < TM; ++r) pa[r] = pf[r] = 0.f;
#pragma unroll
    for (int c = 0; c < TN; ++c)
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        if (!neq[r][c]) continue;
        pa[r] += expf(mix_a[r][c] * inv_tau - inv_tau) * vc[c];
        pf[r] += expf(mix_f[r][c] * inv_tau - inv_tau) * vc[c];
      }
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      sums[nm][r][tid] += pa[r];
      sums[nm + 1][r][tid] += pf[r];
    }
  }

  // merge the row's TX partial sums (lanes of one half-warp)
  for (int ch = 0; ch < nm + 2; ++ch) {
    float s[TM];
#pragma unroll
    for (int r = 0; r < TM; ++r) s[r] = sums[ch][r][tid];
#pragma unroll
    for (int off = TX / 2; off >= 1; off >>= 1) {
#pragma unroll
      for (int r = 0; r < TM; ++r) s[r] += __shfl_xor_sync(0xffffffffu, s[r], off);
    }
    if (tx == 0) {
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        const int gr = row0 + ty * TM + r;
        if (gr < n2) lse[(size_t)ch * n2 + gr] = logf(s[r] + LSE_EPS) + inv_tau;
      }
    }
  }
}

// ------------------------------------------------------------- mixture_grad
// The kernel is grad::mixture_grad_kernel of gram_grad.cuh.

// dbeta[m] = 1/2 sum_b part[b, m], in a fixed order: one block per m.
__global__ void __launch_bounds__(REDUCE_THREADS)
mixture_dbeta_kernel(const float* __restrict__ part, float* __restrict__ dbeta,
                     int n_blocks, int nm) {
  __shared__ float red[REDUCE_THREADS];
  const int m = blockIdx.x;
  float s = 0.f;
  for (int b = threadIdx.x; b < n_blocks; b += REDUCE_THREADS)
    s += part[(size_t)b * nm + m];
  red[threadIdx.x] = s;
  __syncthreads();
  for (int off = REDUCE_THREADS / 2; off > 0; off >>= 1) {
    if (threadIdx.x < off) red[threadIdx.x] += red[threadIdx.x + off];
    __syncthreads();
  }
  if (threadIdx.x == 0) dbeta[m] = 0.5f * red[0];
}

// out[i] += part[0][i] + part[1][i] + ..., in that order.
__global__ void __launch_bounds__(REDUCE_THREADS)
mixture_sum_kernel(float* __restrict__ out, const float* __restrict__ part,
                   size_t n, int parts) {
  add_partials(out, part, n, parts);
}

bool vec_ok(const float* z, int d) {
  return d % 4 == 0 && reinterpret_cast<uintptr_t>(z) % 16 == 0;
}

int check_shape(int m, int n2, int d) {
  return (m <= 0 || m > MAX_MOD || n2 <= 0 || n2 % 2 || d <= 0)
             ? static_cast<int>(cudaErrorInvalidValue)
             : 0;
}

}  // namespace

extern "C" {

const char* snag_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// z (m, n2, d) unit rows, alpha (n2, m), beta (m,), v (n2,) 0/1 column
// validity; writes lse (m + 2, n2) in full.
int mixture_lse(const float* z, const float* alpha, const float* beta,
                const float* v, float* lse, int m, int n2, int d,
                float inv_tau, void* stream) {
  if (check_shape(m, n2, d)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n2 + BM - 1) / BM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec_ok(z, d))
    mixture_lse_kernel<true><<<grid, THREADS, 0, s>>>(z, alpha, beta, v, lse, m, n2, d, inv_tau);
  else
    mixture_lse_kernel<false><<<grid, THREADS, 0, s>>>(z, alpha, beta, v, lse, m, n2, d, inv_tau);
  return static_cast<int>(cudaGetLastError());
}

// Once per device, before the first mixture_grad on it: lets the gradient
// kernel take all the shared memory a block may opt in to, and returns the
// largest (modalities per block) x (d rounded up to a multiple of 8) its
// row accumulator then holds, or a negative CUDA error.
int mixture_grad_init(void) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(grad::mixture_grad_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(grad::mixture_grad_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err != cudaSuccess) return -static_cast<int>(err);
  const long room = (long)optin - (long)grad::smem_bytes(grad::MIN_DEPTH, 0, 0);
  return room > 0 ? 8 * static_cast<int>(room / (sizeof(float) * grad::TILE_FLOATS)) : 0;
}

// The floats of scratch that mixture_grad needs at this shape (per-block
// dbeta partials, and the dalpha and dz partials of the column splits past
// the first), or a negative CUDA error.  Call after mixture_grad_init.
long mixture_grad_scratch(int m, int mg, int n2, int d) {
  if (check_shape(m, n2, d) || mg < 1 || mg > m)
    return -static_cast<long>(cudaErrorInvalidValue);
  GradPlan plan;
  const int err = grad_plan<true>(
      reinterpret_cast<const void*>(grad::mixture_grad_kernel<true>), m, mg,
      n2, d, plan);
  return err ? -static_cast<long>(err) : static_cast<long>(plan.scratch);
}

// z, alpha, beta, v as for mixture_lse; lse and coef (m + 2, n2); writes
// dz (m, n2, d), dalpha (n2, m) and dbeta (m,) in full, using part
// (mixture_grad_scratch floats) as scratch.  Each block handles mg
// modalities; mg x d rounded up to a multiple of 8 must not exceed what
// mixture_grad_init returned for this device.
int mixture_grad(const float* z, const float* alpha, const float* beta,
                 const float* lse, const float* coef, const float* v,
                 float* dz, float* dalpha, float* dbeta, float* part,
                 int m, int mg, int n2, int d, float inv_tau, void* stream) {
  if (check_shape(m, n2, d) || mg < 1 || mg > m)
    return static_cast<int>(cudaErrorInvalidValue);
  GradPlan plan;
  int err = grad_plan<true>(
      reinterpret_cast<const void*>(grad::mixture_grad_kernel<true>), m, mg,
      n2, d, plan);
  if (err) return err;
  const int nb = (n2 + grad::ROWS - 1) / grad::ROWS;
  const dim3 grid(nb, (m + mg - 1) / mg, plan.splits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec_ok(z, d))
    grad::mixture_grad_kernel<true><<<grid, grad::THREADS, plan.bytes, s>>>(
        z, alpha, beta, lse, coef, v, dz, dalpha, part, m, mg, n2, d, inv_tau,
        plan.depth);
  else
    grad::mixture_grad_kernel<false><<<grid, grad::THREADS, plan.bytes, s>>>(
        z, alpha, beta, lse, coef, v, dz, dalpha, part, m, mg, n2, d, inv_tau,
        plan.depth);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  if (plan.splits > 1) {
    const size_t parts = (size_t)plan.splits * nb * m;
    const size_t n_da = (size_t)n2 * m, n_dz = (size_t)m * n2 * d;
    mixture_sum_kernel<<<1024, REDUCE_THREADS, 0, s>>>(
        dalpha, part + parts, n_da, plan.splits - 1);
    mixture_sum_kernel<<<1024, REDUCE_THREADS, 0, s>>>(
        dz, part + parts + (plan.splits - 1) * n_da, n_dz, plan.splits - 1);
  }
  mixture_dbeta_kernel<<<m, REDUCE_THREADS, 0, s>>>(part, dbeta,
                                                    plan.splits * nb, m);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
