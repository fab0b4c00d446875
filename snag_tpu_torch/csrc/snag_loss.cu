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
// What bounds it on the H100: arithmetic.  mixture_lse is M tile products,
// 2 n2^2 d M flops (1.18e11 at M = 4, B = 3500, d = 300); the mixtures and
// the M + 2 exps per element are a few per cent on top.  mixture_grad needs
// K_m twice (the mixture weights W_a and W_f depend on every modality,
// and W_m on its own) and W z once: it recomputes K_m rather than keep M
// (32 x 128) tiles in shared memory beside the row accumulator, 3 x the
// forward's flops where 2 x is the least.  fp32 SIMT tiles (tile_dot.cuh),
// because TF32 is far from the 1e-5 lse tolerance.
//
// The gradient's row accumulator is (modalities x 32 rows x d) in shared
// memory (153.6 KB at M = 4, d = 300).  A block handles a group of mg
// modalities (blockIdx.y), mg chosen by the wrapper from what the shared
// memory holds: at M = 6, d = 300 two groups of 3, each recomputing the
// mixtures.  dbeta is summed per block, written as per-block partials and
// reduced by a second kernel in a fixed order: no atomics, two runs give
// the same bits.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tile_dot.cuh"

namespace {

constexpr float LSE_EPS = 1e-30f;
constexpr int MAX_MOD = 6;
constexpr int REDUCE_THREADS = 256;

__device__ __forceinline__ float w_channel(float s, float lse_r, float lse_c,
                                           float coef_r, float coef_c,
                                           float v_r, float v_c, bool neq,
                                           bool onehot, float inv_tau) {
  const float p_row = expf(fminf(s - lse_r, 0.f));
  const float p_col = expf(fminf(s - lse_c, 0.f));
  float w = neq ? coef_r * p_row * v_c + p_col * coef_c * v_r : 0.f;
  if (onehot) w -= coef_r + coef_c;
  return w * inv_tau;
}

// The mixture channels of one (BM x BN) tile: all M tile products.
template <bool VEC>
__device__ __forceinline__ void mixtures(const float* __restrict__ z,
                                         const float* __restrict__ alpha,
                                         const float* __restrict__ beta,
                                         int nm, int n2, int d, int row0,
                                         int col0, Smem& sm,
                                         float (&mix_a)[TM][TN],
                                         float (&mix_f)[TM][TN]) {
  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int c = 0; c < TN; ++c) mix_a[r][c] = mix_f[r][c] = 0.f;
  for (int m = 0; m < nm; ++m) {
    const float* zm = z + (size_t)m * n2 * d;
    float acc[TM][TN];
    tile_dot<VEC>(zm, zm, n2, d, row0, col0, sm, acc);
    const float bm = beta[m];
    float ar[TM], ac[TN];
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const int gr = row0 + ty * TM + r;
      ar[r] = gr < n2 ? alpha[(size_t)gr * nm + m] : 0.f;
    }
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      const int gc = col0 + tile_col(tx, c);
      ac[c] = gc < n2 ? alpha[(size_t)gc * nm + m] : 0.f;
    }
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int c = 0; c < TN; ++c) {
        mix_a[r][c] = fmaf(ar[r] * ac[c], acc[r][c], mix_a[r][c]);
        mix_f[r][c] = fmaf(bm, acc[r][c], mix_f[r][c]);
      }
  }
}

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

// Shared memory of the gradient kernel beside the accumulator: the tile
// product's stages, the W tile, per-thread dbeta partials and the block's
// dalpha rows.
constexpr size_t GRAD_FIXED_BYTES =
    sizeof(Smem) + W_BYTES + sizeof(float) * MAX_MOD * (THREADS + BM);

size_t grad_smem_bytes(int mg, int d) {
  return GRAD_FIXED_BYTES + sizeof(float) * (size_t)mg * BM * d;
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
mixture_grad_kernel(const float* __restrict__ z, const float* __restrict__ alpha,
                    const float* __restrict__ beta, const float* __restrict__ lse,
                    const float* __restrict__ coef, const float* __restrict__ v,
                    float* __restrict__ dz, float* __restrict__ dalpha,
                    float* __restrict__ dbeta_part, int nm, int mg, int n2,
                    int d, float inv_tau) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  float(*ws)[BN + PAD] =
      reinterpret_cast<float(*)[BN + PAD]>(smem_raw + sizeof(Smem));
  float* db_sm = reinterpret_cast<float*>(smem_raw + sizeof(Smem) + W_BYTES);
  float* da_sm = db_sm + MAX_MOD * THREADS;
  float* accs = da_sm + MAX_MOD * BM;

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int row0 = blockIdx.x * BM;
  const int half = n2 / 2;
  const int m0 = blockIdx.y * mg;
  const int nmy = min(mg, nm - m0);

  for (int i = tid; i < nmy * BM * d; i += THREADS) accs[i] = 0.f;
  for (int i = tid; i < nmy * BM; i += THREADS) da_sm[i] = 0.f;
  for (int i = 0; i < nmy; ++i) db_sm[i * THREADS + tid] = 0.f;
  __syncthreads();

  int gr[TM], pos[TM];
  float v_r[TM], la_r[TM], lf_r[TM], ca_r[TM], cf_r[TM];
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    gr[r] = row0 + ty * TM + r;
    const bool ok = gr[r] < n2;
    pos[r] = gr[r] < half ? gr[r] + half : gr[r] - half;
    v_r[r] = ok ? v[gr[r]] : 0.f;
    la_r[r] = ok ? lse[(size_t)nm * n2 + gr[r]] : 0.f;
    lf_r[r] = ok ? lse[(size_t)(nm + 1) * n2 + gr[r]] : 0.f;
    ca_r[r] = ok ? coef[(size_t)nm * n2 + gr[r]] : 0.f;
    cf_r[r] = ok ? coef[(size_t)(nm + 1) * n2 + gr[r]] : 0.f;
  }

  for (int col0 = 0; col0 < n2; col0 += BN) {
    // pass 1: the two mixture weights of the tile, in registers
    float w_a[TM][TN], w_f[TM][TN];
    mixtures<VEC>(z, alpha, beta, nm, n2, d, row0, col0, sm, w_a, w_f);
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      const int gc = col0 + tile_col(tx, c);
      const bool okc = gc < n2;
      const float v_c = okc ? v[gc] : 0.f;
      const float la_c = okc ? lse[(size_t)nm * n2 + gc] : 0.f;
      const float lf_c = okc ? lse[(size_t)(nm + 1) * n2 + gc] : 0.f;
      const float ca_c = okc ? coef[(size_t)nm * n2 + gc] : 0.f;
      const float cf_c = okc ? coef[(size_t)(nm + 1) * n2 + gc] : 0.f;
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        const bool ok = okc && gr[r] < n2;
        const bool neq = gc != gr[r], oh = gc == pos[r];
        w_a[r][c] = ok ? w_channel(w_a[r][c] * inv_tau, la_r[r], la_c, ca_r[r],
                                   ca_c, v_r[r], v_c, neq, oh, inv_tau)
                       : 0.f;
        w_f[r][c] = ok ? w_channel(w_f[r][c] * inv_tau, lf_r[r], lf_c, cf_r[r],
                                   cf_c, v_r[r], v_c, neq, oh, inv_tau)
                       : 0.f;
      }
    }

    // pass 2: this block's modalities
    for (int mi = 0; mi < nmy; ++mi) {
      const int m = m0 + mi;
      const float* zm = z + (size_t)m * n2 * d;
      float acc[TM][TN];
      tile_dot<VEC>(zm, zm, n2, d, row0, col0, sm, acc);
      const float bm = beta[m];
      float ar[TM], lm_r[TM], cm_r[TM], dap[TM];
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        const bool ok = gr[r] < n2;
        ar[r] = ok ? alpha[(size_t)gr[r] * nm + m] : 0.f;
        lm_r[r] = ok ? lse[(size_t)m * n2 + gr[r]] : 0.f;
        cm_r[r] = ok ? coef[(size_t)m * n2 + gr[r]] : 0.f;
        dap[r] = 0.f;
      }
      float dbp = 0.f;
#pragma unroll
      for (int c = 0; c < TN; ++c) {
        const int lc = tile_col(tx, c);
        const int gc = col0 + lc;
        const bool okc = gc < n2;
        const float v_c = okc ? v[gc] : 0.f;
        const float ac = okc ? alpha[(size_t)gc * nm + m] : 0.f;
        const float lm_c = okc ? lse[(size_t)m * n2 + gc] : 0.f;
        const float cm_c = okc ? coef[(size_t)m * n2 + gc] : 0.f;
#pragma unroll
        for (int r = 0; r < TM; ++r) {
          const float k = acc[r][c];
          float w = 0.f;
          if (okc && gr[r] < n2) {
            w = w_channel(k * inv_tau, lm_r[r], lm_c, cm_r[r], cm_c, v_r[r],
                          v_c, gc != gr[r], gc == pos[r], inv_tau);
            w += w_a[r][c] * (ar[r] * ac) + w_f[r][c] * bm;
          }
          ws[ty * TM + r][lc] = w;
          dap[r] = fmaf(w_a[r][c] * k, ac, dap[r]);
          dbp = fmaf(w_f[r][c], k, dbp);
        }
      }
      // dalpha: merge the row's TX partials; one thread owns each row
#pragma unroll
      for (int off = TX / 2; off >= 1; off >>= 1) {
#pragma unroll
        for (int r = 0; r < TM; ++r) dap[r] += __shfl_xor_sync(0xffffffffu, dap[r], off);
      }
      if (tx == 0) {
#pragma unroll
        for (int r = 0; r < TM; ++r) da_sm[mi * BM + ty * TM + r] += dap[r];
      }
      db_sm[mi * THREADS + tid] += dbp;
      __syncthreads();   // publishes ws

      // accs[mi][rows, :] += W (BM x BN) @ z_m[col0 : col0 + BN, :]
      tile_wz(ws, zm, n2, d, col0, sm, accs + (size_t)mi * BM * d);
    }
  }
  __syncthreads();

  for (int mi = 0; mi < nmy; ++mi) {
    const int m = m0 + mi;
    const float* acc_m = accs + (size_t)mi * BM * d;
    for (int i = tid; i < BM * d; i += THREADS) {
      const int r = row0 + i / d;
      if (r < n2) dz[((size_t)m * n2 + r) * d + i % d] = acc_m[i];
    }
    for (int i = tid; i < BM; i += THREADS) {
      if (row0 + i < n2) dalpha[(size_t)(row0 + i) * nm + m] = da_sm[mi * BM + i];
    }
  }
  // the block's dbeta partials, summed over its threads in a fixed order
  if (tid < nmy) {
    float s = 0.f;
    for (int t = 0; t < THREADS; ++t) s += db_sm[tid * THREADS + t];
    dbeta_part[(size_t)blockIdx.x * nm + m0 + tid] = s;
  }
}

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
// largest (modalities per block) x d its row accumulator then holds, or a
// negative CUDA error.
int mixture_grad_init(void) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(mixture_grad_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(mixture_grad_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err != cudaSuccess) return -static_cast<int>(err);
  const long room = (long)optin - (long)GRAD_FIXED_BYTES;
  return room > 0 ? static_cast<int>(room / (sizeof(float) * BM)) : 0;
}

// z, alpha, beta, v as for mixture_lse; lse and coef (m + 2, n2); writes
// dz (m, n2, d), dalpha (n2, m) and dbeta (m,) in full, using dbeta_part
// (ceil(n2 / 32), m) as scratch.  Each block handles mg modalities; mg * d
// must not exceed what mixture_grad_init returned for this device.
int mixture_grad(const float* z, const float* alpha, const float* beta,
                 const float* lse, const float* coef, const float* v,
                 float* dz, float* dalpha, float* dbeta, float* dbeta_part,
                 int m, int mg, int n2, int d, float inv_tau, void* stream) {
  if (check_shape(m, n2, d) || mg < 1 || mg > m)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = grad_smem_bytes(mg, d);
  const int n_blocks = (n2 + BM - 1) / BM;
  const dim3 grid(n_blocks, (m + mg - 1) / mg);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec_ok(z, d))
    mixture_grad_kernel<true><<<grid, THREADS, bytes, s>>>(
        z, alpha, beta, lse, coef, v, dz, dalpha, dbeta_part, m, mg, n2, d, inv_tau);
  else
    mixture_grad_kernel<false><<<grid, THREADS, bytes, s>>>(
        z, alpha, beta, lse, coef, v, dz, dalpha, dbeta_part, m, mg, n2, d, inv_tau);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  mixture_dbeta_kernel<<<m, REDUCE_THREADS, 0, s>>>(dbeta_part, dbeta, n_blocks, m);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
