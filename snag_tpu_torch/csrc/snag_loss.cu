// SNAG's fused loss bundle for Hopper, f32 and bf16 operands: the
// row-logsumexp of M modality channels and two mixture channels from shared
// similarity tiles, and its gradient, neither of which writes a quadratic
// array.
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
// mixture_lse: what bounds it on the H100 is arithmetic, M products K_m,
// each symmetric, so M n2 (n2 + 1) d flops (5.9e10 at M = 4, B = 3500,
// d = 300) plus the mixtures and M + 2 exps per element.  The kernel is
// gram_lse.cuh's with MIX = true (NT-Xent shares it with MIX = false): a
// block takes one unordered pair of 96-row tiles and walks every modality
// over it, each K_m tile once on the tensor cores in 3xTF32 (one TF32
// product misses the lse limit 3-20x, tests/test_torch_tf32x3.py), its
// exps into its channel's row and column sums and into the mixtures'
// running sums, whose own exps follow after the last modality.  The
// running sums stay in registers beside the K tile: 8 warps of (48 x 24)
// tiles, 254 registers without spills, one block an SM.  Row partials per
// tile pair, added in a fixed order by mixture_lse_sum_kernel: no atomics.
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
// modalities (blockIdx.y, chosen by the wrapper); where one modality's
// does not (d past ~1,500 columns: grad_fits), the plan is gram_grad.cuh's
// wide body: the blocks of a row tile's modalities and feature chunks form
// a thread-block cluster in which each K_m and each weight is computed
// once (mixture_grad_scratch says which body runs).  dbeta is summed per
// block, written as per-block partials and reduced in a fixed order: no
// atomics, two runs give the same bits.
//
// mixture_lse_bf16 and mixture_grad_bf16: bf16 z (the JAX package's bf16
// path casts the unit rows to bf16 before both Pallas kernels), their
// products on the bf16 tensor cores, one m16n8k16 mma.sync with fp32
// accumulation.  The rounding points are the Pallas kernels'
// (snag_loss_kernel.py:185-226): lse takes K from the bf16 operands in
// fp32 and all after it in fp32; the gradient builds mix_a and mix_f from
// that fp32 K, while each modality's own weight W_m, its dalpha term and
// its dbeta term read K rounded to bf16 (the kernel's K scratch is in z's
// dtype), and W_tot is rounded to bf16 before W_tot z.  Two rounding
// points differ from the Pallas kernel's, both at a row's positive
// partner: the own channel's bf16 K is kpos, the exact dot of the two bf16
// rows rounded once to bf16, and the bf16 W_tot that multiplies z is wpos,
// W_tot in f64 from the exact dots rounded once (mixture_kpos_bf16_kernel,
// a warp a row, M f64 dots each), where Pallas rounds its own f32 sums: at
// most one bf16 ulp apart.  The kernel's mma order and exps and the twin's
// slice sums and torch.exp round such a value apart where its f32 last
// bits sit on a bf16 boundary: one ulp of a positive pair's K moves that
// row's W_m by ~4 % at tau = 0.1, and the positive pair's W_tot is the
// largest entry of W; the exact values round one way on both sides.
// The bound is the flops over the bf16 dense rate, 989 TFLOP/s.
// mixture_lse_bf16 is gram_lse_bf16.cuh's kernel with MIX = true:
// persistent blocks of 16 warps that walk pairs of 128-row tiles, every
// modality over a pair, a ring of 64-feature slabs that runs on across
// modalities and pairs.  mixture_grad_bf16 is
// gram_grad_bf16.cuh's kernel with MIX = true: a block owns 128 rows of one
// modality's dz in registers (feature chunks past d = 304), walks every
// modality's K per 64-column tile for the mixtures, and W_tot never leaves
// registers.  It has no modality groups and no accumulator cap: its plan
// is mixture_grad_bf16_plan.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "gram_grad.cuh"
#include "gram_grad_bf16.cuh"
#include "gram_lse.cuh"
#include "gram_lse_bf16.cuh"

namespace {

// The lse kernel's tile: 8 warps of (48 x 24) 3xTF32 tiles, so that the
// mixtures' running sums fit in registers beside the K tile, one block an
// SM.
constexpr int LSE_TILE = 96;

template <bool VEC>
__global__ void __launch_bounds__(lse::THREADS, 1)
mixture_lse_mma_kernel(const float* __restrict__ z,
                       const float* __restrict__ alpha,
                       const float* __restrict__ beta,
                       const float* __restrict__ v, float* __restrict__ part,
                       int nm, int n2, int d, float inv_tau) {
  lse::gram_lse<true, VEC, LSE_TILE>(z, alpha, beta, v, part, nm, n2, d,
                                     inv_tau);
}

__global__ void __launch_bounds__(lse::SUM_THREADS)
mixture_lse_sum_kernel(const float* __restrict__ part, float* __restrict__ lse,
                       int channels, int tiles, int n2, float inv_tau) {
  lse::sum_partials(part, lse, channels, tiles, n2, inv_tau);
}

// The bf16 kernels, named apart so that a profile tells them apart.  The
// lse: 16 warps as 4 x 4 tiles of (32 x 32), so that the K tile and the
// mixtures' running sums fit in 128 registers, a four-slot ring (five or
// six slots ran slower, as the spills' cache shrank), one block an SM
// (gram_lse_bf16.cuh).
constexpr int LSE16_WR = 4, LSE16_WC = 4, LSE16_DEPTH = 4;

__global__ void __launch_bounds__(32 * LSE16_WR * LSE16_WC, 1)
mixture_lse_bf16_mma_kernel(const __grid_constant__ CUtensorMap map,
                            const float* __restrict__ alpha,
                            const float* __restrict__ beta,
                            const float* __restrict__ v,
                            float* __restrict__ part, int nm, int n2, int d,
                            float inv_tau) {
  lse16::gram_lse_bf16<true, LSE16_WR, LSE16_WC, LSE16_DEPTH>(
      &map, alpha, beta, v, part, nm, n2, d, inv_tau);
}

__global__ void __launch_bounds__(REDUCE_THREADS)
mixture_lse_bf16_pad_kernel(const __nv_bfloat16* __restrict__ z,
                            __nv_bfloat16* __restrict__ zp, size_t rows, int d,
                            int ld) {
  grad16::pad_rows(z, zp, rows, d, ld);
}

__global__ void __launch_bounds__(lse::SUM_THREADS)
mixture_lse_bf16_sum_kernel(const float* __restrict__ part,
                            float* __restrict__ lse, int channels, int tiles,
                            int n2, float inv_tau) {
  lse::sum_partials(part, lse, channels, tiles, n2, inv_tau);
}

// ------------------------------------------------------------- mixture_grad
// The kernel is grad::mixture_grad_kernel of gram_grad.cuh (bf16:
// grad16::mixture_grad_bf16_kernel of gram_grad_bf16.cuh).

// dbeta[m] = 1/2 sum_b part[b, m], in a fixed order: one block per m.
__device__ __forceinline__ void mixture_dbeta(const float* __restrict__ part,
                                              float* __restrict__ dbeta,
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

__global__ void __launch_bounds__(REDUCE_THREADS)
mixture_dbeta_kernel(const float* __restrict__ part, float* __restrict__ dbeta,
                     int n_blocks, int nm) {
  mixture_dbeta(part, dbeta, n_blocks, nm);
}

// out[i] += part[0][i] + part[1][i] + ..., in that order.
__global__ void __launch_bounds__(REDUCE_THREADS)
mixture_sum_kernel(float* __restrict__ out, const float* __restrict__ part,
                   size_t n, int parts) {
  add_partials(out, part, n, parts);
}

// the same two for the wide body (gram_grad.cuh), named apart
__global__ void __launch_bounds__(REDUCE_THREADS)
mixture_grad_wide_dbeta_kernel(const float* __restrict__ part,
                               float* __restrict__ dbeta, int n_blocks,
                               int nm) {
  mixture_dbeta(part, dbeta, n_blocks, nm);
}

__global__ void __launch_bounds__(REDUCE_THREADS)
mixture_grad_wide_sum_kernel(float* __restrict__ out,
                             const float* __restrict__ part, size_t n,
                             int parts) {
  add_partials(out, part, n, parts);
}

__global__ void __launch_bounds__(REDUCE_THREADS)
mixture_dbeta_bf16_kernel(const float* __restrict__ part,
                          float* __restrict__ dbeta, int n_blocks, int nm) {
  mixture_dbeta(part, dbeta, n_blocks, nm);
}

__global__ void __launch_bounds__(REDUCE_THREADS)
mixture_sum_bf16_kernel(float* __restrict__ out, const float* __restrict__ part,
                        size_t n, int parts) {
  add_partials(out, part, n, parts);
}

// The kernels of one operand type Op (float or __nv_bfloat16).
template <typename Op>
struct Kernels;

template <>
struct Kernels<float> {
  static constexpr auto lse_vec = mixture_lse_mma_kernel<true>;
  static constexpr auto lse_scalar = mixture_lse_mma_kernel<false>;
  static constexpr auto lse_sum = mixture_lse_sum_kernel;
  static constexpr auto grad_vec = grad::mixture_grad_kernel<true>;
  static constexpr auto grad_scalar = grad::mixture_grad_kernel<false>;
  static constexpr auto dbeta = mixture_dbeta_kernel;
  static constexpr auto sum = mixture_sum_kernel;
};

// the wide body's kernels
struct Wide {
  static constexpr auto vec = grad::mixture_grad_wide_kernel<true>;
  static constexpr auto scalar = grad::mixture_grad_wide_kernel<false>;
  static constexpr auto dbeta = mixture_grad_wide_dbeta_kernel;
  static constexpr auto sum = mixture_grad_wide_sum_kernel;
};

template <>
struct Kernels<__nv_bfloat16> {
  static constexpr auto lse_kernel = mixture_lse_bf16_mma_kernel;
  static constexpr auto lse_sum = mixture_lse_bf16_sum_kernel;
  static constexpr auto grad_kernel = grad16::mixture_grad_bf16_kernel;
  static constexpr auto dbeta = mixture_dbeta_bf16_kernel;
  static constexpr auto sum = mixture_sum_bf16_kernel;
};

int lse_setup(int m, int n2, LsePlan& plan) {
  return lse_plan<LSE_TILE>(
      reinterpret_cast<const void*>(Kernels<float>::lse_vec),
      reinterpret_cast<const void*>(Kernels<float>::lse_scalar), m + 2, n2,
      plan);
}

// Plans a bf16 lse launch (gram_lse_bf16.cuh): m modalities, m + 2
// channels, each pair once.
int lse_setup_bf16(int m, int n2, int d, lse16::Plan& plan) {
  return lse16::plan<true, LSE16_WR, LSE16_WC, LSE16_DEPTH>(
      reinterpret_cast<const void*>(Kernels<__nv_bfloat16>::lse_kernel), m,
      m + 2, 1, n2, d, plan);
}

// 16-byte copies of 4 floats
bool vec_ok(const float* z, int d) {
  return d % 4 == 0 && reinterpret_cast<uintptr_t>(z) % 16 == 0;
}

int check_shape(int m, int n2, int d) {
  return (m <= 0 || m > MAX_MOD || n2 <= 0 || n2 % 2 || d <= 0)
             ? static_cast<int>(cudaErrorInvalidValue)
             : 0;
}

long lse_plan_entry(int m, int n2, int d, int* out) {
  if (check_shape(m, n2, d)) return -static_cast<long>(cudaErrorInvalidValue);
  LsePlan plan;
  const int err = lse_setup(m, n2, plan);
  if (err) return -static_cast<long>(err);
  if (out) {
    out[0] = plan.tile;
    out[1] = plan.pairs;
    out[2] = plan.per_sm;
  }
  return static_cast<long>(plan.scratch);
}

int lse_entry(const float* z, const float* alpha, const float* beta,
              const float* v, float* part, float* lse, int m, int n2, int d,
              float inv_tau, void* stream) {
  if (check_shape(m, n2, d)) return static_cast<int>(cudaErrorInvalidValue);
  LsePlan plan;
  int err = lse_setup(m, n2, plan);
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec_ok(z, d))
    Kernels<float>::lse_vec<<<plan.pairs, lse::THREADS, plan.bytes, s>>>(
        z, alpha, beta, v, part, m, n2, d, inv_tau);
  else
    Kernels<float>::lse_scalar<<<plan.pairs, lse::THREADS, plan.bytes, s>>>(
        z, alpha, beta, v, part, m, n2, d, inv_tau);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const long n = (long)(m + 2) * n2;
  Kernels<float>::lse_sum<<<
      (int)((n + lse::SUM_THREADS - 1) / lse::SUM_THREADS), lse::SUM_THREADS,
      0, s>>>(part, lse, m + 2, plan.tiles, n2, inv_tau);
  return static_cast<int>(cudaGetLastError());
}

long lse_plan_entry_bf16(int m, int n2, int d, int* out) {
  if (check_shape(m, n2, d)) return -static_cast<long>(cudaErrorInvalidValue);
  lse16::Plan plan;
  const int err = lse_setup_bf16(m, n2, d, plan);
  if (err) return -static_cast<long>(err);
  if (out) lse16::report(plan, out);
  return static_cast<long>(plan.scratch);
}

// z 16-byte aligned (the wrapper sees to it)
int lse_entry_bf16(const __nv_bfloat16* z, const float* alpha,
                   const float* beta, const float* v, float* part, float* lse,
                   int m, int n2, int d, float inv_tau, void* stream) {
  if (check_shape(m, n2, d)) return static_cast<int>(cudaErrorInvalidValue);
  lse16::Plan plan;
  int err = lse_setup_bf16(m, n2, d, plan);
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // rows of 16-byte multiples: z itself, or its padded copy
  const int ld = grad16::z_stride(d);
  if (ld != d) {
    __nv_bfloat16* zp = reinterpret_cast<__nv_bfloat16*>(part + plan.pad_at);
    mixture_lse_bf16_pad_kernel<<<1024, REDUCE_THREADS, 0, s>>>(
        z, zp, (size_t)m * n2, d, ld);
    err = static_cast<int>(cudaGetLastError());
    if (err) return err;
    z = zp;
  }
  CUtensorMap map;
  err = lse16::make_map(&map, z, (long long)m * n2, ld);
  if (err) return err;
  Kernels<__nv_bfloat16>::lse_kernel<<<plan.blocks,
                                       32 * LSE16_WR * LSE16_WC, plan.bytes,
                                       s>>>(map, alpha, beta, v, part, m, n2,
                                            d, inv_tau);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const long n = (long)(m + 2) * n2;
  Kernels<__nv_bfloat16>::lse_sum<<<
      (int)((n + lse::SUM_THREADS - 1) / lse::SUM_THREADS), lse::SUM_THREADS,
      0, s>>>(part, lse, m + 2, plan.tiles, n2, inv_tau);
  return static_cast<int>(cudaGetLastError());
}

// Plans an fp32 gradient launch (gram_grad.cuh) of mg modalities a block:
// the main-path body where its accumulator holds them (grad_fits), else,
// at one modality a block, the wide body.  After mixture_grad_init.
int grad_plan_of(int m, int mg, int n2, int d, GradPlan& plan) {
  if (check_shape(m, n2, d) || mg < 1 || mg > m)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (grad_fits(mg, d, optin))
    return grad_plan<true>(
        reinterpret_cast<const void*>(Kernels<float>::grad_vec), m, mg, n2, d,
        plan);
  if (mg > 1) return static_cast<int>(cudaErrorInvalidValue);
  const void* wide[] = {reinterpret_cast<const void*>(Wide::vec),
                        reinterpret_cast<const void*>(Wide::scalar)};
  return wide_plan<true>(wide, 2, m, n2, d, plan);
}

long grad_scratch_entry(int m, int mg, int n2, int d, int* out) {
  GradPlan plan;
  const int err = grad_plan_of(m, mg, n2, d, plan);
  if (err) return -static_cast<long>(err);
  if (out) report_plan(plan, out);
  return static_cast<long>(plan.scratch);
}

// dalpha and dz += the column splits' partials, then dbeta from the
// per-block partials (`blocks` of them: splits x row blocks, and x the
// cluster's ranks for the wide body), each in a fixed order.  K: the
// Kernels or Wide set.
template <typename K>
int sum_splits(float* dz, float* dalpha, float* dbeta, float* part, int m,
               int n2, int d, int blocks, int splits, cudaStream_t s) {
  if (splits > 1) {
    const size_t parts = (size_t)blocks * m;
    const size_t n_da = (size_t)n2 * m, n_dz = (size_t)m * n2 * d;
    K::sum<<<1024, REDUCE_THREADS, 0, s>>>(dalpha, part + parts, n_da,
                                           splits - 1);
    K::sum<<<1024, REDUCE_THREADS, 0, s>>>(
        dz, part + parts + (splits - 1) * n_da, n_dz, splits - 1);
  }
  K::dbeta<<<m, REDUCE_THREADS, 0, s>>>(part, dbeta, blocks, m);
  return static_cast<int>(cudaGetLastError());
}

int grad_entry(const float* z, const float* alpha, const float* beta,
               const float* lse, const float* coef, const float* v, float* dz,
               float* dalpha, float* dbeta, float* part, int m, int mg, int n2,
               int d, float inv_tau, void* stream) {
  GradPlan plan;
  int err = grad_plan_of(m, mg, n2, d, plan);
  if (err) return err;
  const int nb = (n2 + grad::ROWS - 1) / grad::ROWS;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = vec_ok(z, d);
  if (plan.wide) {
    // clusters of a row block's m modalities x q depth slices, a group
    WideLaunch l(dim3(nb, plan.groups * plan.cluster, plan.splits),
                 plan.cluster, plan.bytes, s);
    err = static_cast<int>(cudaLaunchKernelEx(
        &l.cfg, vec ? Wide::vec : Wide::scalar, z, alpha, beta, lse, coef, v,
        dz, dalpha, part, m, plan.q, plan.groups, n2, d, inv_tau,
        plan.depth));
    if (!err) err = static_cast<int>(cudaGetLastError());
    if (err) return err;
    return sum_splits<Wide>(dz, dalpha, dbeta, part, m, n2, d,
                            plan.splits * nb * plan.cluster, plan.splits, s);
  }
  const dim3 grid(nb, (m + mg - 1) / mg, plan.splits);
  if (vec)
    Kernels<float>::grad_vec<<<grid, grad::THREADS, plan.bytes, s>>>(
        z, alpha, beta, lse, coef, v, dz, dalpha, part, m, mg, n2, d, inv_tau,
        plan.depth);
  else
    Kernels<float>::grad_scalar<<<grid, grad::THREADS, plan.bytes, s>>>(
        z, alpha, beta, lse, coef, v, dz, dalpha, part, m, mg, n2, d, inv_tau,
        plan.depth);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  return sum_splits<Kernels<float>>(dz, dalpha, dbeta, part, m, n2, d,
                                    plan.splits * nb, plan.splits, s);
}

// Lets the bf16 gradient kernel take all the shared memory a block may opt
// in to on the current device, then plans a launch (gram_grad_bf16.cuh).
int grad_plan_bf16(int m, int n2, int d, grad16::Plan& plan) {
  int dev = 0, optin = 0;
  const void* kernel = reinterpret_cast<const void*>(Kernels<__nv_bfloat16>::grad_kernel);
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
  if (err != cudaSuccess) return static_cast<int>(err);
  return grad16::plan<true>(kernel, m, n2, d, plan);
}

int grad_entry_bf16(const __nv_bfloat16* z, const float* alpha,
                    const float* beta, const float* lse, const float* coef,
                    const float* v, float* dz, float* dalpha, float* dbeta,
                    float* part, int m, int n2, int d, float inv_tau,
                    void* stream) {
  if (check_shape(m, n2, d)) return static_cast<int>(cudaErrorInvalidValue);
  grad16::Plan plan;
  int err = grad_plan_bf16(m, n2, d, plan);
  if (err) return err;
  const int nb = (n2 + grad16::ROWS - 1) / grad16::ROWS;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // at each row's positive partner: the own channel's K and W_tot, each
  // rounded once from its exact value
  float* kpos = part + plan.kpos_at;
  float* wpos = kpos + (size_t)m * n2;
  grad16::mixture_kpos_bf16_kernel<<<(int)(((size_t)n2 * 32 +
                                            REDUCE_THREADS - 1) /
                                           REDUCE_THREADS),
                                     REDUCE_THREADS, 0, s>>>(
      z, alpha, beta, lse, coef, v, kpos, wpos, m, n2, d, inv_tau);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  // rows of 16-byte multiples: z itself, or its padded copy
  const int ld = grad16::z_stride(d);
  if (ld != d) {
    __nv_bfloat16* zp = reinterpret_cast<__nv_bfloat16*>(part + plan.pad_at);
    grad16::mixture_grad_bf16_pad_kernel<<<1024, REDUCE_THREADS, 0, s>>>(
        z, zp, (size_t)m * n2, d, ld);
    err = static_cast<int>(cudaGetLastError());
    if (err) return err;
    z = zp;
  }
  // a cluster of the m modality blocks of each row block, chunk and split
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nb, m * plan.chunks, plan.splits);
  cfg.blockDim = dim3(grad16::THREADS);
  cfg.dynamicSmemBytes = plan.bytes;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = m;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = static_cast<int>(cudaLaunchKernelEx(
      &cfg, Kernels<__nv_bfloat16>::grad_kernel, z, alpha, beta, lse, coef, v,
      static_cast<const float*>(kpos), static_cast<const float*>(wpos), dz,
      dalpha, part, m, plan.chunks, n2, d, inv_tau, plan.depth, ld));
  if (err) return err;
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  return sum_splits<Kernels<__nv_bfloat16>>(dz, dalpha, dbeta, part, m, n2,
                                            d, plan.splits * nb, plan.splits,
                                            s);
}

}  // namespace

extern "C" {

const char* snag_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// How mixture_lse runs at this shape on the current device: returns the
// floats of scratch it needs (the row partials of every tile pair and
// channel), or a negative CUDA error; if out is not null, writes {tile,
// tile pairs, blocks per SM} to it.
long mixture_lse_plan(int m, int n2, int d, int* out) {
  return lse_plan_entry(m, n2, d, out);
}

// z (m, n2, d) unit rows, alpha (n2, m), beta (m,), v (n2,) 0/1 column
// validity; writes lse (m + 2, n2) in full, using part (mixture_lse_plan
// floats) as scratch.
int mixture_lse(const float* z, const float* alpha, const float* beta,
                const float* v, float* part, float* lse, int m, int n2, int d,
                float inv_tau, void* stream) {
  return lse_entry(z, alpha, beta, v, part, lse, m, n2, d, inv_tau, stream);
}

// Once per device, before the first mixture_grad on it: lets the fp32
// gradient kernels take all the shared memory a block may opt in to, and
// returns the largest (modalities per block) x d (a multiple of 8) its row
// accumulator then holds (past it at one modality, the wide body runs), or
// a negative CUDA error.
int mixture_grad_init(void) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const void* kernels[] = {
      reinterpret_cast<const void*>(Kernels<float>::grad_vec),
      reinterpret_cast<const void*>(Kernels<float>::grad_scalar)};
  for (const void* k : kernels)
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 optin);
  if (err != cudaSuccess) return -static_cast<int>(err);
  const long cap = grad_cap(1, optin);
  return cap > 0 ? 8 * static_cast<int>(cap) : 0;
}

// The floats of scratch that mixture_grad needs at this shape, with mg
// modalities a block (per-block dbeta partials, and the dalpha and dz
// partials of the column splits past the first), or a negative CUDA error;
// if out is not null, writes {feature chunks, ring depth, column splits,
// blocks per SM, wide, blocks a cluster, cluster groups, depth slices} to
// it (gram_grad.cuh GradPlan): wide 0 on the main-path body, where mg x d
// must not exceed what mixture_grad_init returned for this device; 1 past
// it at mg = 1, on the wide body (mixture_grad_wide_kernel, clusters of
// every modality x q depth slices, `groups` clusters of feature chunks a
// row block).  Call after mixture_grad_init.
long mixture_grad_scratch(int m, int mg, int n2, int d, int* out) {
  return grad_scratch_entry(m, mg, n2, d, out);
}

// z, alpha, beta, v as for mixture_lse; lse and coef (m + 2, n2); writes
// dz (m, n2, d), dalpha (n2, m) and dbeta (m,) in full, using part
// (mixture_grad_scratch floats) as scratch, on the body
// mixture_grad_scratch names.  On the main-path body each block handles mg
// modalities; the outputs' bits do not depend on mg at a fixed count of
// column splits.
int mixture_grad(const float* z, const float* alpha, const float* beta,
                 const float* lse, const float* coef, const float* v,
                 float* dz, float* dalpha, float* dbeta, float* part,
                 int m, int mg, int n2, int d, float inv_tau, void* stream) {
  return grad_entry(z, alpha, beta, lse, coef, v, dz, dalpha, dbeta, part, m,
                    mg, n2, d, inv_tau, stream);
}

// The same on bf16 z; alpha, beta, v, lse, coef, every output and the
// scratch stay fp32.  The bf16 lse's plan (gram_lse_bf16.cuh): {tile, tile
// pairs, blocks per SM, persistent blocks, ring slots, features a slot,
// warps a block} to out; its scratch also holds z's padded copy where
// d % 8 != 0.
long mixture_lse_bf16_plan(int m, int n2, int d, int* out) {
  return lse_plan_entry_bf16(m, n2, d, out);
}

// z 16-byte aligned
int mixture_lse_bf16(const __nv_bfloat16* z, const float* alpha,
                     const float* beta, const float* v, float* part,
                     float* lse, int m, int n2, int d, float inv_tau,
                     void* stream) {
  return lse_entry_bf16(z, alpha, beta, v, part, lse, m, n2, d, inv_tau,
                        stream);
}

// How mixture_grad_bf16 runs at this shape on the current device: returns
// the floats of scratch it needs (per-block dbeta partials, and the
// dalpha and dz partials of the column splits past the first), or a
// negative CUDA error; if out is not null, writes {feature chunks, ring
// depth, column splits, blocks per SM, rows per block, rows resident,
// blocks a cluster} to it.  Every modality and any d: no init, no modality groups.
long mixture_grad_bf16_plan(int m, int n2, int d, int* out) {
  if (check_shape(m, n2, d)) return -static_cast<long>(cudaErrorInvalidValue);
  grad16::Plan plan;
  const int err = grad_plan_bf16(m, n2, d, plan);
  if (err) return -static_cast<long>(err);
  if (out) {
    out[0] = plan.chunks;
    out[1] = plan.depth;
    out[2] = plan.splits;
    out[3] = plan.per_sm;
    out[4] = plan.rows;
    out[5] = plan.resident;
    out[6] = plan.cluster;
  }
  return static_cast<long>(plan.scratch);
}

// As mixture_grad on bf16 z, without modality groups; part holds
// mixture_grad_bf16_plan floats.
int mixture_grad_bf16(const __nv_bfloat16* z, const float* alpha,
                      const float* beta, const float* lse, const float* coef,
                      const float* v, float* dz, float* dalpha, float* dbeta,
                      float* part, int m, int n2, int d, float inv_tau,
                      void* stream) {
  return grad_entry_bf16(z, alpha, beta, lse, coef, v, dz, dalpha, dbeta,
                         part, m, n2, d, inv_tau, stream);
}

}  // extern "C"
