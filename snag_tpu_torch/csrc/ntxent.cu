// Streaming batched NT-Xent for Hopper, f32 and bf16 operands: the
// row-logsumexp of the virtual similarity matrix and its gradient, neither
// of which writes a quadratic array.
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
// What bounds it on the H100: arithmetic.  S is symmetric, so the forward
// needs n2 (n2 + 1) d flops per batch, the gradient 2 n2^2 d more for
// W z; against O(n2 d) bytes per block read from L2.
//
// ntxent_lse: the shared 3xTF32 tensor-core lse of gram_lse.cuh with
// MIX = false, the mixture lse without its mixtures.  A block takes one
// unordered pair of 128-row tiles of one batch, so each element of S is
// computed once (IIR (4, 3500, 300): 1,540 pairs a batch, 6.1e10 flops
// executed against 1.18e11 for the whole S), and adds its exps to its
// row's and its column's sums.  One TF32 product misses the lse limit
// 3-20x, 3xTF32 holds it as fp32 products do (tests/test_torch_tf32x3.py).
// 8 warps of (64 x 32) tiles, 64 accumulators a thread: at two blocks an
// SM (128 registers) ptxas spills, so one block an SM (221 registers, no
// spills) with a four-slot ring of 99 KB.  The row partials of every pair
// go to scratch and ntxent_lse_sum_kernel adds them in a fixed order: no
// atomics.
//
// ntxent_grad: the shared 3xTF32 tensor-core gradient of gram_grad.cuh
// with MIX = false, the mixture gradient without its mixtures.  One TF32
// product misses the 1e-4 dz limit 4-16x, 3xTF32 holds it as fp32 products
// do (tests/test_torch_tf32x3.py).  A block owns 32 rows of one batch and
// all of d: its accumulator (32 rows x d, 38 KB at d = 300) and a
// four-slot ring take 107 KB, so two blocks share an SM and one block's
// loads run under the other's products.  d takes any value: past what
// that accumulator holds beside the shallowest ring (grad_fits: d > 1,504
// on the H100), the plan is gram_grad.cuh's wide body, whose blocks of a
// row tile's feature chunks form a thread-block cluster that computes S
// and W once (ntxent_grad_plan says which body runs).
//
// ntxent_lse_bf16 and ntxent_grad_bf16: bf16 z (the JAX package's bf16
// path casts the unit rows to bf16 before both Pallas kernels), the
// products on the bf16 tensor cores, one m16n8k16 mma.sync with fp32
// accumulation, whose products are exact, so one product keeps fp32's
// accumulation error.  lse: gram_lse_bf16.cuh's kernel with MIX = false
// (persistent blocks that walk tile pairs of 128 rows, a ring of 64-feature
// slabs that runs on across pairs, 8 warps, two blocks an SM), S from the
// bf16 operands in fp32, all after it fp32.  Gradient:
// gram_grad_bf16.cuh's kernel, built for bf16 (a warp's 16-row strip, W
// from K's C fragments in registers, dz in registers, the block's rows
// resident and one staging of each column tile up to d = 304; past it the
// chunks' blocks form a cluster that splits K's rows); S likewise, W
// rounded to bf16 before W z (the Pallas kernel's w.astype(z.dtype),
// ntxent_kernel.py:157), dz fp32.
// The bound is the flops over the bf16 dense rate, 989 TFLOP/s.

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

// The lse kernel's tile: 8 warps of (64 x 32) 3xTF32 tiles, 64 fp32
// accumulators a thread, one block an SM.
constexpr int LSE_TILE = 128;

template <bool VEC>
__global__ void __launch_bounds__(lse::THREADS, 1)
ntxent_lse_mma_kernel(const float* __restrict__ z, const float* __restrict__ v,
                      float* __restrict__ part, int n2, int d, float inv_tau) {
  lse::gram_lse<false, VEC, LSE_TILE>(z, nullptr, nullptr, v, part, 1, n2, d,
                                      inv_tau);
}

__global__ void __launch_bounds__(lse::SUM_THREADS)
ntxent_lse_sum_kernel(const float* __restrict__ part, float* __restrict__ lse,
                      int m, int tiles, int n2, float inv_tau) {
  lse::sum_partials(part, lse, m, tiles, n2, inv_tau);
}

// The bf16 kernels, named apart so that a profile tells them apart.  The
// lse: 8 warps as 2 x 4 tiles of (64 x 32), a three-slot ring, two blocks
// an SM (gram_lse_bf16.cuh).
constexpr int LSE16_WR = 2, LSE16_WC = 4, LSE16_DEPTH = 3;

__global__ void __launch_bounds__(32 * LSE16_WR * LSE16_WC, 2)
ntxent_lse_bf16_mma_kernel(const __grid_constant__ CUtensorMap map,
                           const float* __restrict__ v,
                           float* __restrict__ part, int m, int n2, int d,
                           float inv_tau) {
  lse16::gram_lse_bf16<false, LSE16_WR, LSE16_WC, LSE16_DEPTH>(
      &map, nullptr, nullptr, v, part, m, n2, d, inv_tau);
}

__global__ void __launch_bounds__(REDUCE_THREADS)
ntxent_lse_bf16_pad_kernel(const __nv_bfloat16* __restrict__ z,
                           __nv_bfloat16* __restrict__ zp, size_t rows, int d,
                           int ld) {
  grad16::pad_rows(z, zp, rows, d, ld);
}

__global__ void __launch_bounds__(lse::SUM_THREADS)
ntxent_lse_bf16_sum_kernel(const float* __restrict__ part,
                           float* __restrict__ lse, int m, int tiles, int n2,
                           float inv_tau) {
  lse::sum_partials(part, lse, m, tiles, n2, inv_tau);
}

// out[i] += part[0][i] + part[1][i] + ..., in that order: the dz partials
// of the gradient's column splits.
__global__ void __launch_bounds__(REDUCE_THREADS)
ntxent_grad_sum_kernel(float* __restrict__ out, const float* __restrict__ part,
                       size_t n, int parts) {
  add_partials(out, part, n, parts);
}

// the same for the wide body's column splits (gram_grad.cuh), named apart
__global__ void __launch_bounds__(REDUCE_THREADS)
ntxent_grad_wide_sum_kernel(float* __restrict__ out,
                            const float* __restrict__ part, size_t n,
                            int parts) {
  add_partials(out, part, n, parts);
}

__global__ void __launch_bounds__(REDUCE_THREADS)
ntxent_grad_bf16_sum_kernel(float* __restrict__ out,
                            const float* __restrict__ part, size_t n,
                            int parts) {
  add_partials(out, part, n, parts);
}

// The kernels of one operand type Op (float or __nv_bfloat16).
template <typename Op>
struct Kernels;

template <>
struct Kernels<float> {
  static constexpr auto lse_vec = ntxent_lse_mma_kernel<true>;
  static constexpr auto lse_scalar = ntxent_lse_mma_kernel<false>;
  static constexpr auto lse_sum = ntxent_lse_sum_kernel;
  static constexpr auto grad_vec = grad::ntxent_grad_mma_kernel<true>;
  static constexpr auto grad_scalar = grad::ntxent_grad_mma_kernel<false>;
  static constexpr auto grad_sum = ntxent_grad_sum_kernel;
  static constexpr auto wide_vec = grad::ntxent_grad_wide_kernel<true>;
  static constexpr auto wide_scalar = grad::ntxent_grad_wide_kernel<false>;
  static constexpr auto wide_sum = ntxent_grad_wide_sum_kernel;
};

template <>
struct Kernels<__nv_bfloat16> {
  static constexpr auto lse_kernel = ntxent_lse_bf16_mma_kernel;
  static constexpr auto lse_sum = ntxent_lse_bf16_sum_kernel;
  static constexpr auto grad_kernel = grad16::ntxent_grad_bf16_mma_kernel;
  static constexpr auto grad_sum = ntxent_grad_bf16_sum_kernel;
};

int lse_setup(int m, int n2, LsePlan& plan) {
  return lse_plan<LSE_TILE>(
      reinterpret_cast<const void*>(Kernels<float>::lse_vec),
      reinterpret_cast<const void*>(Kernels<float>::lse_scalar), m, n2, plan);
}

// Plans a bf16 lse launch (gram_lse_bf16.cuh): m batches, m channels.
int lse_setup_bf16(int m, int n2, int d, lse16::Plan& plan) {
  return lse16::plan<false, LSE16_WR, LSE16_WC, LSE16_DEPTH>(
      reinterpret_cast<const void*>(Kernels<__nv_bfloat16>::lse_kernel), m, m,
      m, n2, d, plan);
}

// Lets the kernels take all the shared memory a block may opt in to on the
// current device, and writes that to *optin_out if it is not null.
int opt_in(const void* const* kernels, int n, int* optin_out = nullptr) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  for (int i = 0; i < n && err == cudaSuccess; ++i)
    err = cudaFuncSetAttribute(kernels[i],
                               cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (optin_out) *optin_out = optin;
  return static_cast<int>(err);
}

// Plans an fp32 gradient launch (gram_grad.cuh): the main-path body where
// its accumulator holds d (grad_fits), else the wide body.
int ntxent_plan(int m, int n2, int d, GradPlan& plan) {
  const void* kernels[] = {
      reinterpret_cast<const void*>(Kernels<float>::grad_vec),
      reinterpret_cast<const void*>(Kernels<float>::grad_scalar)};
  int optin = 0;
  const int err = opt_in(kernels, 2, &optin);
  if (err) return err;
  if (grad_fits(1, d, optin))
    return grad_plan<false>(kernels[0], m, 1, n2, d, plan);
  const void* wide[] = {
      reinterpret_cast<const void*>(Kernels<float>::wide_vec),
      reinterpret_cast<const void*>(Kernels<float>::wide_scalar)};
  return wide_plan<false>(wide, 2, m, n2, d, plan);
}

// Plans a bf16 gradient launch (gram_grad_bf16.cuh).
int ntxent_plan_bf16(int m, int n2, int d, grad16::Plan& plan) {
  const void* kernel = reinterpret_cast<const void*>(Kernels<__nv_bfloat16>::grad_kernel);
  const int err = opt_in(&kernel, 1);
  if (err) return err;
  return grad16::plan<false>(kernel, m, n2, d, plan);
}

// 16-byte copies of 4 floats
bool vec_ok(const float* z, int d) {
  return d % 4 == 0 && reinterpret_cast<uintptr_t>(z) % 16 == 0;
}

int check_shape(int m, int n2, int d) {
  return (m <= 0 || n2 <= 0 || n2 % 2 || d <= 0 || m > 65535)
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

int lse_entry(const float* z, const float* v, float* part, float* lse, int m,
              int n2, int d, float inv_tau, void* stream) {
  if (check_shape(m, n2, d)) return static_cast<int>(cudaErrorInvalidValue);
  LsePlan plan;
  int err = lse_setup(m, n2, plan);
  if (err) return err;
  const dim3 grid(plan.pairs, m);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec_ok(z, d))
    Kernels<float>::lse_vec<<<grid, lse::THREADS, plan.bytes, s>>>(
        z, v, part, n2, d, inv_tau);
  else
    Kernels<float>::lse_scalar<<<grid, lse::THREADS, plan.bytes, s>>>(
        z, v, part, n2, d, inv_tau);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const long n = (long)m * n2;
  Kernels<float>::lse_sum<<<
      (int)((n + lse::SUM_THREADS - 1) / lse::SUM_THREADS), lse::SUM_THREADS,
      0, s>>>(part, lse, m, plan.tiles, n2, inv_tau);
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
int lse_entry_bf16(const __nv_bfloat16* z, const float* v, float* part,
                   float* lse, int m, int n2, int d, float inv_tau,
                   void* stream) {
  if (check_shape(m, n2, d)) return static_cast<int>(cudaErrorInvalidValue);
  lse16::Plan plan;
  int err = lse_setup_bf16(m, n2, d, plan);
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // rows of 16-byte multiples: z itself, or its padded copy
  const int ld = grad16::z_stride(d);
  if (ld != d) {
    __nv_bfloat16* zp = reinterpret_cast<__nv_bfloat16*>(part + plan.pad_at);
    ntxent_lse_bf16_pad_kernel<<<1024, REDUCE_THREADS, 0, s>>>(
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
                                       s>>>(map, v, part, m, n2, d, inv_tau);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const long n = (long)m * n2;
  Kernels<__nv_bfloat16>::lse_sum<<<
      (int)((n + lse::SUM_THREADS - 1) / lse::SUM_THREADS), lse::SUM_THREADS,
      0, s>>>(part, lse, m, plan.tiles, n2, inv_tau);
  return static_cast<int>(cudaGetLastError());
}

long grad_plan_entry(int m, int n2, int d, int* out) {
  if (check_shape(m, n2, d)) return -static_cast<long>(cudaErrorInvalidValue);
  GradPlan plan;
  const int err = ntxent_plan(m, n2, d, plan);
  if (err) return -static_cast<long>(err);
  if (out) report_plan(plan, out);
  return static_cast<long>(plan.scratch);
}

int grad_entry(const float* z, const float* lse, const float* coef,
               const float* v, float* dz, float* part, int m, int n2, int d,
               float inv_tau, void* stream) {
  if (check_shape(m, n2, d)) return static_cast<int>(cudaErrorInvalidValue);
  GradPlan plan;
  int err = ntxent_plan(m, n2, d, plan);
  if (err) return err;
  const int nb = (n2 + grad::ROWS - 1) / grad::ROWS;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = vec_ok(z, d);
  if (plan.wide) {
    // clusters of a row block's q depth slices of one batch and group
    WideLaunch l(dim3(nb, m * plan.q * plan.groups, plan.splits), plan.q,
                 plan.bytes, s);
    err = static_cast<int>(cudaLaunchKernelEx(
        &l.cfg, vec ? Kernels<float>::wide_vec : Kernels<float>::wide_scalar,
        z, lse, coef, v, dz, part, m, plan.q, plan.groups, n2, d, inv_tau,
        plan.depth));
    if (!err) err = static_cast<int>(cudaGetLastError());
  } else {
    const dim3 grid(nb, m, plan.splits);
    if (vec)
      Kernels<float>::grad_vec<<<grid, grad::THREADS, plan.bytes, s>>>(
          z, lse, coef, v, dz, part, m, n2, d, inv_tau, plan.depth);
    else
      Kernels<float>::grad_scalar<<<grid, grad::THREADS, plan.bytes, s>>>(
          z, lse, coef, v, dz, part, m, n2, d, inv_tau, plan.depth);
    err = static_cast<int>(cudaGetLastError());
  }
  if (err || plan.splits == 1) return err;
  if (plan.wide)
    Kernels<float>::wide_sum<<<1024, REDUCE_THREADS, 0, s>>>(
        dz, part, (size_t)m * n2 * d, plan.splits - 1);
  else
    Kernels<float>::grad_sum<<<1024, REDUCE_THREADS, 0, s>>>(
        dz, part, (size_t)m * n2 * d, plan.splits - 1);
  return static_cast<int>(cudaGetLastError());
}

long grad_plan_entry_bf16(int m, int n2, int d, int* out) {
  if (check_shape(m, n2, d)) return -static_cast<long>(cudaErrorInvalidValue);
  grad16::Plan plan;
  const int err = ntxent_plan_bf16(m, n2, d, plan);
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

int grad_entry_bf16(const __nv_bfloat16* z, const float* lse,
                    const float* coef, const float* v, float* dz, float* part,
                    int m, int n2, int d, float inv_tau, void* stream) {
  if (check_shape(m, n2, d)) return static_cast<int>(cudaErrorInvalidValue);
  grad16::Plan plan;
  int err = ntxent_plan_bf16(m, n2, d, plan);
  if (err) return err;
  const dim3 grid((n2 + grad16::ROWS - 1) / grad16::ROWS, m * plan.chunks,
                  plan.splits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // rows of 16-byte multiples: z itself, or its padded copy
  const int ld = grad16::z_stride(d);
  if (ld != d) {
    __nv_bfloat16* zp = reinterpret_cast<__nv_bfloat16*>(part + plan.pad_at);
    grad16::ntxent_grad_bf16_pad_kernel<<<1024, REDUCE_THREADS, 0, s>>>(
        z, zp, (size_t)m * n2, d, ld);
    err = static_cast<int>(cudaGetLastError());
    if (err) return err;
    z = zp;
  }
  // 2, 4 or 8 chunks: a cluster of a row block's chunk blocks
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(grad16::THREADS);
  cfg.dynamicSmemBytes = plan.bytes;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = plan.cluster;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = static_cast<int>(cudaLaunchKernelEx(
      &cfg, Kernels<__nv_bfloat16>::grad_kernel, z, lse, coef, v, dz, part, m,
      plan.chunks, n2, d, inv_tau, plan.depth, ld));
  if (err) return err;
  err = static_cast<int>(cudaGetLastError());
  if (err || plan.splits == 1) return err;
  Kernels<__nv_bfloat16>::grad_sum<<<1024, REDUCE_THREADS, 0, s>>>(
      dz, part, (size_t)m * n2 * d, plan.splits - 1);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* snag_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// How ntxent_lse runs at this shape on the current device: returns the
// floats of scratch it needs (the row partials of every tile pair), or a
// negative CUDA error; if out is not null, writes {tile, tile pairs,
// blocks per SM} to it.
long ntxent_lse_plan(int m, int n2, int d, int* out) {
  return lse_plan_entry(m, n2, d, out);
}

// z (m, n2, d) with unit rows, v (n2,) 0/1 column validity; writes lse
// (m, n2) in full, using part (ntxent_lse_plan floats) as scratch.
int ntxent_lse(const float* z, const float* v, float* part, float* lse, int m,
               int n2, int d, float inv_tau, void* stream) {
  return lse_entry(z, v, part, lse, m, n2, d, inv_tau, stream);
}

// How ntxent_grad runs at this shape on the current device: returns the
// floats of scratch it needs (the dz partials of the column splits past the
// first), or a negative CUDA error; if out is not null, writes {feature
// chunks, ring depth, column splits, blocks per SM, wide, blocks a
// cluster, cluster groups, depth slices} to it (gram_grad.cuh GradPlan):
// wide 0 on the main-path body, 1 past its accumulator on the wide body
// (ntxent_grad_wide_kernel, clusters of q depth slices, `groups` clusters
// of feature chunks a batch and row block).
long ntxent_grad_plan(int m, int n2, int d, int* out) {
  return grad_plan_entry(m, n2, d, out);
}

// z (m, n2, d), lse and coef (m, n2), v (n2,); writes dz (m, n2, d) in
// full, using part (ntxent_grad_plan floats) as scratch, on the body
// ntxent_grad_plan names.
int ntxent_grad(const float* z, const float* lse, const float* coef,
                const float* v, float* dz, float* part, int m, int n2, int d,
                float inv_tau, void* stream) {
  return grad_entry(z, lse, coef, v, dz, part, m, n2, d, inv_tau, stream);
}

// The same four on bf16 z; lse, coef, v, dz and the scratch stay fp32.
// The bf16 lse's plan (gram_lse_bf16.cuh): {tile, tile pairs, blocks per
// SM, persistent blocks, ring slots, features a slot, warps a block} to
// out; its scratch also holds z's padded copy where d % 8 != 0.
long ntxent_lse_bf16_plan(int m, int n2, int d, int* out) {
  return lse_plan_entry_bf16(m, n2, d, out);
}

// z 16-byte aligned
int ntxent_lse_bf16(const __nv_bfloat16* z, const float* v, float* part,
                    float* lse, int m, int n2, int d, float inv_tau,
                    void* stream) {
  return lse_entry_bf16(z, v, part, lse, m, n2, d, inv_tau, stream);
}

// The bf16 gradient's plan (gram_grad_bf16.cuh): {feature chunks, ring
// depth, column splits, blocks per SM, rows per block, rows resident,
// blocks a cluster} to out.
long ntxent_grad_bf16_plan(int m, int n2, int d, int* out) {
  return grad_plan_entry_bf16(m, n2, d, out);
}

int ntxent_grad_bf16(const __nv_bfloat16* z, const float* lse,
                     const float* coef, const float* v, float* dz, float* part,
                     int m, int n2, int d, float inv_tau, void* stream) {
  return grad_entry_bf16(z, lse, coef, v, dz, part, m, n2, d, inv_tau,
                         stream);
}

}  // extern "C"
