// The row-logsumexp of Gram channels K_m = z_m z_m^T on fp32 z, shared by
// the mixture lse (snag_loss.cu, MIX = true) and the NT-Xent lse
// (ntxent.cu, MIX = false); bf16 z has its own kernel, gram_lse_bf16.cuh,
// which takes tile_pair and sum_partials from here.  z is (M, n2, d) with
// unit rows and v (n2,) marks valid columns.  NT-Xent: one channel per
// batch, K_m.  Mixture: the M channels K_m, then mix_a = sum_m alpha[r,m]
// alpha[c,m] K_m and mix_f = sum_m beta[m] K_m.  With the static max
// 1/tau (|channel| <= 1 for unit rows):
//     lse[ch, r] = log(sum_{c != r} v[c] exp(channel[r, c] / tau - 1/tau)
//                      + 1e-30) + 1/tau.
//
// Every channel is symmetric in (r, c), so each of its elements is computed
// once.  The n2 rows are cut into tiles of T; a block takes one unordered
// pair of row tiles (I <= J), enumerated linearly from blockIdx.x, of one
// batch (blockIdx.y, NT-Xent) or of every modality (MIX, which walks m =
// 0 .. M-1 over the same pair and then adds the two mixture channels).
// Each exp e(r, c) adds e v[c] to row r's sum and, when I < J, e v[r] to
// row c's; the diagonal pair adds row sums only, c != r.
//
// K runs on the tensor cores in 3xTF32 (tile_mma.cuh), each operand split
// into hi / lo once per fragment load; each k8 step starts from zero and is
// added in fp32, because the tensor cores truncate when they accumulate.
// Eight warps cover the (T x T) tile as 2 x 4 warp tiles of (T/2 x T/4);
// operands come from z's rows by 16-byte cp.async into a ring of DEPTH
// slots, KD deep (rows >= n2 and depth >= d read as 0).
//
// No float atomics: block (I, J) writes its row partials of channel ch to
// part[ch][J][rows of I] and, when I < J, its column partials to
// part[ch][I][rows of J], so each slot is written exactly once; the sum
// kernel then adds a row's partials over t ascending.  Two runs give the
// same bits.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tile_mma.cuh"

namespace {
namespace lse {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int WR = 2, WC = 4;              // the warp grid over the tile
constexpr int KD = 16;                     // depth of one ring slot
// fragments take k slots t and t + 4 from elements 2t and 2t + 1 of each
// k8 slice (tile_mma.cuh), one 64-bit load; 24 = 24 mod 32 keeps a
// half-warp's loads on distinct banks
constexpr int KD_STRIDE = KD + 8;
constexpr int DEPTH = 4;                   // slots in the cp.async ring
constexpr int SUM_THREADS = 256;
constexpr float EPS = 1e-30f;

// a block's shared memory: the ring (rows of I, then of J) and the row and
// column partials of its warps
template <int T>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)DEPTH * 2 * T * KD_STRIDE + (WC + WR) * T);
}

// The unordered tile pair (I <= J) of linear index p over the upper
// triangle of an n x n grid, row by row: p = first(I) + J - I with
// first(i) = i n - i (i - 1) / 2.
__device__ __forceinline__ void tile_pair(int p, int n, int& I, int& J) {
  auto first = [n](int i) { return i * n - i * (i - 1) / 2; };
  const float b = 2.f * n + 1.f;
  int i = static_cast<int>(0.5f * (b - sqrtf(fmaxf(b * b - 8.f * p, 0.f))));
  i = max(0, min(i, n - 1));
  while (i > 0 && first(i) > p) --i;
  while (i + 1 < n && first(i + 1) <= p) ++i;
  I = i;
  J = i + p - first(i);
}

// One ring slot: rows [row0, row0 + T) of zm into buf[0 .. T) and rows
// [col0, col0 + T) into buf[T .. 2T), depth [k0, k0 + KD).
template <bool VEC, int T>
__device__ __forceinline__ void load_slice(const float* __restrict__ zm,
                                           int n2, int d, int row0, int col0,
                                           int k0, float* buf) {
  if (VEC) {
    static_assert(2 * T * KD / 4 % THREADS == 0, "a slot's 16-byte copies");
#pragma unroll
    for (int q = 0; q < 2 * T * KD / 4 / THREADS; ++q) {
      const int i = threadIdx.x + q * THREADS;
      const int r = i / (KD / 4), k = (i % (KD / 4)) * 4;
      const int gr = r < T ? row0 + r : col0 + r - T;
      const bool ok = gr < n2 && k0 + k < d;
      cp_async16(buf + r * KD_STRIDE + k, ok ? zm + (size_t)gr * d + k0 + k : zm,
                 ok);
    }
  } else {
    for (int i = threadIdx.x; i < 2 * T * KD; i += THREADS) {
      const int r = i / KD, k = i % KD;
      const int gr = r < T ? row0 + r : col0 + r - T;
      const bool ok = gr < n2 && k0 + k < d;
      cp_async4(buf + r * KD_STRIDE + k, ok ? zm + (size_t)gr * d + k0 + k : zm,
                ok);
    }
  }
}

// acc += this warp's (T/2 x T/4) tile of the staged slice, in 3xTF32.
template <int T, int MT, int NT>
__device__ __forceinline__ void k_step(const float* buf,
                                       float (&acc)[MT][NT][4]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const float* ar = buf + ((warp % WR) * (T / WR) + g) * KD_STRIDE + 2 * t;
  const float* br = buf + (T + (warp / WR) * (T / WC) + g) * KD_STRIDE + 2 * t;
#pragma unroll
  for (int kk = 0; kk < KD; kk += 8) {
    uint32_t b_hi[NT][2], b_lo[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float2 b = *reinterpret_cast<const float2*>(br + j * 8 * KD_STRIDE + kk);
      split_tf32(b.x, b_hi[j][0], b_lo[j][0]);
      split_tf32(b.y, b_hi[j][1], b_lo[j][1]);
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const float* a = ar + i * 16 * KD_STRIDE + kk;
      const float2 a0 = *reinterpret_cast<const float2*>(a);
      const float2 a1 = *reinterpret_cast<const float2*>(a + 8 * KD_STRIDE);
      uint32_t a_hi[4], a_lo[4];
      split_tf32(a0.x, a_hi[0], a_lo[0]);
      split_tf32(a1.x, a_hi[1], a_lo[1]);
      split_tf32(a0.y, a_hi[2], a_lo[2]);
      split_tf32(a1.y, a_hi[3], a_lo[3]);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        float p[4] = {0.f, 0.f, 0.f, 0.f};
        mma_tf32x3(p, a_hi, a_lo, b_hi[j], b_lo[j]);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += p[e];
      }
    }
  }
}

// The row (in the block's tile) of half h of m16 tile i of this thread's
// C fragments, and the column of element c of n8 tile j: element e of
// fragment (i, j) sits at (frag_row(i, e / 2), frag_col(j, e % 2)).
template <int T>
__device__ __forceinline__ int frag_row(int i, int h) {
  return (threadIdx.x / 32 % WR) * (T / WR) + i * 16 + threadIdx.x % 32 / 4 +
         8 * h;
}

template <int T>
__device__ __forceinline__ int frag_col(int j, int c) {
  return (threadIdx.x / 32 / WR) * (T / WC) + j * 8 + 2 * (threadIdx.x % 4) + c;
}

// One channel x (the C fragments of the tile, rows v_row[0 .. nr) and
// columns v_col[0 .. nc) valid): the exps' row sums into part_row[0 .. nr)
// and, off the diagonal, their column sums into part_col[0 .. nc).  A
// row's sum adds its 4 lanes, then its WC warps in order; a column's its 8
// lanes, then its WR warps.  Reuses red_r / red_c between two barriers.
template <int T, int MT, int NT>
__device__ __forceinline__ void channel_sums(
    const float (&x)[MT][NT][4], const float* __restrict__ v_row, int nr,
    const float* __restrict__ v_col, int nc, bool diag, float inv_tau,
    float* red_r, float* red_c, float* __restrict__ part_row,
    float* __restrict__ part_col) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  float vr[MT][2], vc[NT][2], rs[MT][2], cs[NT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = frag_row<T>(i, h);
      vr[i][h] = r < nr ? v_row[r] : 0.f;
      rs[i][h] = 0.f;
    }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int col = frag_col<T>(j, c);
      vc[j][c] = col < nc ? v_col[col] : 0.f;
      cs[j][c] = 0.f;
    }
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2, c = e % 2;
        float ex = expf(x[i][j][e] * inv_tau - inv_tau);
        if (diag && frag_row<T>(i, h) == frag_col<T>(j, c)) ex = 0.f;
        rs[i][h] += ex * vc[j][c];
        cs[j][c] += ex * vr[i][h];
      }
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float s = rs[i][h];
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      if (t == 0) red_r[(warp / WR) * T + frag_row<T>(i, h)] = s;
    }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      float s = cs[j][c];
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      s += __shfl_xor_sync(0xffffffffu, s, 8);
      s += __shfl_xor_sync(0xffffffffu, s, 16);
      if (g == 0) red_c[(warp % WR) * T + frag_col<T>(j, c)] = s;
    }
  __syncthreads();
  for (int k = threadIdx.x; k < 2 * T; k += THREADS) {
    if (k < T) {
      if (k < nr) {
        float s = red_r[k];
#pragma unroll
        for (int w = 1; w < WC; ++w) s += red_r[w * T + k];
        part_row[k] = s;
      }
    } else if (!diag && k - T < nc) {
      float s = red_c[k - T];
#pragma unroll
      for (int w = 1; w < WR; ++w) s += red_c[w * T + k - T];
      part_col[k - T] = s;
    }
  }
  __syncthreads();
}

// The kernel's body.  part is (channels, tiles, n2): NT-Xent's channels
// are its batches (blockIdx.y), the mixture's are [K_0 .. K_{nm-1} | mix_a
// | mix_f].  !MIX: alpha and beta unused, nm = 1.
template <bool MIX, bool VEC, int T>
__device__ __forceinline__ void gram_lse(
    const float* __restrict__ z, const float* __restrict__ alpha,
    const float* __restrict__ beta, const float* __restrict__ v,
    float* __restrict__ part, int nm, int n2, int d, float inv_tau) {
  constexpr int MT = T / (16 * WR);     // m16 tiles of a warp
  constexpr int NT = T / (8 * WC);      // n8 tiles of a warp
  constexpr int SLOT = 2 * T * KD_STRIDE;
  static_assert(MT * 16 * WR == T && NT * 8 * WC == T, "T % 32 != 0");
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;
  float* red_r = ring + DEPTH * SLOT;   // [WC][T]
  float* red_c = red_r + WC * T;        // [WR][T]

  const int tiles = (n2 + T - 1) / T;
  int ti, tj;
  tile_pair(blockIdx.x, tiles, ti, tj);
  const bool diag = ti == tj;
  const int row0 = ti * T, col0 = tj * T;
  const int nr = min(T, n2 - row0), nc = min(T, n2 - col0);
  const int batch = MIX ? 0 : blockIdx.y;
  const int nk = MIX ? nm : 1;
  const int ks = (d + KD - 1) / KD;
  const int steps = nk * ks;

  // the ring: step q (modality q / ks, depth slice q % ks) sits in slot
  // q % DEPTH, loaded DEPTH - 1 steps ahead of its compute
  static_assert((DEPTH & (DEPTH - 1)) == 0, "DEPTH is a power of two");
  auto issue = [&](int q) {
    if (q < steps) {
      const int m = q / ks;
      load_slice<VEC, T>(z + (size_t)(MIX ? m : batch) * n2 * d, n2, d, row0,
                         col0, (q - m * ks) * KD,
                         ring + (q & (DEPTH - 1)) * SLOT);
    }
    cp_async_commit();
  };
  // waits for step q's slot; every thread is done with step q - 1's, whose
  // slot takes step q + DEPTH - 1
  auto next = [&](int q) -> const float* {
    cp_async_wait<DEPTH - 2>();
    __syncthreads();
    issue(q + DEPTH - 1);
    return ring + (q & (DEPTH - 1)) * SLOT;
  };
#pragma unroll
  for (int q = 0; q < DEPTH - 1; ++q) issue(q);

  auto write = [&](const float (&x)[MT][NT][4], int ch) {
    float* p = part + (size_t)ch * tiles * n2;
    channel_sums<T>(x, v + row0, nr, v + col0, nc, diag, inv_tau, red_r,
                    red_c, p + (size_t)tj * n2 + row0,
                    p + (size_t)ti * n2 + col0);
  };

  float mix_a[MT][NT][4], mix_f[MT][NT][4];   // (unused by NT-Xent)
  if (MIX) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mix_a[i][j][e] = mix_f[i][j][e] = 0.f;
  }
  for (int m = 0; m < nk; ++m) {
    float acc[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    for (int s = 0; s < ks; ++s) k_step<T>(next(m * ks + s), acc);
    write(acc, MIX ? m : batch);
    if (MIX) {
      const float bm = beta[m];
      float ar[MT][2], ac[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = frag_row<T>(i, h);
          ar[i][h] = r < nr ? alpha[(size_t)(row0 + r) * nm + m] : 0.f;
        }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = frag_col<T>(j, c);
          ac[j][c] = col < nc ? alpha[(size_t)(col0 + col) * nm + m] : 0.f;
        }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float k = acc[i][j][e];
            mix_a[i][j][e] = fmaf(ar[i][e / 2] * ac[j][e % 2], k, mix_a[i][j][e]);
            mix_f[i][j][e] = fmaf(bm, k, mix_f[i][j][e]);
          }
    }
  }
  if (MIX) {
    write(mix_a, nm);
    write(mix_f, nm + 1);
  }
  cp_async_wait<0>();
}

// lse[ch, r] = log(sum_t part[ch, t, r] + 1e-30) + 1/tau, t ascending, for
// the channels x n2 outputs (a grid-stride loop of SUM_THREADS blocks).
__device__ __forceinline__ void sum_partials(const float* __restrict__ part,
                                             float* __restrict__ lse,
                                             int channels, int tiles, int n2,
                                             float inv_tau) {
  const size_t n = (size_t)channels * n2;
  for (size_t i = (size_t)blockIdx.x * SUM_THREADS + threadIdx.x; i < n;
       i += (size_t)gridDim.x * SUM_THREADS) {
    const size_t ch = i / n2, r = i % n2;
    const float* p = part + ch * tiles * n2 + r;
    float s = 0.f;
    for (int t = 0; t < tiles; ++t) s += p[(size_t)t * n2];
    lse[i] = logf(s + EPS) + inv_tau;
  }
}

}  // namespace lse

// How an lse kernel runs at this shape on the current device: its tile,
// the tiles of n2 and their unordered pairs, the blocks an SM holds, the
// dynamic shared memory of a block and the floats of partials (channels x
// tiles x n2).
struct LsePlan {
  int tile, tiles, pairs, per_sm;
  size_t bytes, scratch;
};

// kernel_vec / kernel_scalar: the two instantiations of one lse kernel of
// tile T; lets both take their shared memory and plans a launch.
template <int T>
int lse_plan(const void* kernel_vec, const void* kernel_scalar, int channels,
             int n2, LsePlan& plan) {
  plan.tile = T;
  plan.tiles = (n2 + T - 1) / T;
  // tile_pair's int arithmetic needs tiles^2 < 2^31
  if (plan.tiles > 46340) return static_cast<int>(cudaErrorInvalidConfiguration);
  plan.pairs = plan.tiles * (plan.tiles + 1) / 2;
  plan.bytes = lse::smem_bytes<T>();
  plan.scratch = (size_t)channels * plan.tiles * n2;
  cudaError_t err = cudaFuncSetAttribute(
      kernel_vec, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)plan.bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel_scalar,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)plan.bytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &plan.per_sm, kernel_vec, lse::THREADS, plan.bytes);
  return static_cast<int>(err);
}

}  // namespace
