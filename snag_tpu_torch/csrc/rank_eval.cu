// Streaming full-rank evaluation for Hopper, f32: two sweeps over the
// virtual (N, N) squared-L2 distance matrix, neither of which writes it.
//
// Replaces snag_tpu/ops/pallas/rank_eval.py::_run_topk_mean (sweep A,
// kernel _topk_mean_kernel) and ::_run_ranks (sweep B, kernel _rank_kernel).
//
//   sweep A, per query row i: a running top-k (k <= MAX_K) of
//     s = 1 - max(|x_i|^2 + |y_j|^2 - 2 x_i.y_j, 0) over j < n, its mean
//     (the CSLS neighbourhood term), and the raw diagonal distance d_ii;
//   sweep B, per query row i: recompute every distance, optionally apply
//     CSLS as 1 - ((2s - r_row) - r_col), and count
//     #{dist < d_true, j != i} and #{dist == d_true, j < i} (stable-sort
//     rank semantics), plus an optional running top-3 of column ids with
//     ties going to the lowest id.
//
// What bounds it on the H100: arithmetic.  One sweep is 2*N^2*d flops
// (2.6e11 at N = 10,500, d = 1200) and the slice runs four, against
// O(N*d) bytes read per block from L2.  TF32 and tensor cores would
// change ranks, so this first version is a plain fp32 SIMT tile product
// (tile_dot.cuh): each block owns BM query rows and
// walks every column tile, staging (BM x BK) and (BN x BK) slices in shared
// memory, two stages deep (the next slice is fetched into registers while
// the current one is multiplied).  Each thread holds a TM x TN register
// tile and the per-row state (top-k lists, counts, top-3) for its TM
// rows, merged across the row's 16 threads with warp shuffles at the end.
// The ragged edge is masked in-kernel; N is not padded.
//
// Rank exactness: both sweeps compute every distance through the same
// tile_dot/sq_dist code, one fmaf per k in ascending k, and sweep B
// derives d_true in-kernel from sweep A's diagonal with the same
// csls_dist.  The gold column's distance in sweep B is therefore
// bit-identical to d_true, so the gold cannot beat or tie itself.  The
// epilogue uses __f*_rn intrinsics so no contraction reorders it.

#include <cuda_runtime.h>
#include <math.h>
#include <limits.h>
#include <stdint.h>

#include "tile_dot.cuh"

namespace {

constexpr int MAX_K = 10;

// max(|x|^2 + |y|^2 - 2 x.y, 0) in the op order of
// snag_tpu/eval/ranking.py::pairwise_distances.
__device__ __forceinline__ float sq_dist(float xn, float yn, float dot) {
  return fmaxf(__fsub_rn(__fadd_rn(xn, yn), __fmul_rn(2.0f, dot)), 0.0f);
}

// CSLS distance 1 - ((2s - r_row) - r_col) with s = 1 - dist, in the exact
// op order of snag_tpu/eval/ranking.py::csls_sim.
__device__ __forceinline__ float csls_dist(float dist, float r_row, float r_col) {
  const float s = __fsub_rn(1.0f, dist);
  return __fsub_rn(1.0f, __fsub_rn(__fsub_rn(__fmul_rn(2.0f, s), r_row), r_col));
}

// Keep v[] as the MAX_K largest values seen, descending.
__device__ __forceinline__ void insert_topk(float (&v)[MAX_K], float x) {
  if (!(x > v[MAX_K - 1])) return;
#pragma unroll
  for (int q = 0; q < MAX_K; ++q) {
    if (x > v[q]) {
      const float t = v[q];
      v[q] = x;
      x = t;
    }
  }
}

// Larger value first; among equal values the lower column id.
__device__ __forceinline__ bool better(float v, int i, float w, int j) {
  return v > w || (v == w && i < j);
}

__device__ __forceinline__ void insert_top3(float (&v)[3], int (&id)[3],
                                            float x, int xi) {
  if (!better(x, xi, v[2], id[2])) return;
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    if (better(x, xi, v[q], id[q])) {
      const float t = v[q];
      const int ti = id[q];
      v[q] = x;
      id[q] = xi;
      x = t;
      xi = ti;
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
topk_mean_kernel(const float* __restrict__ x, const float* __restrict__ y,
                 const float* __restrict__ xn, const float* __restrict__ yn,
                 float* __restrict__ mean, float* __restrict__ diag, int n,
                 int d, int k) {
  __shared__ __align__(16) Smem sm;
  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
  const int row0 = blockIdx.x * BM;

  float xr[TM];
  float top[TM][MAX_K];
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int gr = row0 + ty * TM + r;
    xr[r] = gr < n ? xn[gr] : 0.f;
#pragma unroll
    for (int q = 0; q < MAX_K; ++q) top[r][q] = -INFINITY;
  }

  for (int col0 = 0; col0 < n; col0 += BN) {
    float acc[TM][TN];
    tile_dot<VEC>(x, y, n, d, row0, col0, sm, acc);
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      const int gc = col0 + tile_col(tx, c);
      if (gc >= n) continue;
      const float yc = yn[gc];
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        const int gr = row0 + ty * TM + r;
        const float dist = sq_dist(xr[r], yc, acc[r][c]);
        insert_topk(top[r], __fsub_rn(1.0f, dist));
        if (gr == gc) diag[gr] = dist;
      }
    }
  }

  // merge the row's TX partial lists (lanes of one half-warp)
#pragma unroll
  for (int off = TX / 2; off >= 1; off >>= 1) {
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      float theirs[MAX_K];
#pragma unroll
      for (int q = 0; q < MAX_K; ++q)
        theirs[q] = __shfl_xor_sync(0xffffffffu, top[r][q], off);
#pragma unroll
      for (int q = 0; q < MAX_K; ++q) insert_topk(top[r], theirs[q]);
    }
  }

  if (tx == 0) {
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const int gr = row0 + ty * TM + r;
      if (gr >= n) continue;
      float sum = 0.f;
#pragma unroll
      for (int q = 0; q < MAX_K; ++q)
        if (q < k) sum = __fadd_rn(sum, top[r][q]);
      mean[gr] = __fdiv_rn(sum, (float)k);
    }
  }
}

template <bool VEC, bool CSLS, bool TOP3>
__global__ void __launch_bounds__(THREADS)
ranks_kernel(const float* __restrict__ x, const float* __restrict__ y,
             const float* __restrict__ xn, const float* __restrict__ yn,
             const float* __restrict__ rl, const float* __restrict__ rr,
             const float* __restrict__ diag, int* __restrict__ counts,
             int* __restrict__ top3, int n, int d) {
  __shared__ __align__(16) Smem sm;
  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
  const int row0 = blockIdx.x * BM;

  float xr[TM], rrow[TM], dtrue[TM];
  int smaller[TM], tied[TM];
  float tv[TM][3];
  int ti[TM][3];
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int gr = row0 + ty * TM + r;
    const bool ok = gr < n;
    xr[r] = ok ? xn[gr] : 0.f;
    rrow[r] = (CSLS && ok) ? rl[gr] : 0.f;
    dtrue[r] = ok ? (CSLS ? csls_dist(diag[gr], rl[gr], rr[gr]) : diag[gr]) : 0.f;
    smaller[r] = 0;
    tied[r] = 0;
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      tv[r][q] = -INFINITY;
      ti[r][q] = INT_MAX;
    }
  }

  for (int col0 = 0; col0 < n; col0 += BN) {
    float acc[TM][TN];
    tile_dot<VEC>(x, y, n, d, row0, col0, sm, acc);
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      const int gc = col0 + tile_col(tx, c);
      if (gc >= n) continue;
      const float yc = yn[gc];
      const float rcol = CSLS ? rr[gc] : 0.f;
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        const int gr = row0 + ty * TM + r;
        const float dm = sq_dist(xr[r], yc, acc[r][c]);
        const float dist = CSLS ? csls_dist(dm, rrow[r], rcol) : dm;
        smaller[r] += (gc != gr && dist < dtrue[r]) ? 1 : 0;
        tied[r] += (gc < gr && dist == dtrue[r]) ? 1 : 0;
        if (TOP3) insert_top3(tv[r], ti[r], -dist, gc);
      }
    }
  }

#pragma unroll
  for (int off = TX / 2; off >= 1; off >>= 1) {
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      smaller[r] += __shfl_xor_sync(0xffffffffu, smaller[r], off);
      tied[r] += __shfl_xor_sync(0xffffffffu, tied[r], off);
      if (TOP3) {
        float ov[3];
        int oi[3];
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          ov[q] = __shfl_xor_sync(0xffffffffu, tv[r][q], off);
          oi[q] = __shfl_xor_sync(0xffffffffu, ti[r][q], off);
        }
#pragma unroll
        for (int q = 0; q < 3; ++q) insert_top3(tv[r], ti[r], ov[q], oi[q]);
      }
    }
  }

  if (tx == 0) {
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const int gr = row0 + ty * TM + r;
      if (gr >= n) continue;
      counts[(size_t)gr * 2] = smaller[r];
      counts[(size_t)gr * 2 + 1] = tied[r];
      if (TOP3) {
#pragma unroll
        for (int q = 0; q < 3; ++q) top3[(size_t)gr * 3 + q] = ti[r][q];
      }
    }
  }
}

// float4 loads need 16-byte aligned rows
bool vec_ok(const float* x, const float* y, int d) {
  return d % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(y) % 16 == 0;
}

template <bool CSLS, bool TOP3>
void launch_ranks(bool vec, int blocks, cudaStream_t s, const float* x,
                  const float* y, const float* xn, const float* yn,
                  const float* rl, const float* rr, const float* diag,
                  int* counts, int* top3, int n, int d) {
  if (vec)
    ranks_kernel<true, CSLS, TOP3><<<blocks, THREADS, 0, s>>>(
        x, y, xn, yn, rl, rr, diag, counts, top3, n, d);
  else
    ranks_kernel<false, CSLS, TOP3><<<blocks, THREADS, 0, s>>>(
        x, y, xn, yn, rl, rr, diag, counts, top3, n, d);
}

int check_shape(int n, int d) {
  return (n <= 0 || d <= 0) ? static_cast<int>(cudaErrorInvalidValue) : 0;
}

}  // namespace

extern "C" {

const char* snag_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Sweep A.  x, y (n, d); xn, yn (n,) squared row norms; writes mean (n,)
// and diag (n,) in full.
int rank_topk_mean(const float* x, const float* y, const float* xn,
                   const float* yn, float* mean, float* diag, int n, int d,
                   int k, void* stream) {
  if (check_shape(n, d) || k < 1 || k > MAX_K || k > n)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n + BM - 1) / BM;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec_ok(x, y, d))
    topk_mean_kernel<true><<<blocks, THREADS, 0, s>>>(x, y, xn, yn, mean, diag, n, d, k);
  else
    topk_mean_kernel<false><<<blocks, THREADS, 0, s>>>(x, y, xn, yn, mean, diag, n, d, k);
  return static_cast<int>(cudaGetLastError());
}

// Sweep B.  rl, rr (n,) CSLS terms (read only when use_csls); diag (n,)
// from sweep A of the same direction; writes counts (n, 2) and, when
// with_top3, top3 (n, 3).
int rank_counts(const float* x, const float* y, const float* xn,
                const float* yn, const float* rl, const float* rr,
                const float* diag, int* counts, int* top3, int n, int d,
                int use_csls, int with_top3, void* stream) {
  if (check_shape(n, d) || (with_top3 && n < 3))
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n + BM - 1) / BM;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = vec_ok(x, y, d);
  if (use_csls) {
    if (with_top3) launch_ranks<true, true>(vec, blocks, s, x, y, xn, yn, rl, rr, diag, counts, top3, n, d);
    else launch_ranks<true, false>(vec, blocks, s, x, y, xn, yn, rl, rr, diag, counts, top3, n, d);
  } else {
    if (with_top3) launch_ranks<false, true>(vec, blocks, s, x, y, xn, yn, rl, rr, diag, counts, top3, n, d);
    else launch_ranks<false, false>(vec, blocks, s, x, y, xn, yn, rl, rr, diag, counts, top3, n, d);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
