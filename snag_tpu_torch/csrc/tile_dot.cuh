// The fp32 SIMT tile product of rank_eval.cu: tile_dot (S = x y^T, one
// tile).  Exact ranks need fp32 in a fixed order, so it stays off the
// tensor cores.
//
// A block of THREADS threads owns BM rows and walks column tiles of BN;
// each tile is the (BM x BN) product of row and column slices over the
// depth d, staged through shared memory BK deep and two stages deep (the
// next slice is fetched into registers while the current one is
// multiplied).  Each thread holds a TM x TN register tile: rows
// ty*TM .. ty*TM+3 and columns tile_col(tx, 0..7), two groups of four HALF
// apart so that the float4 reads of shared memory do not conflict.  The
// ragged edge is masked: rows or columns >= n and k >= d read as 0.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 32;       // rows per block
constexpr int BN = 128;      // columns per tile
constexpr int BK = 16;       // depth per shared-memory stage
constexpr int TM = 4;        // rows per thread
constexpr int TN = 8;        // columns per thread: two groups of 4, HALF apart
constexpr int HALF = BN / 2;
constexpr int TX = BN / TN;  // 16 threads share a row group
constexpr int THREADS = (BM / TM) * TX;  // 128
constexpr int PAD = 4;
// per-thread share of one stage: BM*BK and BN*BK floats over THREADS
constexpr int A_PER = BM * BK / THREADS;   // 4
constexpr int B_PER = BN * BK / THREADS;   // 16

struct Smem {
  float a[2][BK][BM + PAD];
  float b[2][BK][BN + PAD];
};

struct Stage {
  float a[A_PER];
  float b[B_PER];
};

// Element e of a thread's share of a (rows x BK) slice: VEC threads take
// 4 consecutive k of one row (one float4 load; needs d % 4 == 0 and
// 16-byte aligned rows), scalar threads one k.
template <bool VEC>
__device__ __forceinline__ void slot(int e, int& r, int& k) {
  if (VEC) {
    const int idx = threadIdx.x + (e / 4) * THREADS;
    r = idx / (BK / 4);
    k = (idx % (BK / 4)) * 4 + e % 4;
  } else {
    const int idx = threadIdx.x + e * THREADS;
    r = idx / BK;
    k = idx % BK;
  }
}

template <bool VEC, int PER>
__device__ __forceinline__ void load_rows(const float* __restrict__ src,
                                          int n, int d, int row0, int k0,
                                          float (&out)[PER]) {
  if (VEC) {
#pragma unroll
    for (int e = 0; e < PER; e += 4) {
      int r, k;
      slot<true>(e, r, k);
      const int gr = row0 + r, gk = k0 + k;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (gr < n && gk < d)
        v = *reinterpret_cast<const float4*>(src + (size_t)gr * d + gk);
      out[e] = v.x;
      out[e + 1] = v.y;
      out[e + 2] = v.z;
      out[e + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      int r, k;
      slot<false>(e, r, k);
      const int gr = row0 + r, gk = k0 + k;
      out[e] = (gr < n && gk < d) ? src[(size_t)gr * d + gk] : 0.f;
    }
  }
}

template <bool VEC>
__device__ __forceinline__ void load_stage(const float* __restrict__ x,
                                           const float* __restrict__ y,
                                           int n, int d, int row0, int col0,
                                           int k0, Stage& st) {
  load_rows<VEC, A_PER>(x, n, d, row0, k0, st.a);
  load_rows<VEC, B_PER>(y, n, d, col0, k0, st.b);
}

template <bool VEC>
__device__ __forceinline__ void store_stage(Smem& sm, int buf,
                                            const Stage& st) {
#pragma unroll
  for (int e = 0; e < A_PER; ++e) {
    int r, k;
    slot<VEC>(e, r, k);
    sm.a[buf][k][r] = st.a[e];
  }
#pragma unroll
  for (int e = 0; e < B_PER; ++e) {
    int r, k;
    slot<VEC>(e, r, k);
    sm.b[buf][k][r] = st.b[e];
  }
}

// Column (within the tile) of a thread's c-th accumulator column.
__device__ __forceinline__ int tile_col(int tx, int c) {
  return (c < 4 ? 0 : HALF - 4) + tx * 4 + c;
}

// acc[r][c] = sum_k x[row0 + ty*TM + r][k] * y[col0 + tile_col(tx, c)][k],
// accumulated with one fmaf per k in ascending k.  Rows/cols >= n and
// k >= d read as 0.  Ends with a barrier.
template <bool VEC>
__device__ __forceinline__ void tile_dot(const float* __restrict__ x,
                                         const float* __restrict__ y, int n,
                                         int d, int row0, int col0, Smem& sm,
                                         float (&acc)[TM][TN]) {
  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int c = 0; c < TN; ++c) acc[r][c] = 0.f;

  Stage st;
  load_stage<VEC>(x, y, n, d, row0, col0, 0, st);
  store_stage<VEC>(sm, 0, st);
  __syncthreads();
  int buf = 0;
  for (int k0 = 0; k0 < d; k0 += BK) {
    const bool more = k0 + BK < d;
    if (more) load_stage<VEC>(x, y, n, d, row0, col0, k0 + BK, st);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a4 = *reinterpret_cast<const float4*>(&sm.a[buf][kk][ty * TM]);
      const float4 b0 = *reinterpret_cast<const float4*>(&sm.b[buf][kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&sm.b[buf][kk][HALF + tx * 4]);
      const float av[TM] = {a4.x, a4.y, a4.z, a4.w};
      const float bv[TN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int c = 0; c < TN; ++c) acc[r][c] = __fmaf_rn(av[r], bv[c], acc[r][c]);
    }
    // the other stage was last read before the previous barrier
    if (more) store_stage<VEC>(sm, buf ^ 1, st);
    __syncthreads();
    buf ^= 1;
  }
}

}  // namespace
