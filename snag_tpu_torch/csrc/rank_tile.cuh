// The fp32 tile product that both rank sweeps of rank_eval.cu run over:
// S = x y^T one (BM x BN) tile at a time, each tile handed to the sweep's
// epilogue and never written out.
//
// What bounds it on the H100: fp32 arithmetic, 2 N^2 d flops a sweep
// (2.6e11 at N = 10,500, d = 1,200) against 67 TFLOP/s.  Exact ranks need
// every dot product in fp32 in one fixed order, so the tensor cores are
// out (3xTF32 would move ranks on near-ties).  The design keeps the FMA
// pipes fed:
//
// - Operands are k-major in shared memory, so the caller passes x and y
//   transposed, xt and yt (d, ld) with ld a multiple of 4 and zeros in
//   the columns n .. ld-1; 16-byte cp.async copies fill a ring of STAGES
//   slices of BK depth, one barrier a slice, and the ring runs on across
//   column tiles, so it never drains at a tile's end.  Columns >= n and
//   depth >= d are filled with zeros by the copy itself.
// - A block of 384 threads owns BM = 96 rows and walks the BN = 256 wide
//   column tiles of one column split; each thread holds a 4 x 16 register
//   tile (64 accumulators): rows ty*4 .. ty*4+3 and four float4 groups of
//   columns a quarter tile apart, so a warp's shared-memory reads of a
//   slice row are 256 contiguous bytes and never conflict.  Per k: 5
//   16-byte shared loads for 64 FMAs.
// - Occupancy is what hides the latencies: the sweeps take 139-167
//   registers a thread without spills, so an SM holds one block, and 12
//   warps (96 rows) ran 13 % faster than 8 (64 rows) on an H100 (NVIDIA
//   H100 80GB HBM3, 700 W); capping registers at 128 for 16 warps spilled
//   and ran slower.
// - Per-row state (the sweep's) grows with the rows a thread owns, not its
//   columns, so the register tile grows in columns.
// - The per-column epilogue operands (yn and, in sweep B, rr and the
//   column's own gold distance) are staged in shared memory once per
//   column tile, read from global memory while the tile's last slice is
//   multiplied.
// - Column splits: several blocks share a row tile, each over a run of
//   whole column tiles, so the grid fills the card's last wave; their
//   per-row partials are merged by a second kernel in split order.
//
// Bit-identity, the invariant that carries exact ranks: every element's dot
// product is acc = __fmaf_rn(x[k], y[k], acc) for k = 0 .. d-1 in ascending
// order, from acc = 0 (zeros past d add +0 and change no bit).  So the
// tiling, the splits and the merge order change no distance.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_mma.cuh"

namespace rank {

constexpr int BM = 96;        // rows per block
constexpr int BN = 256;       // columns per tile
constexpr int BK = 16;        // depth per slice of the ring
constexpr int STAGES = 4;     // slices in the ring
constexpr int TM = 4;         // rows per thread
constexpr int TN = 16;        // columns per thread: four float4 groups
constexpr int GROUP = BN / 4; // the groups are a quarter tile apart
constexpr int TX = 16;        // threads that share a row group
constexpr int THREADS = (BM / TM) * TX;  // 384
constexpr int SLICE = BK * (BM + BN);    // floats of one ring slot
constexpr int COL_VECTORS = 3;           // per-column epilogue operands
// the ring, then the epilogue's per-column operands
constexpr int SMEM_BYTES = (STAGES * SLICE + COL_VECTORS * BN) * 4;

static_assert(GROUP == TX * 4, "a group is one float4 per column thread");
static_assert(THREADS >= BN, "a thread stages each epilogue column");

// Column (within the tile) of a thread's c-th accumulator column.
__device__ __forceinline__ int tile_col(int tx, int c) {
  return (c >> 2) * GROUP + tx * 4 + (c & 3);
}

// The column tiles [t0, t1) of split s of S over ct tiles.
__device__ __forceinline__ void split_tiles(int s, int S, int ct, int& t0,
                                            int& t1) {
  t0 = static_cast<int>(static_cast<long long>(s) * ct / S);
  t1 = static_cast<int>(static_cast<long long>(s + 1) * ct / S);
}

// Copy the slice of COLS columns from c0 of src (d, ld) over depth
// k0 .. k0+BK-1 to dst (BK, COLS), 16 bytes a copy, zeros for columns >= n
// and depth >= d.
template <int COLS>
__device__ __forceinline__ void load_cols(const float* __restrict__ src,
                                          int n, int d, int ld, int c0,
                                          int k0, float* dst) {
  constexpr int COPIES = BK * COLS / 4;
#pragma unroll
  for (int i = 0; i < (COPIES + THREADS - 1) / THREADS; ++i) {
    const int idx = threadIdx.x + i * THREADS;
    if (COPIES % THREADS != 0 && idx >= COPIES) break;
    const int k = idx / (COLS / 4), c = (idx % (COLS / 4)) * 4;
    const bool ok = k0 + k < d && c0 + c < n;
    cp_async16(dst + k * COLS + c,
               ok ? src + (size_t)(k0 + k) * ld + c0 + c : src, ok);
  }
}

// Issue the copies of one slice: x rows row0.. and y columns col0.. over
// depth k0 .. k0+BK-1, into ring slot dst.
__device__ __forceinline__ void load_slice(const float* __restrict__ xt,
                                           const float* __restrict__ yt,
                                           int n, int d, int ld, int row0,
                                           int col0, int k0, float* dst) {
  load_cols<BM>(xt, n, d, ld, row0, k0, dst);
  load_cols<BN>(yt, n, d, ld, col0, k0, dst + BK * BM);
}

// acc[r][c] += x[row][k] y[col][k] over one slice, k ascending.
__device__ __forceinline__ void mul_slice(const float* __restrict__ s,
                                          int tx, int ty,
                                          float (&acc)[TM][TN]) {
  const float* a = s;
  const float* b = s + BK * BM;
#pragma unroll
  for (int kk = 0; kk < BK; ++kk) {
    const float4 a4 = *reinterpret_cast<const float4*>(a + kk * BM + ty * TM);
    float bv[TN];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const float4 b4 =
          *reinterpret_cast<const float4*>(b + kk * BN + g * GROUP + tx * 4);
      bv[4 * g] = b4.x;
      bv[4 * g + 1] = b4.y;
      bv[4 * g + 2] = b4.z;
      bv[4 * g + 3] = b4.w;
    }
    const float av[TM] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int c = 0; c < TN; ++c) acc[r][c] = __fmaf_rn(av[r], bv[c], acc[r][c]);
  }
}

// Walk the column tiles [t0, t1) for the BM rows from row0 and call
// epi(acc, col0, cv) once per tile, where acc is the thread's 4 x 16 tile
// of x y^T and cv (NV x BN floats, shared memory) holds per-column
// operands: stage(gc, v) fills v[0 .. NV-1] for column gc < n (0 past n).
// smem: SMEM_BYTES of dynamic shared memory, cv at its end.
template <int NV, class Stage, class Epi>
__device__ __forceinline__ void sweep_tiles(const float* __restrict__ xt,
                                            const float* __restrict__ yt,
                                            int n, int d, int ld, int row0,
                                            int t0, int t1, float* smem,
                                            Stage&& stage, Epi&& epi) {
  static_assert(NV <= COL_VECTORS, "per-column operands fit their room");
  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
  float* cv = smem + STAGES * SLICE;
  const int nk = (d + BK - 1) / BK;
  const int steps = (t1 - t0) * nk;

  // cursor of the next slice to copy
  int ld_tile = t0, ld_k = 0;
  auto issue = [&](int j) {
    if (j < steps) {
      load_slice(xt, yt, n, d, ld, row0, ld_tile * BN, ld_k * BK,
                 smem + (j % STAGES) * SLICE);
      if (++ld_k == nk) {
        ld_k = 0;
        ++ld_tile;
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) issue(j);

  float acc[TM][TN];
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int c = 0; c < TN; ++c) acc[r][c] = 0.f;

  int tile = t0, k = 0;
  for (int it = 0; it < steps; ++it) {
    cp_async_wait<STAGES - 2>();
    // slice it has landed for every thread, and every thread is done with
    // the slot that the next copy overwrites (it - 1's)
    __syncthreads();
    issue(it + STAGES - 1);
    const bool last = k == nk - 1;
    const int col0 = tile * BN;
    float v[NV];
#pragma unroll
    for (int q = 0; q < NV; ++q) v[q] = 0.f;
    if (last && threadIdx.x < BN && col0 + threadIdx.x < n)
      stage(col0 + threadIdx.x, v);
    mul_slice(smem + (it % STAGES) * SLICE, tx, ty, acc);
    if (last) {
      // the previous tile's epilogue read cv before this step's barrier
      if (threadIdx.x < BN) {
#pragma unroll
        for (int q = 0; q < NV; ++q) cv[q * BN + threadIdx.x] = v[q];
      }
      __syncthreads();
      epi(acc, col0, static_cast<const float*>(cv));
#pragma unroll
      for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int c = 0; c < TN; ++c) acc[r][c] = 0.f;
      ++tile;
      k = 0;
    } else {
      ++k;
    }
  }
  cp_async_wait<0>();
}

}  // namespace rank
